"""Crop extraction, the crop-classification dataset and the feature
producers of the generator pipeline (port of ``hoigen_tpu/data/crops.py``).

  * crop extraction (pre_images/crop_images.py:83-263): IoU >= 0.5 dedup of
    the GT boxes, human/object/union crops saved per class, from the
    instances json;
  * the generator's crop-classification dataset and split jsons
    (datasets/hoi_dataset.py, datasets/utils.py:283-374);
  * the producers of the pair-embedding pickle
    (union_embeddings_cachemodel_crop_padding_zeros_vitb16.p, with the
    reference artifact's 'huamn_features' key spelling) and of the
    per-class GT feature pickles (new_gt_features/*.pickle).

Crops are square-padded with zeros and CLIP-normalised (OpenAI CLIP
statistics). The host functions are the JAX package's numpy and PIL code
in the same order, so that they give the same crops, splits and draws;
:func:`make_device_crop_encoder` crops, resizes, normalises and encodes on
the device, a chunk of boxes at a time.
"""
import json
import os
import pickle
from typing import Callable, List, Optional, Sequence

import numpy as np

CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


def dedup_boxes(boxes: np.ndarray, iou_threshold: float = 0.5) -> List[int]:
    """Greedy in-order dedup (crop_images.py filter_and_remove): keep a box
    unless it overlaps an already-kept one above the threshold."""
    from ..eval.association import box_iou
    keep: List[int] = []
    for i in range(len(boxes)):
        if all(box_iou(boxes[i:i + 1], boxes[k:k + 1])[0, 0] <= iou_threshold
               for k in keep):
            keep.append(i)
    return keep


def expand2square(img, fill=(0, 0, 0)):
    """Pad to square (utils_tip_cache_and_union_finetune.py:203-214)."""
    from PIL import Image
    w, h = img.size
    if w == h:
        return img
    side = max(w, h)
    out = Image.new(img.mode, (side, side), fill)
    out.paste(img, ((side - w) // 2 if h > w else 0,
                    (side - h) // 2 if w > h else 0))
    return out


def clip_preprocess_crop(img, resolution: int = 224) -> np.ndarray:
    """Square-pad-zeros + bicubic resize + CLIP normalise -> (3, r, r)."""
    from PIL import Image
    img = expand2square(img).resize((resolution, resolution), Image.BICUBIC)
    arr = np.asarray(img, np.float32) / 255.0
    return ((arr - CLIP_MEAN) / CLIP_STD).transpose(2, 0, 1)


def extract_crops(dataset, out_dir: str, category: str,
                  iou_threshold: float = 0.5,
                  limit: Optional[int] = None) -> List[dict]:
    """category in {'hoi', 'human', 'object'}. Saves class-foldered JPEGs
    under out_dir/<category>/<class_id>/ and returns the item list
    [{impath, label}] for split-json building."""
    os.makedirs(out_dir, exist_ok=True)
    items = []
    n = len(dataset) if limit is None else min(limit, len(dataset))
    for i in range(n):
        tgt = dataset.target(i)
        image = dataset.load_image(i)
        name = os.path.splitext(dataset.filename(i))[0]
        bh, bo = tgt["boxes_h"], tgt["boxes_o"]
        if len(bh) == 0:
            continue
        if category == "hoi":
            boxes = np.stack([np.minimum(bh[:, :2], bo[:, :2]),
                              np.maximum(bh[:, 2:], bo[:, 2:])], 1)
            boxes = boxes.reshape(-1, 4)
            labels = tgt.get("hoi", tgt.get("actions"))
        elif category == "human":
            boxes, labels = bh, tgt.get("object", tgt.get("objects"))
        else:
            boxes, labels = bo, tgt.get("object", tgt.get("objects"))
        keep = dedup_boxes(boxes, iou_threshold)
        for j in keep:
            cls = int(labels[j])
            cls_dir = os.path.join(out_dir, category, str(cls))
            os.makedirs(cls_dir, exist_ok=True)
            crop = image.crop(tuple(boxes[j]))
            if crop.size[0] < 1 or crop.size[1] < 1:
                continue
            path = os.path.join(cls_dir, f"{name}_{j}.jpg")
            crop.save(path)
            items.append({"impath": path, "label": cls})
    return items


def build_split_json(items: Sequence[dict], out_path: str,
                     excluded_classes: Sequence[int] = (),
                     test_ratio: float = 0.0, seed: int = 0):
    """Train/test split json (pre_images/split_gen_dataset.py:9-73), with
    zero-shot class exclusion applied to the train split."""
    rng = np.random.default_rng(seed)
    excluded = set(excluded_classes)
    kept = [it for it in items if it["label"] not in excluded]
    order = rng.permutation(len(kept))
    n_test = int(len(kept) * test_ratio)
    split = {"train": [kept[i] for i in order[n_test:]],
             "test": [kept[i] for i in order[:n_test]]}
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(split, f)
    return split


class CropDataset:
    """Crop-classification dataset over a split json
    (datasets/hoi_dataset.py:13-51 + DatasetWrapper). Its numpy generator
    makes the same draws in the same order as the JAX package's."""

    def __init__(self, split_json: str, partition: str = "train",
                 resolution: int = 224, training: bool = True, seed: int = 0):
        with open(split_json) as f:
            self.items = json.load(f)[partition]
        self.resolution = resolution
        self.training = training
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        from PIL import Image
        it = self.items[i]
        img = Image.open(it["impath"]).convert("RGB")
        r = self.resolution
        if not self.training:
            return clip_preprocess_crop(img, r), it["label"]
        # RandomResizedCrop(224) equivalent (datasets/utils.py:292-299)
        w, h = img.size
        for _ in range(10):
            area = w * h * self.rng.uniform(0.08, 1.0)
            ar = np.exp(self.rng.uniform(np.log(3 / 4), np.log(4 / 3)))
            cw, ch = int(round(np.sqrt(area * ar))), \
                int(round(np.sqrt(area / ar)))
            if cw <= w and ch <= h:
                x = int(self.rng.integers(0, w - cw + 1))
                y = int(self.rng.integers(0, h - ch + 1))
                img = img.crop((x, y, x + cw, y + ch))
                break
        img = img.resize((r, r), Image.BICUBIC)
        arr = np.asarray(img, np.float32) / 255.0
        arr = (arr - CLIP_MEAN) / CLIP_STD
        return arr.transpose(2, 0, 1), it["label"]

    def batches(self, batch_size: int, shuffle: bool = True):
        """Full batches only: a last partial batch is dropped."""
        order = self.rng.permutation(len(self)) if shuffle \
            else np.arange(len(self))
        for lo in range(0, len(order) - batch_size + 1, batch_size):
            idx = order[lo:lo + batch_size]
            imgs, labels = zip(*(self[int(i)] for i in idx))
            yield np.stack(imgs), np.asarray(labels, np.int32)


def make_device_crop_encoder(clip_params, clip_cfg, resolution: int = 224,
                             chunk: int = 32):
    """Crop + resize + normalise + CLIP encode on the device of
    ``clip_params``.

    The image goes to the device once, as uint8-valued floats; every
    human/object/union crop is cut by the PIL-parity bicubic weights
    (``ops/resize.py::crop_resize_square_pil_u8``: square zero padding,
    per-pass uint8 rounding), ``chunk`` boxes in one batched product, and
    encoded by CLIP in full f32 under no grad, without crop pixels on the
    host. The JAX package pads the image to a /128 bucket only to limit its
    recompiles; the port does not (the padding changes no value).

    Returns ``encode(image_hw3_u8, boxes_xyxy) -> (N, embed) float32``
    numpy. Boxes are rounded as PIL's crop rounds them (np.rint);
    degenerate boxes (< 1 px after rounding) take the whole image, as the
    host producer does. A last chunk is filled with whole-image boxes, so
    that every encode runs at batch ``chunk``.
    """
    import torch

    from ..engine.hoi_model import full_f32
    from ..models.clip.model import encode_image
    from ..ops.resize import crop_resize_square_pil_u8

    dev = clip_params["logit_scale"].device
    mean = torch.as_tensor(CLIP_MEAN, device=dev).reshape(1, 3, 1, 1)
    std = torch.as_tensor(CLIP_STD, device=dev).reshape(1, 3, 1, 1)

    def encode(image: np.ndarray, boxes: np.ndarray) -> np.ndarray:
        h, w = image.shape[:2]
        boxes = np.rint(np.asarray(boxes, np.float64)).astype(np.float32)
        deg = (boxes[:, 2] - boxes[:, 0] < 1) | \
            (boxes[:, 3] - boxes[:, 1] < 1)
        boxes[deg] = (0.0, 0.0, float(w), float(h))
        if not len(boxes):
            return np.zeros((0, clip_cfg.embed_dim), np.float32)
        img = torch.as_tensor(np.ascontiguousarray(
            np.asarray(image).transpose(2, 0, 1))).to(dev).float()
        out = []
        with torch.no_grad(), full_f32():
            for lo in range(0, len(boxes), chunk):
                blk = boxes[lo:lo + chunk]
                n = len(blk)
                if n < chunk:
                    blk = np.concatenate(
                        [blk, np.tile(np.asarray([[0.0, 0.0, w, h]],
                                                 np.float32),
                                      (chunk - n, 1))])
                crops = crop_resize_square_pil_u8(img, blk, resolution)
                crops = (crops / 255.0 - mean) / std
                out.append(encode_image(clip_params, crops, clip_cfg)[0][:n])
        return torch.cat(out).cpu().numpy()

    return encode


def produce_pair_embeddings(dataset, clip_apply: Callable, out_path: str,
                            batch_size: int = 64,
                            limit: Optional[int] = None,
                            resolution: int = 224,
                            crop_encoder: Optional[Callable] = None):
    """Producer for the pair-embedding pickle the reference only ships
    pre-computed: per image filename, the CLIP features of every GT
    human/object/union crop plus boxes and class ids (keys as consumed by
    load_cache_model, upt...py:635-688, incl. the 'huamn_features' typo).

    clip_apply: (N, 3, r, r) float32 -> (N, 512) CLIP global features.
    crop_encoder: optional device path (:func:`make_device_crop_encoder`)
    -- (image_hw3, boxes (N, 4)) -> (N, embed); when given, crop pixels are
    never made on the host and ``clip_apply`` is unused.
    """
    annotation = {}
    pending, meta = [], []

    def flush():
        if not pending:
            return
        feats = np.asarray(clip_apply(np.stack(pending)))
        for (fname, kind, idx), f in zip(meta, feats):
            annotation[fname][kind][idx] = f
        pending.clear()
        meta.clear()

    n = len(dataset) if limit is None else min(limit, len(dataset))
    for i in range(n):
        tgt = dataset.target(i)
        bh, bo = tgt["boxes_h"], tgt["boxes_o"]
        if len(bh) == 0:
            continue
        fname = dataset.filename(i)
        image = dataset.load_image(i)
        union = np.concatenate([np.minimum(bh[:, :2], bo[:, :2]),
                                np.maximum(bh[:, 2:], bo[:, 2:])], 1)
        verbs = tgt.get("verb", tgt.get("actions"))
        objects = tgt.get("object", tgt.get("objects"))
        annotation[fname] = {
            "boxes_h": bh, "boxes_o": bo,
            "verbs": np.asarray(verbs), "objects": np.asarray(objects),
            "union_boxes": union,
            "huamn_features": [None] * len(bh),
            "object_features": [None] * len(bh),
            "union_features": [None] * len(bh),
        }
        if crop_encoder is not None:
            n_pairs = len(bh)
            feats = crop_encoder(np.asarray(image),
                                 np.concatenate([bh, bo, union]))
            anno = annotation[fname]
            anno["huamn_features"] = list(feats[:n_pairs])
            anno["object_features"] = list(feats[n_pairs:2 * n_pairs])
            anno["union_features"] = list(feats[2 * n_pairs:])
            continue
        for j in range(len(bh)):
            for kind, box in (("huamn_features", bh[j]),
                              ("object_features", bo[j]),
                              ("union_features", union[j])):
                crop = image.crop(tuple(box))
                if crop.size[0] < 1 or crop.size[1] < 1:
                    crop = image
                pending.append(clip_preprocess_crop(crop, resolution))
                meta.append((fname, kind, j))
                if len(pending) >= batch_size:
                    flush()
    flush()
    for fname, anno in annotation.items():
        for kind in ("huamn_features", "object_features", "union_features"):
            anno[kind] = np.stack(anno[kind])
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "wb") as f:
        pickle.dump(annotation, f)
    return annotation


def produce_gt_features(crop_dataset: CropDataset, clip_apply: Callable,
                        num_classes: int, out_path: str,
                        batch_size: int = 64):
    """Producer for new_gt_features/*.pickle (finetune_ship.py:454-467):
    {class_id: [features (N_c, 512)]} of GT crop CLIP features."""
    feats = {c: [] for c in range(num_classes)}
    batch_imgs, batch_labels = [], []

    def flush():
        if not batch_imgs:
            return
        out = np.asarray(clip_apply(np.stack(batch_imgs)))
        for lbl, f in zip(batch_labels, out):
            feats[int(lbl)].append(f)
        batch_imgs.clear()
        batch_labels.clear()

    for i in range(len(crop_dataset)):
        img, label = crop_dataset[i]
        batch_imgs.append(img)
        batch_labels.append(label)
        if len(batch_imgs) >= batch_size:
            flush()
    flush()
    out = {c: [np.stack(v)] if v else [] for c, v in feats.items()}
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    return out
