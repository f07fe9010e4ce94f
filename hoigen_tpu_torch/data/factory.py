"""DataFactory: dataset + dual-stream transforms + zero-shot filtering +
static-shape batch collation.

Mirrors reference/utils_tip_cache_and_union_finetune.py:52-310
(DataFactory/custom_collate) with the change that batches are
padded to fixed shapes: the DETR stream pads into aspect buckets with a
pixel mask, targets pad to ``max_gt_pairs`` with a validity mask.

Port of ``hoigen_tpu/data/factory.py``, the same algorithm in the same order
(the tests hold the two packages equal).
"""
import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from .hicodet import HICODetDataset
from .vcoco import VCOCODataset
from .transforms import DualStreamTransform

# (h, w) buckets for the ≤1333 DETR stream (min side 800 after eval resize)
DEFAULT_BUCKETS = ((800, 1344), (1344, 800), (1088, 1088), (1344, 1344))


@dataclasses.dataclass
class Batch:
    images: np.ndarray        # (B, 3, Hb, Wb) padded DETR stream, uint8
    image_mask: np.ndarray    # (B, Hb, Wb) True where padded
    image_sizes: np.ndarray   # (B, 2) unpadded (h, w) — compact mask form
    images_clip: Optional[np.ndarray]  # (B, 3, r, r) uint8; None when the
    #                           224 stream is derived on-device (ops/resize)
    clip_sizes: np.ndarray    # (B, 2) = (r, r)
    boxes_h: np.ndarray       # (B, G, 4) normalized cxcywh (CLIP frame)
    boxes_o: np.ndarray
    labels: np.ndarray        # (B, G) verb/hoi ids
    objects: np.ndarray       # (B, G)
    gt_valid: np.ndarray      # (B, G)
    hoi: np.ndarray           # (B, G) interaction ids (hicodet)
    indices: np.ndarray       # (B,) dataset indices
    n_real: int = -1          # non-padded rows when the tail is padded


def slice_batch(batch: "Batch", n: int) -> "Batch":
    """First ``n`` rows of every per-sample array (drop tail padding)."""
    sliced = {f.name: (getattr(batch, f.name)[:n]
                       if isinstance(getattr(batch, f.name), np.ndarray)
                       else getattr(batch, f.name))
              for f in dataclasses.fields(batch)}
    sliced["n_real"] = n
    return Batch(**sliced)


class DataFactory:
    def __init__(self, name: str, partition: str, data_root: str,
                 training: bool, zero_shot: bool = False,
                 zs_type: str = "rare_first", num_classes: int = 117,
                 clip_resolution: int = 224, max_gt_pairs: int = 32,
                 seed: int = 0, transform_kwargs: Optional[dict] = None,
                 host_clip_stream: bool = True):
        if name == "hicodet":
            anno = f"{data_root}/instances_{partition}.json"
            root = f"{data_root}/hico_20160224_det/images/{partition}"
            self.dataset = HICODetDataset(anno, root)
        elif name == "vcoco":
            anno = f"{data_root}/instances_vcoco_{partition}.json"
            image_dir = {"train": "images/train2014",
                         "val": "images/train2014",
                         "trainval": "images/train2014",
                         "test": "images/val2014"}[partition]
            self.dataset = VCOCODataset(anno, f"{data_root}/{image_dir}")
        else:
            raise ValueError(name)
        self.name = name
        self.training = training
        self.num_classes = num_classes
        self.max_gt_pairs = max_gt_pairs
        self.transform = DualStreamTransform(
            training, clip_resolution, seed,
            **{"host_clip_stream": host_clip_stream,
               **(transform_kwargs or {})})
        self.zero_shot = zero_shot and name == "hicodet" and training
        self.filtered_hoi_idx: List[int] = []
        if self.zero_shot:
            from ..labels import HICO
            self.filtered_hoi_idx = HICO.unseen_index[zs_type]
            remain = set(range(600)) - set(self.filtered_hoi_idx)
            self.keep = [i for i in range(len(self.dataset))
                         if remain & set(self.dataset.target(i)["hoi"]
                                         .tolist())]
        else:
            self.keep = list(range(len(self.dataset)))
        self.epoch = 0

    def set_epoch(self, epoch: int):
        """Vary the stateless per-sample augmentation across epochs
        (DistributedSampler.set_epoch analog)."""
        self.epoch = epoch

    def padded_hw(self, indices, buckets: Optional[Sequence] = None):
        """Padded (Hb, Wb) for a batch of dataset rows, from size metadata
        alone: replays each sample's stateless transform plan (same
        (seed, epoch, index) rng as __getitem__) over the original sizes.
        Every process computes the identical shape for a GLOBAL batch even
        for rows it never loads (one global shape on every rank)."""
        if buckets is None:
            buckets = DEFAULT_BUCKETS   # module attribute: overridable
        hb, wb = 0, 0
        for i in indices:
            idx = self.keep[int(i)]
            w0, h0 = self.dataset.image_size(idx)
            rng = np.random.default_rng(
                (self.transform.seed, self.epoch, idx)) \
                if self.training else None
            oh, ow = self.transform.plan(int(w0), int(h0), rng=rng)["out_hw"]
            bt = pick_bucket(oh, ow, buckets)
            hb, wb = max(hb, bt[0]), max(wb, bt[1])
        return hb, wb

    def __len__(self):
        return len(self.keep)

    def __getitem__(self, i: int):
        idx = self.keep[i]
        image = self.dataset.load_image(idx)
        target = self.dataset.target(idx)
        if self.name == "vcoco":
            target["labels"] = target["actions"]
            target["object"] = target.pop("objects")
        else:
            target["labels"] = target["verb"]
        if self.zero_shot:
            m = ~np.isin(target["hoi"], self.filtered_hoi_idx)
            for k in ("boxes_h", "boxes_o", "hoi", "verb", "object",
                      "labels"):
                if k in target:
                    target[k] = target[k][m]
        rng = np.random.default_rng(
            (self.transform.seed, self.epoch, idx)) if self.training else None
        detr_img, clip_img, target = self.transform(image, target, rng=rng)
        return detr_img, clip_img, target, idx


def pick_bucket(h, w, buckets: Sequence = DEFAULT_BUCKETS):
    fitting = [b for b in buckets if b[0] >= h and b[1] >= w]
    if not fitting:
        return max(buckets, key=lambda b: b[0] * b[1])
    return min(fitting, key=lambda b: b[0] * b[1])


def collate_batch(samples, max_gt_pairs: int = 32,
                  buckets: Optional[Sequence] = None,
                  label_key: str = "labels",
                  pad_hw: Optional[Sequence] = None) -> Batch:
    """Pad a list of (detr_img, clip_img, target, idx) to fixed shapes.

    ``pad_hw`` forces the padded (Hb, Wb) — multi-process runs pass the
    GLOBAL batch's shape (DataFactory.padded_hw) because each process
    collates only its local rows and a locally-chosen bucket would diverge
    across ranks."""
    b = len(samples)
    if pad_hw is not None:
        hb, wb = pad_hw
    else:
        if buckets is None:
            buckets = DEFAULT_BUCKETS   # module attribute: overridable
        hb, wb = (0, 0)
        for img, _, _, _ in samples:
            bt = pick_bucket(img.shape[1], img.shape[2], buckets)
            hb, wb = max(hb, bt[0]), max(wb, bt[1])
    img_dtype = samples[0][0].dtype
    images = np.zeros((b, 3, hb, wb), img_dtype)
    mask = np.ones((b, hb, wb), bool)
    sizes = np.zeros((b, 2), np.int32)
    host_clip = samples[0][1] is not None
    r = samples[0][1].shape[-1] if host_clip \
        else int(samples[0][2]["size"][0])
    images_clip = np.zeros((b, 3, r, r), img_dtype) if host_clip else None
    g = max_gt_pairs
    bh = np.zeros((b, g, 4), np.float32)
    bo = np.zeros((b, g, 4), np.float32)
    labels = np.zeros((b, g), np.int32)
    objects = np.zeros((b, g), np.int32)
    hoi = np.zeros((b, g), np.int32)
    valid = np.zeros((b, g), bool)
    indices = np.zeros(b, np.int64)
    for i, (img, cimg, tgt, idx) in enumerate(samples):
        _, h, w = img.shape
        images[i, :, :h, :w] = img
        mask[i, :h, :w] = False
        sizes[i] = (h, w)
        if host_clip:
            images_clip[i] = cimg
        n = min(len(tgt["boxes_h"]), g)
        if n:
            bh[i, :n] = tgt["boxes_h"][:n]
            bo[i, :n] = tgt["boxes_o"][:n]
            labels[i, :n] = tgt[label_key][:n]
            key = "object" if "object" in tgt else "objects"
            objects[i, :n] = tgt[key][:n]
            if "hoi" in tgt:
                hoi[i, :n] = tgt["hoi"][:n]
            valid[i, :n] = True
        indices[i] = idx
    return Batch(images, mask, sizes, images_clip,
                 np.full((b, 2), float(r), np.float32),
                 bh, bo, labels, objects, valid, hoi, indices, n_real=b)
