"""Full HOI model assembly, eval side (port of
``hoigen_tpu/engine/hoi_model.py``): frozen DETR + frozen DINO +
adapter-CLIP + UPT head.

Parameters are one merged nested dict ``{"upt": ..., "detr": ...,
"dino": ...}`` (the JAX package splits trainable from frozen for its
optimizer, which eval does not need) plus a dict of frozen buffers. Entry
points take ``device=None``, meaning CUDA, and raise when no CUDA device is
present; tests pass ``device="cpu"``.
"""
import dataclasses

import numpy as np
import torch

from ..models.clip.config import CLIPConfig, VIT_B16
from ..models.clip.model import init_clip_params
from ..models.detr.config import DETRConfig
from ..models.detr.model import detr_forward, init_detr_params, postprocess
from ..models.dino import dino_forward, init_dino_params
from ..models.upt import UPTConfig, init_upt_params, upt_forward
from ..ops.pixels import device_normalize, pad_mask_from_sizes
from ..ops.resize import batch_resize_normalize


@dataclasses.dataclass(frozen=True)
class HOIModelConfig:
    clip: CLIPConfig = VIT_B16
    detr: DETRConfig = DETRConfig()
    upt: UPTConfig = UPTConfig()
    dtype: str = "float32"       # activation dtype of the DETR/DINO towers


def resolve_device(device=None) -> torch.device:
    """None -> CUDA. Raises if a CUDA device is asked for and none exists:
    the port never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path on the CPU")
    return dev


def to_device(tree, device):
    """Move every tensor of a nested dict/list to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def init_hoi_model(gen, cfg: HOIModelConfig, caches, clip_params=None,
                   detr_params=None, dino_params=None, device=None):
    """Random init from the torch.Generator ``gen`` (drawn on the CPU, so a
    seed gives the same weights on every device), moved to ``device``.
    Returns (params, buffers)."""
    dev = resolve_device(device)
    if clip_params is None:
        clip_params = init_clip_params(gen, cfg.clip)
    if detr_params is None:
        detr_params = init_detr_params(gen, cfg.detr)
    if dino_params is None and cfg.upt.use_dino:
        dino_params = init_dino_params(gen)
    upt_params, buffers = init_upt_params(gen, cfg.upt, caches, clip_params)
    params = {"upt": upt_params, "detr": detr_params, "dino": dino_params}
    return to_device(params, dev), to_device(buffers, dev)


def _as_tensor(x, device):
    return x.to(device) if isinstance(x, torch.Tensor) \
        else torch.as_tensor(np.asarray(x), device=device)


def _forward(params, buffers, batch, cfg: HOIModelConfig):
    """The eval branch of the JAX package's ``_forward``."""
    dtype = getattr(torch, cfg.dtype)
    if "image_mask" in batch:
        image_mask = batch["image_mask"]
    else:
        image_mask = pad_mask_from_sizes(batch["image_sizes"],
                                         batch["images"].shape[2],
                                         batch["images"].shape[3])
    images = device_normalize(batch["images"], dtype, pad_mask=image_mask)
    detr_out = detr_forward(params["detr"], images, image_mask, cfg.detr)
    pred_logits = detr_out["pred_logits"].float()
    if pred_logits.shape[-1] == 92:
        raise NotImplementedError(
            "92-logit (COCO-pretrained V-COCO) detectors need the 92->81 "
            "logit gather, which is not ported yet")
    # postprocess at the CLIP-stream frame, as the reference does
    post = postprocess(pred_logits, detr_out["pred_boxes"].float(),
                       batch["clip_sizes"])
    dino_apply = None
    if cfg.upt.use_dino and params["dino"] is not None:
        def dino_apply(im):
            return dino_forward(params["dino"], im.to(dtype)).float()
    if "images_clip" in batch:
        images_clip = device_normalize(batch["images_clip"], torch.float32)
    else:
        # the 224 stream derived from the shipped DETR stream, with PIL's
        # uint8 rounding
        images_clip = batch_resize_normalize(
            batch["images"], batch["image_sizes"].float(),
            cfg.upt.clip_resolution)
    return upt_forward(params["upt"], buffers, post, images_clip,
                       batch["clip_sizes"], cfg.clip, cfg.upt,
                       dino_apply=dino_apply)


def make_eval_step(cfg: HOIModelConfig, device=None):
    """-> step(params, buffers, batch) -> detections dict, on ``device``.

    The batch may hold numpy arrays or tensors; they are moved to the
    device. Returns the compact form: detection_scores (B, P, Vmax)
    gathered through the per-object verb LUT, detection_verbs (B, P, Vmax)
    ids, boxes (B, S, 4), objects (B, P) and pair_valid (B, P)."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def step(params, buffers, batch):
        batch = {k: _as_tensor(v, dev) for k, v in batch.items()}
        out = _forward(params, buffers, batch, cfg)
        return {"detection_scores": out["detection_scores_cmp"],
                "detection_verbs": out["detection_verbs"],
                "boxes": out["boxes"], "objects": out["objects"],
                "pair_valid": out["pair_valid"]}

    return step


def make_example_batch(cfg: HOIModelConfig, batch_size=2, detr_hw=(256, 256),
                       seed=0, max_gt=8, device_clip_stream=False,
                       object_class_multihot=None):
    """Synthetic numpy batch with the right static shapes: the same arrays
    as the JAX package's ``make_example_batch`` for the same arguments.

    ``device_clip_stream``: the production feed, uint8 DETR pixels plus
    (h, w) sizes, with the 224 stream derived on the device."""
    rng = np.random.default_rng(seed)
    h, w = detr_hw
    r = cfg.upt.clip_resolution
    mask = np.zeros((batch_size, h, w), bool)
    mask[:, :, w - w // 8:] = True
    if device_clip_stream:
        pixels = {
            "images": rng.integers(0, 256, (batch_size, 3, h, w))
            .astype(np.uint8),
            "image_sizes": np.tile(np.asarray([h, w - w // 8], np.float32),
                                   (batch_size, 1)),
        }
    else:
        pixels = {
            "images": rng.normal(size=(batch_size, 3, h, w))
            .astype(np.float32),
            "image_mask": mask,
            "images_clip": rng.normal(size=(batch_size, 3, r, r))
            .astype(np.float32),
        }
    return pixels | {
        "clip_sizes": np.full((batch_size, 2), float(r), np.float32),
        "boxes_h": (rng.random((batch_size, max_gt, 4)) * 0.4 + 0.2)
        .astype(np.float32),
        "boxes_o": (rng.random((batch_size, max_gt, 4)) * 0.4 + 0.2)
        .astype(np.float32),
        "labels": rng.integers(0, cfg.upt.num_classes,
                               (batch_size, max_gt)).astype(np.int32),
        "gt_valid": np.tile(np.arange(max_gt) < 3, (batch_size, 1)),
    } | ({} if not cfg.upt.generate_feature else _example_gen_sample(
        rng, batch_size, cfg.upt, object_class_multihot))


def _example_gen_sample(rng, batch_size, upt_cfg, object_class_multihot=None):
    d = upt_cfg.visual_output_dim
    if object_class_multihot is not None:
        table = np.asarray(object_class_multihot) > 0
        objs = rng.integers(0, table.shape[0], batch_size)
        verbs = np.asarray([rng.choice(np.flatnonzero(table[o]))
                            for o in objs], np.int64)
    else:
        objs = rng.integers(0, 2, batch_size)
        verbs = rng.integers(0, upt_cfg.num_classes, batch_size)
    mh = np.zeros((batch_size, upt_cfg.num_classes), np.float32)
    mh[np.arange(batch_size), verbs] = 1.0
    return {
        "gen_hum": rng.normal(size=(batch_size, d)).astype(np.float32),
        "gen_obj": rng.normal(size=(batch_size, d)).astype(np.float32),
        "gen_uni": rng.normal(size=(batch_size, d)).astype(np.float32),
        "gen_obj_cls": objs.astype(np.int32),
        "gen_verb_multihot": mh,
    }
