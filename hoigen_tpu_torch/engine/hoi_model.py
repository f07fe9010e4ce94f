"""Full HOI model assembly (port of ``hoigen_tpu/engine/hoi_model.py``):
frozen DETR + frozen DINO + adapter-CLIP + UPT head, with the eval step and
the training step.

Parameters are one merged nested dict ``{"upt": ..., "detr": ...,
"dino": ...}`` whose trainable leaves require grad
(``engine/partition.py``; the JAX package splits them into two trees
instead), plus a dict of frozen buffers. The training step updates the
parameters in place. Entry points take ``device=None``, meaning CUDA, and
raise when no CUDA device is present; tests pass ``device="cpu"``.
"""
import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..models.clip.config import CLIPConfig, VIT_B16
from ..models.clip.model import init_clip_params
from ..models.detr.config import DETRConfig
from ..models.detr.model import detr_forward, init_detr_params, postprocess
from ..models.dino import dino_forward, init_dino_params
from ..labels.vcoco import detr_reserve_indices
from ..models.upt import UPTConfig, init_upt_params, language_aware_loss, \
    upt_forward
from ..ops.pixels import device_normalize, pad_mask_from_sizes
from ..ops.resize import batch_resize_normalize
from .partition import lr_group, mark_trainable, trainable_leaves


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
    seed gives the same weights on every device), moved to ``device``, the
    trainable leaves marked ``requires_grad``. Returns (params, buffers)."""
    dev = resolve_device(device)
    if clip_params is None:
        clip_params = init_clip_params(gen, cfg.clip)
    if detr_params is None:
        detr_params = init_detr_params(gen, cfg.detr)
    if dino_params is None and cfg.upt.use_dino:
        dino_params = init_dino_params(gen)
    upt_params, buffers = init_upt_params(gen, cfg.upt, caches, clip_params)
    params = {"upt": upt_params, "detr": detr_params, "dino": dino_params}
    return mark_trainable(to_device(params, dev)), to_device(buffers, dev)


@contextlib.contextmanager
def full_f32():
    """Float32 products in full f32 on the card while the block runs: TF32
    off for cuBLAS matmuls and for cuDNN convolutions (whose default is
    TF32, as the f32 DETR and DINO towers would otherwise run). The
    caller's settings are restored on the way out."""
    cudnn = torch.backends.cudnn
    saved = (torch.get_float32_matmul_precision(), cudnn.allow_tf32)
    torch.set_float32_matmul_precision("highest")
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        cudnn.allow_tf32 = saved[1]


def _as_tensor(x, device):
    return x.to(device) if isinstance(x, torch.Tensor) \
        else torch.as_tensor(np.asarray(x), device=device)


def _forward(params, buffers, batch, cfg: HOIModelConfig, training=False,
             generator=None):
    """The JAX package's ``_forward``: detections (eval) or (loss, aux)
    (training). DETR and DINO run under no grad. ``generator``: dropout in
    training (None runs none, as the JAX package's rng=None)."""
    dtype = getattr(torch, cfg.dtype)
    clip_cfg = cfg.clip
    if clip_cfg.fused_attention and not training:
        # the fused CLIP attention is for its backward (K4); at eval the
        # JAX package runs the plain math, and so does the port
        clip_cfg = dataclasses.replace(clip_cfg, fused_attention=False)
    if "image_mask" in batch:
        image_mask = batch["image_mask"]
    else:
        image_mask = pad_mask_from_sizes(batch["image_sizes"],
                                         batch["images"].shape[2],
                                         batch["images"].shape[3])
    images = device_normalize(batch["images"], dtype, pad_mask=image_mask)
    with torch.no_grad():
        detr_out = detr_forward(params["detr"], images, image_mask, cfg.detr)
    pred_logits = detr_out["pred_logits"].float()
    if pred_logits.shape[-1] == 92:
        # COCO-pretrained V-COCO detector: gather the 91-slot logits down
        # to 80 real classes (person first) and no-object before the softmax
        pred_logits = pred_logits[..., torch.as_tensor(
            detr_reserve_indices(), device=pred_logits.device)]
    # postprocess at the CLIP-stream frame, as the reference does
    post = postprocess(pred_logits, detr_out["pred_boxes"].float(),
                       batch["clip_sizes"])
    dino_apply = None
    if cfg.upt.use_dino and params["dino"] is not None:
        def dino_apply(im):
            with torch.no_grad():
                return dino_forward(params["dino"], im.to(dtype)).float()
    targets = gen_sample = None
    if training:
        targets = {"boxes_h": batch["boxes_h"], "boxes_o": batch["boxes_o"],
                   "labels": batch["labels"], "valid": batch["gt_valid"]}
        if cfg.upt.generate_feature and "gen_hum" in batch:
            gen_sample = {"hum": batch["gen_hum"], "obj": batch["gen_obj"],
                          "uni": batch["gen_uni"],
                          "obj_cls": batch["gen_obj_cls"],
                          "verb_multihot": batch["gen_verb_multihot"]}
    if "images_clip" in batch:
        images_clip = device_normalize(batch["images_clip"], torch.float32)
    else:
        # the 224 stream derived from the shipped DETR stream, with PIL's
        # uint8 rounding
        images_clip = batch_resize_normalize(
            batch["images"], batch["image_sizes"].float(),
            cfg.upt.clip_resolution)
    return upt_forward(params["upt"], buffers, post, images_clip,
                       batch["clip_sizes"], clip_cfg, cfg.upt,
                       dino_apply=dino_apply, targets=targets,
                       training=training, generator=generator,
                       gen_sample=gen_sample)


class GroupedAdamW:
    """AdamW in two learning-rate groups, each clipped to its own global
    norm, with the learning rate cut by 10 from update ``lr_drop_step`` on:
    ``optax.multi_transform`` of ``chain(clip_by_global_norm(max_norm),
    adamw(piecewise_constant_schedule(lr, {lr_drop_step: 0.1}),
    weight_decay))`` per group, as the JAX package builds it.

    As optax: the clip scales a group by max_norm / norm only where its
    norm is not below max_norm (``torch.nn.utils.clip_grad_norm_`` would
    add 1e-6 to the norm and scale always); every leaf of a group is
    updated and decayed, a leaf that got no gradient as if its gradient
    were zero. The Adam update itself is ``torch.optim.AdamW``'s, the same
    formula as optax's (b1 0.9, b2 0.999, eps 1e-8) with another rounding
    order."""

    def __init__(self, named_params, lr_vit=1e-3, lr_head=1e-3,
                 weight_decay=1e-4, lr_drop_step: Optional[int] = None,
                 max_norm=0.1):
        groups = {"vit": [], "head": []}
        for path, t in named_params:
            groups[lr_group(path)].append(t)
        self.base_lr = {"vit": lr_vit, "head": lr_head}
        self.lr_drop_step = lr_drop_step
        self.max_norm = max_norm
        self.count = 0
        self.opt = torch.optim.AdamW(
            [{"params": ts, "lr": self.base_lr[name], "name": name}
             for name, ts in groups.items() if ts],
            betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)

    def _lr(self, name):
        drop = self.lr_drop_step is not None and self.count >= \
            self.lr_drop_step
        return self.base_lr[name] * (0.1 if drop else 1.0)

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=False)

    @torch.no_grad()
    def step(self):
        for group in self.opt.param_groups:
            for t in group["params"]:
                if t.grad is None:
                    t.grad = torch.zeros_like(t)
            grads = [t.grad for t in group["params"]]
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            # no host synchronisation: the scale stays on the device
            torch._foreach_mul_(grads, torch.where(
                norm < self.max_norm, 1.0, self.max_norm / norm))
            group["lr"] = self._lr(group["name"])
        self.opt.step()
        self.count += 1

    def state_dict(self):
        return {"adamw": self.opt.state_dict(), "count": self.count}

    def load_state_dict(self, state):
        self.opt.load_state_dict(state["adamw"])
        self.count = int(state["count"])


def make_optimizer(lr_vit=1e-3, lr_head=1e-3, weight_decay=1e-4,
                   lr_drop_step: Optional[int] = None, max_norm=0.1):
    """-> make(params) -> a :class:`GroupedAdamW` over the trainable leaves
    of ``params`` (AdamW with two LR groups, StepLR x0.1 at lr_drop_step,
    gradient clip 0.1 per group)."""
    def make(params):
        return GroupedAdamW(trainable_leaves(params), lr_vit, lr_head,
                            weight_decay, lr_drop_step, max_norm)
    return make


def train_loss(params, buffers, batch, cfg: HOIModelConfig, generator=None):
    """The training objective: the focal-loss sum over the positive count
    (global sums of the batch), plus the language-aware term when
    ``cfg.upt.LA``. -> (loss, aux). The batch's tensors must be on the
    parameters' device."""
    _, aux = _forward(params, buffers, batch, cfg, training=True,
                      generator=generator)
    total = aux["loss_sum"] / torch.clamp(aux["n_p"], min=1.0)
    if cfg.upt.LA:
        total = total + language_aware_loss(
            params["upt"], buffers["origin_text_embeddings"],
            cfg.upt.LA_weight)
    return total, aux


def make_train_step(cfg: HOIModelConfig, optimizer, device=None):
    """-> step(params, buffers, batch, generator=None) -> metrics {"loss",
    "n_p"} (device tensors: reading them waits for the card). One
    optimizer step of ``optimizer`` (from :func:`make_optimizer`) on the
    parameters, in place."""
    dev = resolve_device(device)

    def step(params, buffers, batch, generator=None):
        batch = {k: _as_tensor(v, dev) for k, v in batch.items()}
        with full_f32():
            optimizer.zero_grad()
            loss, aux = train_loss(params, buffers, batch, cfg, generator)
            loss.backward()
            optimizer.step()
        return {"loss": loss.detach(), "n_p": aux["n_p"].detach()}

    return step


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
        with full_f32():
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
