"""Full HOI model assembly in plain PyTorch, the benchmark's reference:
frozen DETR + frozen DINO + adapter-CLIP + UPT head, with the eval step and
the training step. A frozen copy of the port's plain math (its modules
under ``hoibench/reference/``, the kernels replaced by their plain
versions with the same rounding points), with two additions for the
benchmark: :data:`F32_PRECISION` (the products of the f32 parts; the
lower-precision control sets TF32) and ``detr_out`` in :func:`_forward`
(the comparison hands over the detector outputs it follows).

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
from ..ops._weights import constant
from ..ops.pixels import device_normalize, pad_mask_from_sizes
from ..ops.resize import batch_resize_normalize
from ..parallel.distributed import all_reduce
from ..parallel.mesh import is_cache_row_leaf
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


# float32 products inside full_f32: "highest" (TF32 off), or "high" (TF32
# on, cuDNN too) for the lower-precision control
F32_PRECISION = "highest"


@contextlib.contextmanager
def full_f32():
    """Float32 products in full f32 on the card while the block runs: TF32
    off for cuBLAS matmuls and for cuDNN convolutions (whose default is
    TF32, as the f32 DETR and DINO towers would otherwise run). The
    caller's settings are restored on the way out."""
    cudnn = torch.backends.cudnn
    saved = (torch.get_float32_matmul_precision(), cudnn.allow_tf32)
    torch.set_float32_matmul_precision(F32_PRECISION)
    cudnn.allow_tf32 = F32_PRECISION != "highest"
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        cudnn.allow_tf32 = saved[1]


def _as_tensor(x, device):
    return x.to(device) if isinstance(x, torch.Tensor) \
        else torch.as_tensor(np.asarray(x), device=device)


def _forward(params, buffers, batch, cfg: HOIModelConfig, training=False,
             generator=None, mesh=None, detr_out=None):
    """The JAX package's ``_forward``: detections (eval) or (loss, aux)
    (training). DETR and DINO run under no grad. ``generator``: dropout in
    training (None runs none, as the JAX package's rng=None).
    ``mesh``: where the cache rows are sharded, or None."""
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
    if detr_out is None:
        with torch.no_grad():
            detr_out = detr_forward(params["detr"], images, image_mask,
                                    cfg.detr)
    pred_logits = detr_out["pred_logits"].float()
    if pred_logits.shape[-1] == 92:
        # COCO-pretrained V-COCO detector: gather the 91-slot logits down
        # to 80 real classes (person first) and no-object before the softmax
        pred_logits = pred_logits[..., constant(
            tuple(detr_reserve_indices()), pred_logits.device, torch.long)]
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
                       gen_sample=gen_sample, mesh=mesh)


class GroupedAdamW:
    """AdamW in learning-rate groups, each clipped to its own global norm,
    with the learning rate cut by 10 from update ``lr_drop_step`` on:
    ``optax.multi_transform`` of ``chain(clip_by_global_norm(max_norm),
    adamw(piecewise_constant_schedule(lr, {lr_drop_step: 0.1}),
    weight_decay))`` per group, as the JAX package builds it.

    ``base_lr`` maps each group's name to its learning rate; ``group``
    names the group of a leaf from its path (default
    ``engine/partition.py::lr_group``: 'vit' for CLIP, 'head' for the
    rest).

    The update is optax's, in its order, as ``torch._foreach_*`` ops over
    a group's leaves: the clip scales a group to ``t / norm * max_norm``
    only where its norm is not below max_norm; then mu and nu (b1 0.9, b2
    0.999), their bias corrections at the incremented count, mu_hat /
    (sqrt(nu_hat) + 1e-8), the decayed weights added, the sum scaled by
    -lr and added to the leaf. Every leaf of a group is updated and
    decayed, a leaf that got no gradient as if its gradient were zero.

    The state lives on the leaves' device: the moments, made at
    construction, and the update count (optax's ``count``), from which the
    learning-rate drop is selected on the device. A step reads nothing
    back to the host, so the same code runs eagerly and inside a captured
    CUDA graph (``engine/cuda_graph.py``).

    ``mesh``: with a model axis above 1, the cache-row leaves hold this
    rank's slice (``parallel/mesh.py::shard_cache_rows``), and a group's
    norm adds their squared norms over the model group, so that every
    rank clips by the unsharded norm. Which of a group's leaves are
    sharded is a device mask made at construction (``"sharded"`` in the
    group), so the norm builds no tensor from host data."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, named_params, base_lr, group=lr_group,
                 weight_decay=1e-4, lr_drop_step: Optional[int] = None,
                 max_norm=0.1, mesh=None):
        named_params = list(named_params)
        groups = {name: [] for name in base_lr}
        for path, t in named_params:
            groups[group(path)].append(t)
        self.row_group = mesh.row_group if mesh is not None else None
        sharded = {id(t) for path, t in named_params
                   if is_cache_row_leaf(path)}
        self.lr_drop_step = lr_drop_step
        self.max_norm = max_norm
        self.weight_decay = weight_decay
        device = named_params[0][1].device if named_params else "cpu"
        with torch.no_grad():
            self.param_groups = [
                {"name": name, "lr": base_lr[name], "params": ts,
                 "mu": [torch.zeros_like(t) for t in ts],
                 "nu": [torch.zeros_like(t) for t in ts]}
                for name, ts in groups.items() if ts]
        if self.row_group is not None:
            for g in self.param_groups:
                g["sharded"] = torch.tensor(
                    [id(t) in sharded for t in g["params"]], device=device)
        self._count = torch.zeros((), dtype=torch.int64, device=device)

    @property
    def count(self) -> int:
        """Updates made so far (reading it waits for the card)."""
        return int(self._count)

    def zero_grad(self):
        """Zero the gradients in place, keeping their storage."""
        grads = [t.grad for g in self.param_groups for t in g["params"]
                 if t.grad is not None]
        if grads:
            torch._foreach_zero_(grads)

    def _fill_grads(self):
        for group in self.param_groups:
            for t in group["params"]:
                if t.grad is None:
                    t.grad = torch.zeros_like(t)

    def _norm(self, group):
        """The global norm of a group's gradients (over the model group's
        rows where they are sharded)."""
        grads = [t.grad for t in group["params"]]
        if self.row_group is None:
            return torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
        sq = torch.stack(torch._foreach_norm(grads)) ** 2
        sharded = group["sharded"]
        rows = all_reduce(torch.where(sharded, sq, 0.0).sum(),
                          self.row_group)
        return torch.sqrt(torch.where(sharded, 0.0, sq).sum() + rows)

    def _step_size(self, lr):
        """-lr of this update: piecewise_constant_schedule at the count
        before it, selected on the device."""
        if self.lr_drop_step is None:
            return -lr
        return torch.where(self._count >= self.lr_drop_step, -0.1 * lr, -lr)

    @torch.no_grad()
    def step(self):
        self._fill_grads()
        b1, b2 = self.B1, self.B2
        # optax's bias corrections at the incremented count
        t = (self._count + 1).double()
        bc1 = (1.0 - torch.pow(b1, t)).float()
        bc2 = (1.0 - torch.pow(b2, t)).float()
        for group in self.param_groups:
            params, mu, nu = group["params"], group["mu"], group["nu"]
            grads = [p.grad for p in params]
            norm = self._norm(group)
            keep = norm < self.max_norm
            torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
            torch._foreach_mul_(grads, torch.where(keep, 1.0, self.max_norm))
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
            update = torch._foreach_div(mu, bc1)
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.EPS)
            torch._foreach_div_(update, denom)
            torch._foreach_add_(update, params, alpha=self.weight_decay)
            torch._foreach_mul_(update, self._step_size(group["lr"]))
            torch._foreach_add_(params, update)
        self._count.add_(1)

def make_optimizer(lr_vit=1e-3, lr_head=1e-3, weight_decay=1e-4,
                   lr_drop_step: Optional[int] = None, max_norm=0.1,
                   mesh=None):
    """-> make(params) -> a :class:`GroupedAdamW` over the trainable leaves
    of ``params`` (AdamW with two LR groups, StepLR x0.1 at lr_drop_step,
    gradient clip 0.1 per group; ``mesh`` as GroupedAdamW takes it)."""
    def make(params):
        return GroupedAdamW(trainable_leaves(params),
                            {"vit": lr_vit, "head": lr_head},
                            weight_decay=weight_decay,
                            lr_drop_step=lr_drop_step, max_norm=max_norm,
                            mesh=mesh)
    return make


def train_loss(params, buffers, batch, cfg: HOIModelConfig, generator=None,
               mesh=None, detr_out=None):
    """The training objective: the focal-loss sum over the positive count
    (global sums of the batch), plus the language-aware term when
    ``cfg.upt.LA``. -> (loss, aux). The batch's tensors must be on the
    parameters' device.

    ``mesh`` (``parallel/mesh.py``): the batch is this rank's rows of the
    global batch. The positive count is summed over the data axis first,
    so that the SUM of the ranks' losses, and of their gradients, is the
    global batch's; the language-aware term, which depends on the
    parameters alone, enters on data rank 0 only. aux's n_p is then the
    global count."""
    _, aux = _forward(params, buffers, batch, cfg, training=True,
                      generator=generator, mesh=mesh, detr_out=detr_out)
    if mesh is not None and mesh.data_group is not None:
        aux["n_p"] = all_reduce(aux["n_p"].detach().clone(),
                                mesh.data_group)
    total = aux["loss_sum"] / torch.clamp(aux["n_p"], min=1.0)
    if cfg.upt.LA and (mesh is None or mesh.data_index == 0):
        total = total + language_aware_loss(
            params["upt"], buffers["origin_text_embeddings"],
            cfg.upt.LA_weight)
    return total, aux


def make_eval_step(cfg: HOIModelConfig, device=None):
    """-> step(params, buffers, batch) -> detections dict, on ``device``.

    The batch may hold numpy arrays or tensors; they are moved to the
    device. Returns the compact form: detection_scores (B, P, Vmax)
    gathered through the per-object verb LUT, detection_verbs (B, P, Vmax)
    ids, boxes (B, S, 4), objects (B, P) and pair_valid (B, P)."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def step(params, buffers, batch, detr_out=None):
        batch = {k: _as_tensor(v, dev) for k, v in batch.items()}
        with full_f32():
            out = _forward(params, buffers, batch, cfg, detr_out=detr_out)
        return {"detection_scores": out["detection_scores_cmp"],
                "detection_verbs": out["detection_verbs"],
                "boxes": out["boxes"], "objects": out["objects"],
                "pair_valid": out["pair_valid"]}

    return step
