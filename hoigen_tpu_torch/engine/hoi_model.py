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
from ..ops._weights import constant
from ..ops.pixels import device_normalize, pad_mask_from_sizes
from ..ops.resize import batch_resize_normalize
from ..parallel.distributed import all_reduce
from ..parallel.mesh import is_cache_row_leaf
from .partition import lr_group, mark_trainable, trainable_leaves
from .profiling import device_range


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
             generator=None, mesh=None):
    """The JAX package's ``_forward``: detections (eval) or (loss, aux)
    (training). DETR and DINO run under no grad. ``generator``: dropout in
    training (None runs none, as the JAX package's rng=None).
    ``mesh``: where the cache rows are sharded, or None. Device ranges
    (``engine/profiling.py``): ``detr`` from the pixels to the
    postprocess, ``clip`` for the CLIP stream's pixels, then
    ``upt_forward``'s."""
    dtype = getattr(torch, cfg.dtype)
    clip_cfg = cfg.clip
    if clip_cfg.fused_attention and not training:
        # the fused CLIP attention is for its backward (K4); at eval the
        # JAX package runs the plain math, and so does the port
        clip_cfg = dataclasses.replace(clip_cfg, fused_attention=False)
    with device_range("detr"):
        if "image_mask" in batch:
            image_mask = batch["image_mask"]
        else:
            image_mask = pad_mask_from_sizes(batch["image_sizes"],
                                             batch["images"].shape[2],
                                             batch["images"].shape[3])
        images = device_normalize(batch["images"], dtype,
                                  pad_mask=image_mask)
        with torch.no_grad():
            detr_out = detr_forward(params["detr"], images, image_mask,
                                    cfg.detr)
        pred_logits = detr_out["pred_logits"].float()
        if pred_logits.shape[-1] == 92:
            # COCO-pretrained V-COCO detector: gather the 91-slot logits
            # down to 80 real classes (person first) and no-object before
            # the softmax
            pred_logits = pred_logits[..., constant(
                tuple(detr_reserve_indices()), pred_logits.device,
                torch.long)]
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
    with device_range("clip"):
        if "images_clip" in batch:
            images_clip = device_normalize(batch["images_clip"],
                                           torch.float32)
        else:
            # the 224 stream derived from the shipped DETR stream, with
            # PIL's uint8 rounding
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

    def state_tensors(self):
        """Every tensor a step writes: the leaves, their gradients (None
        where none was made yet), the moments and the count."""
        return ([t for g in self.param_groups for t in g["params"]]
                + [t.grad for g in self.param_groups for t in g["params"]]
                + [t for g in self.param_groups for t in g["mu"] + g["nu"]]
                + [self._count])

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

    @torch.no_grad()
    def all_reduce_grads(self, group):
        """SUM every gradient over ``group`` (the data axis), in one
        flat buffer; a leaf that got none counts as zero."""
        self._fill_grads()
        grads = [t.grad for g in self.param_groups for t in g["params"]]
        flat = all_reduce(torch._utils._flatten_dense_tensors(grads), group)
        for g, r in zip(grads, torch._utils._unflatten_dense_tensors(
                flat, grads)):
            g.copy_(r)

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

    def state_dict(self):
        """{"mu": [...], "nu": [...], "count": int}, the moments in the
        order of the groups' leaves."""
        return {"mu": [t for g in self.param_groups for t in g["mu"]],
                "nu": [t for g in self.param_groups for t in g["nu"]],
                "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state):
        """Copy a :meth:`state_dict` into the state in place. Also reads
        the layout of earlier checkpoints, ``{"adamw":
        torch.optim.AdamW.state_dict(), "count": int}``, whose per-leaf
        state is numbered in the same order (a leaf without one never
        had a step)."""
        mine = self.state_dict()
        if "adamw" in state:
            saved = state["adamw"]["state"]
            state = dict(state, **{
                key: [saved[i][name] if i in saved else torch.zeros_like(t)
                      for i, t in enumerate(mine[key])]
                for key, name in (("mu", "exp_avg"), ("nu", "exp_avg_sq"))})
        for key in ("mu", "nu"):
            if len(state[key]) != len(mine[key]):
                raise ValueError(f"optimizer state of {len(state[key])} "
                                 f"leaves where {len(mine[key])} are held")
            for t, s in zip(mine[key], state[key]):
                t.copy_(s)
        self._count.fill_(int(state["count"]))


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
               mesh=None):
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
                      generator=generator, mesh=mesh)
    with device_range("head"):
        if mesh is not None and mesh.data_group is not None:
            aux["n_p"] = all_reduce(aux["n_p"].detach().clone(),
                                    mesh.data_group)
        total = aux["loss_sum"] / torch.clamp(aux["n_p"], min=1.0)
        if cfg.upt.LA and (mesh is None or mesh.data_index == 0):
            total = total + language_aware_loss(
                params["upt"], buffers["origin_text_embeddings"],
                cfg.upt.LA_weight)
    return total, aux


def make_train_step(cfg: HOIModelConfig, optimizer, device=None, mesh=None):
    """-> step(params, buffers, batch, generator=None) -> metrics {"loss",
    "n_p"} (device tensors: reading them waits for the card). One
    optimizer step of ``optimizer`` (from :func:`make_optimizer`) on the
    parameters, in place.

    ``mesh``: a data-parallel step over its data axis (each rank's batch
    its rows of the global batch; the gradients summed over the axis
    after the backward, the loss reported the global one) with the cache
    rows sharded over its model axis where it has one. The step keeps
    ``mesh`` as its attribute (``engine/train.py::Trainer`` captures a
    step without one as a CUDA graph). Device ranges: ``_forward``'s,
    ``backward``, ``optimizer`` (``zero_grad`` and the update; on a model
    axis the update's norm reduction too) and ``allreduce`` (the data
    axis' gradient and loss sums)."""
    dev = resolve_device(device)
    group = mesh.data_group if mesh is not None else None

    def step(params, buffers, batch, generator=None):
        batch = {k: _as_tensor(v, dev) for k, v in batch.items()}
        with full_f32():
            with device_range("optimizer"):
                optimizer.zero_grad()
            loss, aux = train_loss(params, buffers, batch, cfg, generator,
                                   mesh)
            with device_range("backward"):
                loss.backward()
            loss = loss.detach()
            if group is not None:
                with device_range("allreduce"):
                    optimizer.all_reduce_grads(group)
                    loss = all_reduce(loss.clone(), group)
            with device_range("optimizer"):
                optimizer.step()
        return {"loss": loss, "n_p": aux["n_p"].detach()}

    step.mesh = mesh
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
