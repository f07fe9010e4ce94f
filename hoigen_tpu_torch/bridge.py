"""Parameters of the JAX package, as numpy, -> the port's parameters.

``hoigen_tpu.engine.hoi_model.init_hoi_model`` returns
``(trainable, frozen, buffers)``: trainable and ``frozen["upt"]`` share one
tree shape with ``None`` where a leaf belongs to the other. The port holds
them merged, under the same key paths and layouts, so that both packages
compute the same function from the same weights; a leaf requires grad
exactly where the JAX package puts it in ``trainable``. Inputs are nested
dicts/lists of numpy arrays (``jax.tree.map(np.asarray, tree)``); this
module imports neither JAX nor the JAX package. :func:`to_numpy` and
:func:`grads_to_numpy` go the other way, for comparisons.
"""
import numpy as np
import torch

from .engine.hoi_model import resolve_device


def to_torch(tree, device="cpu"):
    """numpy tree -> tensor tree: floats as float32 (the port's parameter
    dtype), integers as int64 (torch's index dtype), bools as bool."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    if tree is None:
        return None
    a = np.asarray(tree)
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    elif a.dtype.kind in "iu":
        a = a.astype(np.int64)
    # np.array, not np.ascontiguousarray, which turns a 0-d leaf into 1-d
    return torch.as_tensor(np.array(a, order="C"), device=device)


def to_numpy(tree):
    """tensor tree -> numpy tree (detached, on the CPU); None stays None."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if tree is None:
        return None
    return tree.detach().cpu().numpy()


def grads_to_numpy(tree):
    """The gradients of a parameter tree, as numpy, in the JAX package's
    ``trainable`` shape: None for a leaf that does not require grad, zeros
    for one that got no gradient (JAX's gradient of an unused leaf)."""
    if isinstance(tree, dict):
        return {k: grads_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(grads_to_numpy(v) for v in tree)
    if tree is None or not tree.requires_grad:
        return None
    g = tree.grad
    return np.zeros(tree.shape, np.float32) if g is None \
        else g.detach().cpu().numpy()


def _merge(trainable, frozen):
    if isinstance(trainable, dict):
        return {k: _merge(trainable[k], frozen[k]) for k in trainable}
    if isinstance(trainable, (list, tuple)):
        return type(trainable)(_merge(a, b)
                               for a, b in zip(trainable, frozen))
    return frozen if trainable is None else trainable


def _require_grad(tree, trainable):
    """requires_grad on each leaf of ``tree`` that ``trainable`` (the JAX
    package's tree of the same shape) holds, off where it holds None."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _require_grad(v, trainable[k])
    elif isinstance(tree, (list, tuple)):
        for v, t in zip(tree, trainable):
            _require_grad(v, t)
    elif tree is not None:
        tree.requires_grad_(trainable is not None)


def params_from_jax(trainable, frozen, buffers, device=None):
    """(trainable, frozen, buffers) of the JAX package, as numpy trees ->
    (params, buffers) of the port on ``device`` (None -> CUDA)."""
    dev = resolve_device(device)
    params = to_torch({"upt": _merge(trainable, frozen["upt"]),
                       "detr": frozen["detr"], "dino": frozen["dino"]}, dev)
    _require_grad(params["upt"], trainable)
    return params, to_torch(buffers, dev)
