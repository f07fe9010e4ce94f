"""Parameters of the JAX package, as numpy, -> the port's parameters.

``hoigen_tpu.engine.hoi_model.init_hoi_model`` returns
``(trainable, frozen, buffers)``: trainable and ``frozen["upt"]`` share one
tree shape with ``None`` where a leaf belongs to the other. The port holds
them merged, under the same key paths and layouts, so that both packages
compute the same function from the same weights. Inputs are nested
dicts/lists of numpy arrays (``jax.tree.map(np.asarray, tree)``); this
module imports neither JAX nor the JAX package.
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
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def _merge(trainable, frozen):
    if isinstance(trainable, dict):
        return {k: _merge(trainable[k], frozen[k]) for k in trainable}
    if isinstance(trainable, (list, tuple)):
        return type(trainable)(_merge(a, b)
                               for a, b in zip(trainable, frozen))
    return frozen if trainable is None else trainable


def params_from_jax(trainable, frozen, buffers, device=None):
    """(trainable, frozen, buffers) of the JAX package, as numpy trees ->
    (params, buffers) of the port on ``device`` (None -> CUDA)."""
    dev = resolve_device(device)
    params = {"upt": _merge(trainable, frozen["upt"]),
              "detr": frozen["detr"], "dino": frozen["dino"]}
    return to_torch(params, dev), to_torch(buffers, dev)
