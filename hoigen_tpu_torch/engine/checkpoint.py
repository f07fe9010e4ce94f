"""Checkpoint save/restore over ``torch.save``/``torch.load`` (port of
``hoigen_tpu/engine/checkpoint.py``, which uses Orbax).

A checkpoint is one file ``ckpt_<step>.pt`` holding a nested dict of
tensors, numbers and strings (trainable parameters, optimizer state,
counters). It is loaded with ``weights_only=True``: only such data, never
arbitrary pickled objects.
"""
import os
from typing import Any, Optional

import torch


def save_checkpoint(directory: str, step: int, state: Any) -> str:
    """Write ``state`` to ``<directory>/ckpt_<step:08d>.pt`` (through a
    temporary file, so that a reader never sees half a checkpoint)."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}.pt")
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    cands = sorted(d for d in os.listdir(directory)
                   if d.startswith("ckpt_") and d.endswith(".pt"))
    return os.path.join(os.path.abspath(directory), cands[-1]) if cands \
        else None


def _select(saved, template, partial):
    if isinstance(template, dict):
        if not partial and set(saved) != set(template):
            raise KeyError(f"checkpoint keys {sorted(saved)} differ from "
                           f"{sorted(template)}")
        return {k: _select(saved[k], v, partial) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if len(saved) != len(template):
            raise ValueError(f"checkpoint list of {len(saved)} where "
                             f"{len(template)} are expected")
        return type(template)(_select(s, t, partial)
                              for s, t in zip(saved, template))
    if isinstance(template, torch.Tensor):
        if tuple(saved.shape) != tuple(template.shape):
            raise ValueError(f"checkpoint shape {tuple(saved.shape)} where "
                             f"{tuple(template.shape)} is expected")
        return saved.to(device=template.device, dtype=template.dtype)
    return saved


def restore_checkpoint(path: str, like: Any = None,
                       partial: bool = False) -> Any:
    """The state saved at ``path``. With ``like``, its structure: every key
    of ``like`` must be in the checkpoint, tensors take ``like``'s device
    and dtype and must have its shapes, and without ``partial`` the keys
    must be the same. ``partial=True`` restores only the subtree named by
    ``like`` from a larger checkpoint (for example the trainable parameters
    of a full training state, for eval)."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    return saved if like is None else _select(saved, like, partial)
