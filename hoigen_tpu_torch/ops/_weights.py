"""Kernel-ready copies of weights, made once and reused across calls.

A wrapper whose kernel reads a weight in another dtype or layout than the
parameter tree holds (bf16 products, a reshaped 3x3 filter) asks
:func:`prepared` for it. The copy is made at the first call and reused for
as long as the source tensors live and are not changed in place (torch
bumps a tensor's version counter on every in-place write), so the eval
step does not recast its frozen weights at every launch.

:func:`constant` does the same for small tables of numbers (normalisation
statistics, gather indices): a step that reads one builds no tensor from
host data, which a captured CUDA graph could not hold.
"""
import torch
from torch.utils.weak import WeakIdKeyDictionary

_copies = WeakIdKeyDictionary()
_constants = {}


def prepared(tag, sources, make):
    """``make()``, cached under the first of ``sources`` and ``tag``; made
    anew when any source is another tensor or has been written since.
    ``make`` returns new tensors, never ``sources[0]`` or a view of it,
    which would keep the entry's key alive.

    Two copies are never served, so that none reaches a training graph:
    while grad mode is on, a source that requires grad gets a fresh
    conversion, uncached (it carries the autograd history the gradient
    needs); and a copy made under ``inference_mode`` (an inference tensor,
    which autograd refuses to save) is remade when asked for outside it."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in sources):
        return make()
    stamp = tuple((id(t), t._version) for t in sources)
    entries = _copies.setdefault(sources[0], {})
    hit = entries.get(tag)
    if (hit is None or hit[0] != stamp
            or (hit[1] and not torch.is_inference_mode_enabled())):
        hit = entries[tag] = (stamp, torch.is_inference_mode_enabled(),
                              make())
    return hit[2]


def cast(t, dtype):
    """``t`` in ``dtype``: ``t`` itself where it already is (nothing is
    cached then, so no entry holds its own key alive), else a copy made
    once."""
    if t.dtype == dtype:
        return t
    return prepared(("cast", dtype), (t,), lambda: t.to(dtype))


def copies_of(sources):
    """Every copy cached under one of ``sources`` (a captured CUDA graph
    keeps them alive, so that memory it reads is never handed out again
    while it lives)."""
    return [hit[2] for t in sources for hit in _copies.get(t, {}).values()]


def constant(values, device, dtype=torch.float32):
    """``values`` (a tuple of numbers) as a 1-D ``dtype`` tensor on
    ``device``, made at the first call for that device and dtype and
    shared after it: read it, never write it. Made outside inference mode,
    so that autograd may save it."""
    key = (values, torch.device(device), dtype)
    t = _constants.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = _constants[key] = torch.tensor(values, dtype=dtype,
                                               device=device)
    return t
