"""Kernel-ready copies of weights, made once and reused across calls.

A wrapper whose kernel reads a weight in another dtype or layout than the
parameter tree holds (bf16 products, a reshaped 3x3 filter) asks
:func:`prepared` for it. The copy is made at the first call and reused for
as long as the source tensors live and are not changed in place (torch
bumps a tensor's version counter on every in-place write), so the eval
step does not recast its frozen weights at every launch.
"""
from torch.utils.weak import WeakIdKeyDictionary

_copies = WeakIdKeyDictionary()


def prepared(tag, sources, make):
    """``make()``, cached under the first of ``sources`` and ``tag``; made
    anew when any source is another tensor or has been written since.
    ``make`` returns new tensors, never ``sources[0]`` or a view of it,
    which would keep the entry's key alive."""
    stamp = tuple((id(t), t._version) for t in sources)
    entries = _copies.setdefault(sources[0], {})
    hit = entries.get(tag)
    if hit is None or hit[0] != stamp:
        hit = entries[tag] = (stamp, make())
    return hit[1]


def cast(t, dtype):
    """``t`` in ``dtype``: ``t`` itself where it already is (nothing is
    cached then, so no entry holds its own key alive), else a copy made
    once."""
    if t.dtype == dtype:
        return t
    return prepared(("cast", dtype), (t,), lambda: t.to(dtype))
