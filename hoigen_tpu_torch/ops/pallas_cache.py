"""Fused Tip-Adapter cache scoring: ``((X W^T + b) L) / s``.

Port of ``hoigen_tpu/ops/pallas_cache.py`` (forward). On a CUDA tensor
:func:`fused_cache_logits` launches the hand-written Hopper kernel
``csrc/cache_logits.cu``; on a CPU tensor it runs
:func:`cache_logits_reference`, the plain PyTorch version of the TPU kernel
``_kernel`` with the same rounding points. The UPT head's H, O and U cache
branches call it (``models/upt.py``). The backward is not ported yet.
"""
import ctypes

import torch

from . import _build, _weights


def cache_logits_reference(x, w, b, l, s, compute_dtype=torch.float32):
    """Plain version of ``_kernel``: X, W and L cast to ``compute_dtype``,
    both products accumulate in f32, phi = X W^T + b is rounded to
    ``compute_dtype`` before the second product, then divided by s."""
    cd = compute_dtype
    phi = torch.matmul(x.to(cd).float(), w.to(cd).float().t()) + b.float()
    logits = torch.matmul(phi.to(cd).float(), l.to(cd).float())
    return logits / s.float()


def fused_cache_logits(x, w, b, l, s, compute_dtype=torch.bfloat16):
    """x (..., N, D); w (R, D); b (R,); l (R, C); s (C,) -> (..., N, C) f32.

    CUDA tensors need f32 operands, D and C multiples of 16 and 8, and
    ``compute_dtype=torch.bfloat16`` (the kernel's tensor-core inputs);
    anything else raises. The kernel reads W and L in bf16: each is cast
    once and the copy reused while it is unchanged."""
    if not x.is_cuda:
        return cache_logits_reference(x, w, b, l, s, compute_dtype)
    if compute_dtype != torch.bfloat16:
        raise ValueError("fused_cache_logits: the CUDA kernel computes in "
                         f"bfloat16, got compute_dtype={compute_dtype}")
    lead = x.shape[:-1]
    d = x.shape[-1]
    r, c = l.shape
    x2 = x.reshape(-1, d)
    args = (("x", x2), ("w", w), ("b", b), ("l", l), ("s", s))
    for name, t in args:
        if t.dtype != torch.float32 or not t.is_cuda:
            raise ValueError(f"fused_cache_logits: {name} must be an f32 "
                             f"CUDA tensor, got {t.dtype} on {t.device}")
    if (w.shape != (r, d) or b.shape != (r,) or s.shape != (c,) or d % 16
            or c % 8):
        raise ValueError(f"fused_cache_logits: shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}, "
                         f"l {tuple(l.shape)}, s {tuple(s.shape)}")
    w, l = (_weights.cast(t.contiguous(), torch.bfloat16) for t in (w, l))
    x2, b, s = (t.contiguous() for t in (x2, b, s))
    if x2.data_ptr() % 16 or w.data_ptr() % 16 or l.data_ptr() % 16:
        raise ValueError("fused_cache_logits: x, w and l must be 16-byte "
                         "aligned (the kernel reads them in vectors)")
    n = x2.shape[0]
    out = torch.empty((n, c), dtype=torch.float32, device=x.device)
    fn = _build.function("cache_logits", "cache_logits_forward",
                         [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                         + [ctypes.c_void_p])
    _build.check(fn(x2.data_ptr(), w.data_ptr(), b.data_ptr(), l.data_ptr(),
                    s.data_ptr(), out.data_ptr(), n, d, r, c,
                    torch.cuda.current_stream(x.device).cuda_stream),
                 "cache_logits")
    fused_cache_logits.launches += 1
    return out.reshape(*lead, c)


fused_cache_logits.launches = 0
