"""Fused Tip-Adapter cache scoring: ``((X W^T + b) L) / s``, and its
gradient.

Port of ``hoigen_tpu/ops/pallas_cache.py``. :func:`fused_cache_logits` is
a ``torch.autograd.Function`` (the JAX package's ``custom_vjp``) on both
devices. On a CUDA tensor its forward launches the hand-written Hopper
kernel ``csrc/cache_logits.cu``; on a CPU tensor it runs
:func:`cache_logits_reference`, the plain PyTorch version of the TPU kernel
``_kernel`` with the same rounding points. Its backward is
:func:`cache_logits_bwd`, the plain f32 products of the JAX package's
``_bwd``, which the TPU too computes outside any Pallas kernel. The UPT
head's H, O and U cache branches call it (``models/upt.py``).
"""
import ctypes

import torch
import torch.nn.functional as F

from . import _build, _weights


def cache_logits_reference(x, w, b, l, s, compute_dtype=torch.float32):
    """Plain version of ``_kernel``: X, W and L cast to ``compute_dtype``,
    both products accumulate in f32, phi = X W^T + b is rounded to
    ``compute_dtype`` before the second product, then divided by s."""
    cd = compute_dtype
    phi = torch.matmul(x.to(cd).float(), w.to(cd).float().t()) + b.float()
    logits = torch.matmul(phi.to(cd).float(), l.to(cd).float())
    return logits / s.float()


def cache_logits_bwd(x, w, l, s, g):
    """``_bwd``: the gradients of ((x w^T + b) l) / s in x, w and b, as
    plain f32 products (l and s are frozen buffers)."""
    g_phi = torch.matmul(g / s, l.t())                   # (..., N, R)
    dx = torch.matmul(g_phi, w).to(x.dtype)
    flat = g_phi.reshape(-1, w.shape[0])
    dw = torch.matmul(flat.t(), x.reshape(-1, x.shape[-1])).to(w.dtype)
    return dx, dw, flat.sum(0)


def kernel_operands(w, l, s):
    """The kernel's copies of W, L and s, each made once and reused while
    its source is unchanged: W and L in bf16, L's columns padded with
    zeros (and s with ones) to a multiple of 8 for the kernel's 16-byte
    row copies. The padded columns are never written out."""
    c = l.shape[1]
    lc = -(-c // 8) * 8
    w = _weights.cast(w.contiguous(), torch.bfloat16)
    l = _weights.prepared(("cache_l", lc), (l,), lambda: F.pad(
        l, (0, lc - c)).to(torch.bfloat16).contiguous())
    s = _weights.prepared(("cache_s", lc), (s,), lambda: F.pad(
        s.float(), (0, lc - c), value=1.0).contiguous())
    return w, l, s


def _kernel_forward(x, w, b, l, s):
    """K3 on CUDA tensors: f32 operands, D a multiple of 16, any C."""
    lead = x.shape[:-1]
    d = x.shape[-1]
    r, c = l.shape
    x2 = x.reshape(-1, d)
    for name, t in (("x", x2), ("w", w), ("b", b), ("l", l), ("s", s)):
        if t.dtype != torch.float32 or not t.is_cuda:
            raise ValueError(f"fused_cache_logits: {name} must be an f32 "
                             f"CUDA tensor, got {t.dtype} on {t.device}")
    if w.shape != (r, d) or b.shape != (r,) or s.shape != (c,) or d % 16:
        raise ValueError(f"fused_cache_logits: shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}, "
                         f"l {tuple(l.shape)}, s {tuple(s.shape)}")
    w, l, s = kernel_operands(w, l, s)
    lc = l.shape[1]
    x2, b = x2.contiguous(), b.contiguous()
    if x2.data_ptr() % 16 or w.data_ptr() % 16 or l.data_ptr() % 16:
        raise ValueError("fused_cache_logits: x, w and l must be 16-byte "
                         "aligned (the kernel reads them in vectors)")
    n = x2.shape[0]
    out = torch.empty((n, c), dtype=torch.float32, device=x.device)
    fn = _build.function("cache_logits", "cache_logits_forward",
                         [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                         + [ctypes.c_void_p])
    _build.check(fn(x2.data_ptr(), w.data_ptr(), b.data_ptr(), l.data_ptr(),
                    s.data_ptr(), out.data_ptr(), n, d, r, c, lc,
                    torch.cuda.current_stream(x.device).cuda_stream),
                 "cache_logits")
    fused_cache_logits.launches += 1
    return out.reshape(*lead, c)


class _CacheLogits(torch.autograd.Function):
    """K3 forward (on the CPU, its plain version); ``_bwd`` backward."""

    @staticmethod
    def forward(ctx, x, w, b, l, s, compute_dtype):
        if x.is_cuda:
            if compute_dtype != torch.bfloat16:
                raise ValueError("fused_cache_logits: the CUDA kernel "
                                 "computes in bfloat16, got compute_dtype="
                                 f"{compute_dtype}")
            out = _kernel_forward(x, w, b, l, s)
        else:
            out = cache_logits_reference(x, w, b, l, s, compute_dtype)
        ctx.save_for_backward(x, w, l, s)
        return out

    @staticmethod
    def backward(ctx, g):
        dx, dw, db = cache_logits_bwd(*ctx.saved_tensors, g)
        return dx, dw, db, None, None, None


def fused_cache_logits(x, w, b, l, s, compute_dtype=torch.bfloat16):
    """x (..., N, D); w (R, D); b (R,); l (R, C); s (C,) -> (..., N, C) f32.

    Differentiable in x, w and b. CUDA tensors need f32 operands, D a
    multiple of 16 and ``compute_dtype=torch.bfloat16`` (the kernel's
    tensor-core inputs); anything else raises."""
    return _CacheLogits.apply(x, w, b, l, s, compute_dtype)


fused_cache_logits.launches = 0
