"""Tip-Adapter cache scoring: ``((X W^T + b) L) / s``, and its gradient.

Port of ``hoigen_tpu/ops/pallas_cache.py``. :func:`fused_cache_logits` is
a ``torch.autograd.Function`` (the JAX package's ``custom_vjp``) on both
devices. On a CPU tensor its forward runs :func:`cache_logits_reference`,
the plain PyTorch version of the TPU kernel ``_kernel`` with the same
rounding points. On a CUDA tensor it launches the hand-written Hopper
kernel ``csrc/cache_logits.cu``: one TMA + ``wgmma`` bf16 product kernel,
launched twice per call. The first launch writes phi = bf16(X W^T + b)
into a scratch buffer, once; the second multiplies phi by L and divides
by s. :func:`kernel_operands` prepares the kernel's copies of the weights
(L transposed and padded) and :func:`_gemm_plan` picks each launch's
tiles. Its backward is :func:`cache_logits_bwd`, the plain f32 products of
the JAX package's ``_bwd``, which the TPU too computes outside any Pallas
kernel. The UPT head's H, O and U cache branches call it
(``models/upt.py``).
"""
import ctypes
import functools

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
    its source is unchanged: W (R, D) in bf16; L^T (LC, RP) in bf16, zero
    outside the first (C, R), with RP and LC the class and row counts R and
    C rounded up to a multiple of 8 (so that every row stride is a
    multiple of 16 bytes, as TMA needs); s padded with ones to LC."""
    r, c = l.shape
    rp, lc = -(-r // 8) * 8, -(-c // 8) * 8

    def transpose():
        lt = torch.zeros((lc, rp), dtype=torch.bfloat16, device=l.device)
        lt[:c, :r] = l.t()
        return lt

    w = _weights.cast(w.contiguous(), torch.bfloat16)
    lt = _weights.prepared(("cache_lt", lc, rp), (l,), transpose)
    s = _weights.prepared(("cache_s", lc), (s,), lambda: F.pad(
        s.float(), (0, lc - c), value=1.0).contiguous())
    return w, lt, s


# the kernel's fixed tile sizes (csrc/cache_logits.cu): 64 rows of A per
# block (one wgmma M), 64 bf16 of K per stage (one 128-byte swizzled row),
# a ring of 3 stages (faster than 4 at the eval shapes, where three
# 128-wide blocks fit an SM and two fit with 4; within 3% of 4 at the
# training shapes); block widths, widest first
_BM, _BK, _STAGES = 64, 64, 3
_BN_CHOICES = (128, 64, 32)
_H100_SMS = 132


@functools.lru_cache(maxsize=None)
def _gemm_plan(m, n, k):
    """Tiles of one launch of the product kernel, out (m, n) = A (m, k)
    B (n, k)^T: ``(bm, bn, bk, stages, smem_bytes, grid)``. bn is the
    widest of 128, 64 and 32 whose grid still gives each of an H100's 132
    SMs two blocks, else 32 (each block streams its operands from L2 and
    waits on it, so two a SM hide more of that wait;
    ``tools/sweep_cache_tiles.py`` measures the choices); smem_bytes is the kernel's dynamic shared memory
    (the ring with two 8-byte barriers a stage, and 1024 bytes to align it
    to the swizzle's atom), as ``smem_bytes`` in the source computes it;
    grid is (row tiles, column tiles)."""
    rows = -(-m // _BM)
    bn = next((c for c in _BN_CHOICES
               if rows * -(-n // c) >= 2 * _H100_SMS), _BN_CHOICES[-1])
    smem = 1024 + _STAGES * ((_BM + bn) * _BK * 2 + 16)
    return _BM, bn, _BK, _STAGES, smem, (rows, -(-n // bn))


@functools.cache
def _launcher():
    return _build.function("cache_logits", "cache_logits_forward",
                           [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                           + [ctypes.c_void_p])


def _kernel_forward(x, w, b, l, s):
    """K3 on CUDA tensors (f32 operands, D a multiple of 8, any N, R and
    C): returns the logits and the bf16 phi scratch (N, RP) that the first
    launch wrote."""
    lead = x.shape[:-1]
    d = x.shape[-1]
    r, c = l.shape
    x2 = x.reshape(-1, d)
    for name, t in (("x", x2), ("w", w), ("b", b), ("l", l), ("s", s)):
        if t.dtype != torch.float32 or not t.is_cuda:
            raise ValueError(f"fused_cache_logits: {name} must be an f32 "
                             f"CUDA tensor, got {t.dtype} on {t.device}")
    if w.shape != (r, d) or b.shape != (r,) or s.shape != (c,) or d % 8:
        raise ValueError(f"fused_cache_logits: shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}, "
                         f"l {tuple(l.shape)}, s {tuple(s.shape)}")
    w16, lt, s_pad = kernel_operands(w, l, s)
    lc, rp = lt.shape
    # X rounds to bf16 outside the kernel, as the JAX package casts it
    # outside its pallas_call (TMA copies, it does not convert)
    x16, b = x2.to(torch.bfloat16).contiguous(), b.contiguous()
    n = x2.shape[0]
    phi = torch.empty((n, rp), dtype=torch.bfloat16, device=x.device)
    out = torch.empty((n, c), dtype=torch.float32, device=x.device)
    _, bn1, _, stages, _, _ = _gemm_plan(n, rp, d)
    bn2 = _gemm_plan(n, c, rp)[1]
    _build.check(_launcher()(
        x16.data_ptr(), w16.data_ptr(), b.data_ptr(), lt.data_ptr(),
        s_pad.data_ptr(), phi.data_ptr(), out.data_ptr(), n, d, r, rp, c,
        lc, bn1, bn2, stages,
        torch.cuda.current_stream(x.device).cuda_stream), "cache_logits")
    fused_cache_logits.launches += 1
    return out.reshape(*lead, c), phi


class _CacheLogits(torch.autograd.Function):
    """K3 forward (on the CPU, its plain version); ``_bwd`` backward."""

    @staticmethod
    def forward(ctx, x, w, b, l, s, compute_dtype):
        if x.is_cuda:
            if compute_dtype != torch.bfloat16:
                raise ValueError("fused_cache_logits: the CUDA kernel "
                                 "computes in bfloat16, got compute_dtype="
                                 f"{compute_dtype}")
            out, _ = _kernel_forward(x, w, b, l, s)
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
    multiple of 8 and ``compute_dtype=torch.bfloat16`` (the kernel's
    tensor-core inputs); anything else raises."""
    return _CacheLogits.apply(x, w, b, l, s, compute_dtype)


fused_cache_logits.launches = 0
