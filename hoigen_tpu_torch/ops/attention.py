"""Fused multi-head attention: ``softmax(q k^T * scale + bias) v`` and its
gradient.

Port of ``hoigen_tpu/ops/attention.py``. :func:`fused_attention` is a
``torch.autograd.Function`` (the JAX package's ``custom_vjp``
``_attention_ad``) on both devices. On CUDA tensors its forward launches
the hand-written Hopper kernel K1 and its backward the kernel K4, both in
``csrc/attention.cu``; on CPU tensors they run :func:`attention_reference`
and :func:`attention_bwd_reference`, the plain PyTorch versions of the TPU
kernels ``_attn_kernel`` and ``_attn_bwd_kernel`` with the same rounding
points. The DETR encoder (bf16, under no grad) and the CLIP tower in
training (f32) call it.
"""
import ctypes
import math

import torch

from . import _build


def _operand(compute_dtype):
    """The product operands of a plain version: rounded to
    ``compute_dtype`` (the card's bf16 tensor-core inputs) or, for None,
    taken as they are (the CPU, where the TPU's DEFAULT precision is
    plain f32). Always returned as f32 for an f32 accumulation."""
    if compute_dtype is None:
        return lambda t: t.float()
    return lambda t: t.to(compute_dtype).float()


def _softmax(q, k, key_bias, sm_scale, rd):
    s = torch.matmul(rd(q), rd(k).transpose(-1, -2)) * sm_scale
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    e = torch.exp(s - s.amax(-1, keepdim=True))
    # reciprocal-multiply: one divide per row, as the TPU kernel
    return e * (1.0 / e.sum(-1, keepdim=True))


def attention_reference(q, k, v, key_bias=None, sm_scale=None,
                        compute_dtype=None):
    """Plain version of ``_attn_kernel``: f32 scores, max and sum; the
    normaliser is a reciprocal-multiply; p is cast to v's dtype before the
    PV product, which accumulates in f32. q (B, H, Lq, D), k/v (B, H, Lk,
    D), key_bias (B, Lk) additive f32 or None. Returns q's dtype."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    rd = _operand(compute_dtype)
    p = _softmax(q, k, key_bias, sm_scale, rd).to(v.dtype)
    return torch.matmul(rd(p), rd(v)).to(q.dtype)


def attention_bwd_reference(q, k, v, key_bias, out, g, sm_scale=None,
                            compute_dtype=None):
    """Plain version of ``_attn_bwd_kernel``: the softmax recomputed (no
    logsumexp saved); p cast to v's dtype before dv = p^T g; delta =
    rowsum(g * out) in f32; ds = p (dp - delta) in f32; d(key_bias) sums ds
    over heads and queries; ds * scale cast to q's dtype before dq = ds k
    and dk = ds^T q. Returns (dq in q's dtype, dk, dv in k's and v's dtype,
    d(key_bias) (B, Lk) f32, or None without a key bias)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    rd = _operand(compute_dtype)
    p = _softmax(q, k, key_bias, sm_scale, rd)
    dv = torch.matmul(rd(p.to(v.dtype)).transpose(-1, -2), rd(g))
    dp = torch.matmul(rd(g), rd(v).transpose(-1, -2))
    delta = (g.float() * out.float()).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    db = None if key_bias is None else ds.sum((1, 2)).to(key_bias.dtype)
    dsc = rd((ds * sm_scale).to(q.dtype))
    dq = torch.matmul(dsc, rd(k)).to(q.dtype)
    dk = torch.matmul(dsc.transpose(-1, -2), rd(q))
    return dq, dk.to(k.dtype), dv.to(v.dtype), db


def _check(name, q, k, v, key_bias):
    """Shapes and dtypes the CUDA kernels take; raises on anything else."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    for n, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in (torch.bfloat16, torch.float32) or not t.is_cuda \
                or t.dtype != q.dtype:
            raise ValueError(f"{name}: q, k and v must be CUDA tensors of one "
                             f"dtype, bf16 or f32; {n} is {t.dtype} on "
                             f"{t.device}")
    if k.shape != (b, h, lk, d) or v.shape != k.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in (32, 64):
        raise ValueError(f"{name}: head dim {d} not in (32, 64)")
    if key_bias is not None and (key_bias.shape != (b, lk)
                                 or not key_bias.is_cuda):
        raise ValueError(f"{name}: key_bias must be a CUDA ({b}, {lk}) "
                         f"tensor, got {tuple(key_bias.shape)}")


def _ptrs(name, *tensors):
    """Data pointers of contiguous tensors (None for None), checked for the
    16-byte alignment of the kernels' vector loads."""
    out = []
    for t in tensors:
        if t is None:
            out.append(None)
            continue
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")
        out.append(t.data_ptr())
    return out


def attention_forward(q, k, v, key_bias=None, sm_scale=None):
    """K1 on CUDA tensors (bf16 or f32 q/k/v, head dim 32 or 64; f32
    operands are rounded to bf16 for the products), the plain version on
    CPU tensors. No gradient: :func:`fused_attention` is the differentiable
    entry point."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if not q.is_cuda:
        return attention_reference(q, k, v, key_bias, sm_scale)
    _check("attention_forward", q, k, v, key_bias)
    b, h, lq, d = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if key_bias is not None:
        key_bias = key_bias.float().contiguous()
    out = torch.empty_like(q)
    fn = _build.function("attention", "attention_forward",
                         [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                         + [ctypes.c_float, ctypes.c_void_p])
    _build.check(fn(*_ptrs("attention_forward", q, k, v, key_bias, out),
                    b, h, lq, k.shape[2], d, int(q.dtype == torch.float32),
                    float(sm_scale),
                    torch.cuda.current_stream(q.device).cuda_stream),
                 "attention_forward")
    fused_attention.launches += 1
    return out


def attention_bwd(q, k, v, key_bias, out, g, sm_scale=None,
                  bias_grad=True):
    """(dq, dk, dv, d(key_bias)): K4 on CUDA tensors, the plain version on
    CPU tensors. d(key_bias) is None when there is no key bias or
    ``bias_grad`` is False."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if not q.is_cuda:
        dq, dk, dv, db = attention_bwd_reference(q, k, v, key_bias, out, g,
                                                 sm_scale)
        return dq, dk, dv, db if bias_grad else None
    _check("attention_bwd", q, k, v, key_bias)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if out.shape != q.shape or g.shape != q.shape or out.dtype != q.dtype \
            or g.dtype != q.dtype:
        raise ValueError(f"attention_bwd: out {tuple(out.shape)} "
                         f"{out.dtype} and g {tuple(g.shape)} {g.dtype} must "
                         f"match q {tuple(q.shape)} {q.dtype}")
    q, k, v, out, g = (t.contiguous() for t in (q, k, v, out, g))
    if key_bias is not None:
        key_bias = key_bias.float().contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    db = part = None
    if key_bias is not None and bias_grad:
        db = torch.empty((b, lk), dtype=torch.float32, device=q.device)
        part = torch.empty((b, h, lk), dtype=torch.float32, device=q.device)
    # per-row max, 1/sum and delta, passed from the dq launch to the dk/dv
    # launch
    stats = torch.empty((3, b, h, lq), dtype=torch.float32, device=q.device)
    fn = _build.function("attention", "attention_backward",
                         [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
                         + [ctypes.c_float, ctypes.c_void_p])
    _build.check(fn(*_ptrs("attention_bwd", q, k, v, key_bias, out, g, dq,
                           dk, dv, db, stats, part),
                    b, h, lq, lk, d, int(q.dtype == torch.float32),
                    float(sm_scale),
                    torch.cuda.current_stream(q.device).cuda_stream),
                 "attention_backward")
    attention_bwd.launches += 1
    return dq, dk, dv, db


class _FusedAttention(torch.autograd.Function):
    """K1 forward, K4 backward (on the CPU, their plain versions)."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, sm_scale):
        out = attention_forward(q, k, v, key_bias, sm_scale)
        ctx.save_for_backward(q, k, v, key_bias, out)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_bias, out = ctx.saved_tensors
        dq, dk, dv, db = attention_bwd(q, k, v, key_bias, out, g,
                                       ctx.sm_scale,
                                       bias_grad=ctx.needs_input_grad[3])
        return dq, dk, dv, db, None


def fused_attention(q, k, v, key_bias=None, sm_scale=None):
    """q (B, H, Lq, D); k, v (B, H, Lk, D); key_bias optional (B, Lk)
    additive f32 (-1e9 for padded keys). Returns (B, H, Lq, D) in q.dtype.

    Differentiable in q, k, v and key_bias. CUDA tensors need q/k/v of one
    dtype, bf16 or f32, with D in {32, 64}; anything else raises.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _FusedAttention.apply(q, k, v, key_bias, sm_scale)


fused_attention.launches = 0        # K1 launches
attention_bwd.launches = 0          # K4 launches
