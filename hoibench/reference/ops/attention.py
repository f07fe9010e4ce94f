"""Attention of the HOI model in plain PyTorch: ``softmax(q k^T * scale +
bias) v`` and its gradient, with the rounding points of the hand-written
kernels (every product's operands rounded to bf16 and accumulated in f32,
the normaliser a reciprocal-multiply, p cast to v's dtype before the PV
product), so that the reference follows the same arithmetic on every
device. The DETR encoder (bf16, under no grad) and the CLIP tower in
training (f32) call :func:`fused_attention`.
"""
import math

import torch

BF16 = torch.bfloat16


def _operand(compute_dtype):
    """The product operands of a plain version: rounded to
    ``compute_dtype`` (the card's bf16 tensor-core inputs) or, for None,
    taken as they are (the CPU, where the TPU's DEFAULT precision is
    plain f32). Always returned as f32 for an f32 accumulation."""
    if compute_dtype is None:
        return lambda t: t.float()
    return lambda t: t.to(compute_dtype).float()


def _scores(q, k, key_bias, sm_scale, rd):
    s = torch.matmul(rd(q), rd(k).transpose(-1, -2)) * sm_scale
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    return s


def _softmax(s, stats=None):
    """p of the scores s, and the row statistics (2, ..., Lq): max and
    1/sum, recomputed, or taken from ``stats``."""
    if stats is None:
        m = s.amax(-1)
        e = torch.exp(s - m[..., None])
        # reciprocal-multiply: one divide per row, as the TPU kernel
        inv = 1.0 / e.sum(-1)
        stats = torch.stack((m, inv))
    else:
        e = torch.exp(s - stats[0][..., None])
    return e * stats[1][..., None], stats


def attention_reference(q, k, v, key_bias=None, sm_scale=None,
                        compute_dtype=None, return_stats=False):
    """Plain version of ``_attn_kernel``: f32 scores, max and sum; the
    normaliser is a reciprocal-multiply; p is cast to v's dtype before the
    PV product, which accumulates in f32. q (B, H, Lq, D), k/v (B, H, Lk,
    D), key_bias (B, Lk) additive f32 or None. Returns q's dtype, and with
    ``return_stats`` also the row max and 1/sum, (2, B, H, Lq) f32."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    rd = _operand(compute_dtype)
    p, stats = _softmax(_scores(q, k, key_bias, sm_scale, rd))
    out = torch.matmul(rd(p.to(v.dtype)), rd(v)).to(q.dtype)
    return (out, stats) if return_stats else out


def attention_bwd_reference(q, k, v, key_bias, out, g, sm_scale=None,
                            compute_dtype=None, stats=None):
    """Plain version of ``_attn_bwd_kernel``: the softmax recomputed (no
    logsumexp saved, as on the TPU) or, with ``stats``, rebuilt from the
    forward's row max and 1/sum (2, B, H, Lq); p cast to v's dtype before
    dv = p^T g; delta = rowsum(g * out) in f32; ds = p (dp - delta) in f32;
    d(key_bias) sums ds over heads and queries; ds * scale cast to q's
    dtype before dq = ds k and dk = ds^T q. Returns (dq in q's dtype, dk,
    dv in k's and v's dtype, d(key_bias) (B, Lk) f32, or None without a
    key bias)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    rd = _operand(compute_dtype)
    p, _ = _softmax(_scores(q, k, key_bias, sm_scale, rd), stats)
    dv = torch.matmul(rd(p.to(v.dtype)).transpose(-1, -2), rd(g))
    dp = torch.matmul(rd(g), rd(v).transpose(-1, -2))
    delta = (g.float() * out.float()).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    db = None if key_bias is None else ds.sum((1, 2)).to(key_bias.dtype)
    dsc = rd((ds * sm_scale).to(q.dtype))
    dq = torch.matmul(dsc, rd(k)).to(q.dtype)
    dk = torch.matmul(dsc.transpose(-1, -2), rd(q))
    return dq, dk.to(k.dtype), dv.to(v.dtype), db


class _PlainAttention(torch.autograd.Function):
    """The forward saves the row statistics; the backward rebuilds p from
    them, as the kernels do."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, sm_scale):
        out, stats = attention_reference(q, k, v, key_bias, sm_scale,
                                         compute_dtype=BF16,
                                         return_stats=True)
        ctx.save_for_backward(q, k, v, key_bias, out, stats)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_bias, out, stats = ctx.saved_tensors
        dq, dk, dv, db = attention_bwd_reference(
            q, k, v, key_bias, out, g, ctx.sm_scale, compute_dtype=BF16,
            stats=stats)
        return dq, dk, dv, db, None


def fused_attention(q, k, v, key_bias=None, sm_scale=None):
    """q (B, H, Lq, D); k, v (B, H, Lk, D); key_bias optional (B, Lk)
    additive f32. Returns (B, H, Lq, D) in q.dtype; differentiable."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _PlainAttention.apply(q, k, v, key_bias, sm_scale)
