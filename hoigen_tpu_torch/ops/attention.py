"""Fused multi-head attention forward: ``softmax(q k^T * scale + bias) v``.

Port of ``hoigen_tpu/ops/attention.py`` (forward). On a CUDA tensor
:func:`fused_attention` launches the hand-written Hopper kernel
``csrc/attention.cu``; on a CPU tensor it runs :func:`attention_reference`,
the plain PyTorch version of the TPU kernel ``_attn_kernel`` with the same
rounding points. The DETR encoder calls it (``models/detr/model.py``).
"""
import ctypes
import math

import torch

from . import _build


def attention_reference(q, k, v, key_bias=None, sm_scale=None):
    """Plain version of ``_attn_kernel``: f32 scores, max and sum; the
    normaliser is a reciprocal-multiply; p is cast to v's dtype before the
    PV product, which accumulates in f32. q (B, H, Lq, D), k/v (B, H, Lk,
    D), key_bias (B, Lk) additive f32 or None. Returns q's dtype."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    p = (e * (1.0 / e.sum(-1, keepdim=True))).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def fused_attention(q, k, v, key_bias=None, sm_scale=None):
    """q (B, H, Lq, D); k, v (B, H, Lk, D); key_bias optional (B, Lk)
    additive f32 (-1e9 for padded keys). Returns (B, H, Lq, D) in q.dtype.

    CUDA tensors need bf16 q/k/v with D in {32, 64}; anything else raises.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if not q.is_cuda:
        return attention_reference(q, k, v, key_bias, sm_scale)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or not t.is_cuda:
            raise ValueError(f"fused_attention: {name} must be a bf16 CUDA "
                             f"tensor, got {t.dtype} on {t.device}")
    if k.shape != (b, h, lk, d) or v.shape != k.shape:
        raise ValueError(f"fused_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in (32, 64):
        raise ValueError(f"fused_attention: head dim {d} not in (32, 64)")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    bias_ptr = None
    if key_bias is not None:
        if key_bias.shape != (b, lk) or not key_bias.is_cuda:
            raise ValueError(f"fused_attention: key_bias must be a CUDA "
                             f"({b}, {lk}) tensor, got {tuple(key_bias.shape)}")
        key_bias = key_bias.float().contiguous()
        bias_ptr = key_bias.data_ptr()
    out = torch.empty_like(q)
    fn = _build.function("attention", "attention_forward",
                         [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                         + [ctypes.c_float, ctypes.c_void_p])
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr,
                    out.data_ptr(), b, h, lq, lk, d, float(sm_scale),
                    torch.cuda.current_stream(q.device).cuda_stream),
                 "attention")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
