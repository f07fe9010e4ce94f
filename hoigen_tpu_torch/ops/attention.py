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

Layout. The kernels read q, k, v, out and the incoming gradient through
their strides, so a (B, H, L, D) view of a (B, L, H, D) buffer, as the CLIP
tower passes its projections, is read in place. The outputs come back in
the layout of the input they belong to (:func:`_layout_like`): out and dq
like q, dk like k, dv like v. The caller's reshape back to (B, L, H * D)
is then free, and so is autograd's reshape in the backward.

Head dims. The kernels take any head dim, as ``fused_attention`` does:
one up to 64 runs at 32 or 64 with zero columns, and one above 64 at the
next multiple of 64 on the source's wide kernels, whose blocks each own a
64-column slice of the output (``csrc/attention.cu``).

Saved statistics. Where a gradient will be asked for, the forward also
returns each query row's softmax max and 1/sum, (2, B, H, Lq) f32, and the
backward reads them instead of recomputing them (the TPU kernel saves
none; on the card the recompute is a whole extra sweep over the keys).
"""
import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from . import _build


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


def _layout_like(t):
    """True when t (B, H, L, D) is a transposed view of a contiguous (B, L,
    H, D) buffer: the outputs that belong to it are then made in that
    layout too."""
    return (t.dim() == 4 and not t.is_contiguous()
            and t.transpose(1, 2).is_contiguous())


def _empty(shape, like, dtype=None):
    """An uninitialised (B, H, L, D) tensor of ``shape``, in ``like``'s
    layout (:func:`_layout_like`)."""
    dtype = like.dtype if dtype is None else dtype
    if _layout_like(like):
        b, h, l, d = shape
        return torch.empty((b, l, h, d), dtype=dtype,
                           device=like.device).transpose(1, 2)
    return torch.empty(shape, dtype=dtype, device=like.device)


def _as_layout(t, like):
    """t's values in ``like``'s layout (a copy only where they differ)."""
    if _layout_like(like) and not _layout_like(t):
        return _empty(t.shape, like, t.dtype).copy_(t)
    return t


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
    if key_bias is not None and (key_bias.shape != (b, lk)
                                 or not key_bias.is_cuda):
        raise ValueError(f"{name}: key_bias must be a CUDA ({b}, {lk}) "
                         f"tensor, got {tuple(key_bias.shape)}")


def _head_dim(d):
    """The head dim the kernels run a head dim ``d`` at: 32 or 64 up to
    64, else the next multiple of 64 (the wide kernels)."""
    return 32 if d <= 32 else 64 * -(-d // 64)


def _pad_heads(*tensors):
    """Each (B, H, L, D) tensor zero-padded along D to :func:`_head_dim`.
    Exact for both kernels: zero columns of q and k add nothing to the
    scores, and those of v, out and the incoming gradient give zero
    columns of out, dq, dk and dv, which :func:`_unpad` drops."""
    d = tensors[0].shape[-1]
    return [F.pad(t, (0, _head_dim(d) - d)) for t in tensors]


def _unpad(t, like):
    """The first D columns of the padded result t, in ``like``'s shape and
    layout (:func:`_layout_like`)."""
    return _empty(like.shape, like, t.dtype).copy_(t[..., :like.shape[-1]])


def _readable(t):
    """Whether the kernels can read or write t through its strides: D of
    stride 1, and every row start 16-byte aligned (the cp.async copies)."""
    item = t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s * item % 16 == 0 for s in t.stride()[:3]))


def _operands(name, *tensors):
    """Each tensor as the kernels read it: itself where its strides do,
    else a contiguous copy (the same kernel runs on either). Raises where
    even the copy is not 16-byte aligned."""
    out = []
    for t in tensors:
        if not _readable(t):
            t = t.contiguous()
            if not _readable(t):
                raise ValueError(f"{name}: inputs must be 16-byte aligned")
        out.append(t)
    return out


def _strides(*tensors):
    """The B, H and L strides of each tensor, as the launchers' int64
    array."""
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _ptr(t):
    return None if t is None else t.data_ptr()


# the forward's key tile (csrc/attention.cu kBK) and the H100's SM count
_BK = 64
_H100_SMS = 132
# dynamic shared memory a block may use on an H100
_SMEM_LIMIT = 232448


@functools.lru_cache(maxsize=None)
def _attn_plan(b, h, lq, lk, d, dtype):
    """K1's launch: ``(bq, stages, smem_bytes, grid)``. bq, the query rows
    of a block (16 a warp), is 64 where the grid of 64-row blocks still
    fills the H100's 132 SMs once, else 32; stages,
    the depth of the ring of 64-key tiles of K and V, is 2 for f32 operands
    (so that two blocks fit an SM's shared memory) and 3 for bf16
    (``tools/sweep_attention.py`` times every choice on the card).
    smem_bytes is the block's dynamic shared memory as ``FwdSmem`` in the
    source computes it: the staged q tile, or in f32 the K and V tiles
    converted to bf16 (rows of D + 8) if larger, then each stage's K and V
    tiles as staged (rows padded to D + 4 in f32, D + 8 in bf16) and 64
    bias values. grid is (query tiles, heads, batch). Lk does not change
    it. A head dim above 64 takes the wide kernel, which has no ring and
    static shared memory: (64, 0, 0, (query tiles x column slices, heads,
    batch))."""
    del lk
    if d > 64:
        return 64, 0, 0, (-(-lq // 64) * (d // 64), h, b)
    f32 = dtype == torch.float32
    item = 4 if f32 else 2
    row = d + 4 if f32 else d + 8
    conv = 2 * _BK * (d + 8) * 2 if f32 else 0
    bq = 64 if -(-lq // 64) * h * b >= _H100_SMS else 32
    stages = 2 if f32 else 3
    smem = max(bq * row * item, conv) + stages * (2 * _BK * row * item
                                                  + _BK * 4)
    return bq, stages, smem, (-(-lq // bq), h, b)


@functools.cache
def _fwd_launcher():
    return _build.function("attention", "attention_forward",
                           [ctypes.c_void_p] * 6
                           + [ctypes.POINTER(ctypes.c_longlong)]
                           + [ctypes.c_int] * 8
                           + [ctypes.c_float, ctypes.c_void_p])


@functools.cache
def _bwd_launcher():
    return _build.function("attention", "attention_backward",
                           [ctypes.c_void_p] * 13
                           + [ctypes.POINTER(ctypes.c_longlong)]
                           + [ctypes.c_int] * 6
                           + [ctypes.c_float, ctypes.c_void_p])


def attention_forward(q, k, v, key_bias=None, sm_scale=None,
                      return_stats=False, plan=None):
    """K1 on CUDA tensors (bf16 or f32 q/k/v, any head dim, run at
    :func:`_head_dim`'s with zero columns (:func:`_pad_heads`); f32
    operands are rounded to bf16 for the products), the plain version on
    CPU tensors. The output is in q's layout (:func:`_layout_like`); with
    ``return_stats`` the row max and 1/sum, (2, B, H, Lq) f32, come with
    it. ``plan`` overrides :func:`_attn_plan`'s (bq, stages). No
    gradient: :func:`fused_attention` is the differentiable entry
    point."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if not q.is_cuda:
        out, stats = attention_reference(q, k, v, key_bias, sm_scale,
                                         return_stats=True)
        out = _as_layout(out, q)
        return (out, stats) if return_stats else out
    _check("attention_forward", q, k, v, key_bias)
    if _head_dim(q.shape[-1]) != q.shape[-1]:
        out, stats = attention_forward(*_pad_heads(q, k, v), key_bias,
                                       sm_scale, True, plan)
        out = _unpad(out, q)
        return (out, stats) if return_stats else out
    b, h, lq, d = q.shape
    lk = k.shape[2]
    out = _empty(q.shape, q)
    q, k, v = _operands("attention_forward", q, k, v)
    if key_bias is not None:
        key_bias = key_bias.float().contiguous()
    stats = torch.empty((2, b, h, lq), dtype=torch.float32,
                        device=q.device) if return_stats else None
    bq, stages = plan or _attn_plan(b, h, lq, lk, d, q.dtype)[:2]
    _build.check(_fwd_launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_bias),
        out.data_ptr(), _ptr(stats), _strides(q, k, v, out), b, h, lq, lk,
        d, int(q.dtype == torch.float32), bq, stages, float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream),
        "attention_forward")
    fused_attention.launches += 1
    return (out, stats) if return_stats else out


def attention_bwd(q, k, v, key_bias, out, g, sm_scale=None,
                  bias_grad=True, stats=None):
    """(dq, dk, dv, d(key_bias)): K4 on CUDA tensors, the plain version on
    CPU tensors. ``stats`` are the forward's row max and 1/sum
    (``attention_forward(..., return_stats=True)``); K4 needs them, the
    plain version recomputes them where they are None. dq, dk and dv come
    in the layouts of q, k and v. d(key_bias) is None when there is no key
    bias or ``bias_grad`` is False."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if not q.is_cuda:
        dq, dk, dv, db = attention_bwd_reference(q, k, v, key_bias, out, g,
                                                 sm_scale, stats=stats)
        return (_as_layout(dq, q), _as_layout(dk, k), _as_layout(dv, v),
                db if bias_grad else None)
    _check("attention_bwd", q, k, v, key_bias)
    if _head_dim(q.shape[-1]) != q.shape[-1] and out.shape == q.shape \
            and g.shape == q.shape:
        grads = attention_bwd(*_pad_heads(q, k, v), key_bias,
                              *_pad_heads(out, g), sm_scale, bias_grad,
                              stats)
        return (*(_unpad(t, like) for t, like in zip(grads, (q, k, v))),
                grads[3])
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if out.shape != q.shape or g.shape != q.shape or out.dtype != q.dtype \
            or g.dtype != q.dtype:
        raise ValueError(f"attention_bwd: out {tuple(out.shape)} "
                         f"{out.dtype} and g {tuple(g.shape)} {g.dtype} must "
                         f"match q {tuple(q.shape)} {q.dtype}")
    if stats is None or stats.shape != (2, b, h, lq) \
            or stats.dtype != torch.float32 or not stats.is_contiguous():
        raise ValueError("attention_bwd: K4 reads the forward's row "
                         "statistics: pass stats=, the (2, B, H, Lq) f32 "
                         "of attention_forward(..., return_stats=True)")
    dq, dk, dv = (_empty(t.shape, t) for t in (q, k, v))
    q, k, v, out, g = _operands("attention_bwd", q, k, v, out, g)
    if key_bias is not None:
        key_bias = key_bias.float().contiguous()
    db = part = None
    if key_bias is not None and bias_grad:
        db = torch.empty((b, lk), dtype=torch.float32, device=q.device)
        part = torch.empty((b, h, lk), dtype=torch.float32, device=q.device)
    # delta = rowsum(g * out), from the first launch to the second
    delta = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    _build.check(_bwd_launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_bias),
        out.data_ptr(), g.data_ptr(), stats.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(db), _ptr(part),
        _strides(q, k, v, out, g, dq, dk, dv), b, h, lq, lk, d,
        int(q.dtype == torch.float32), float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream),
        "attention_backward")
    attention_bwd.launches += 1
    return dq, dk, dv, db


class _FusedAttention(torch.autograd.Function):
    """K1 forward, saving the row statistics where a gradient will be
    asked for; K4 backward on them (on the CPU, their plain versions)."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, sm_scale):
        if any(ctx.needs_input_grad[:4]):
            out, stats = attention_forward(q, k, v, key_bias, sm_scale,
                                           return_stats=True)
        else:
            out, stats = attention_forward(q, k, v, key_bias, sm_scale), None
        ctx.save_for_backward(q, k, v, key_bias, out, stats)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_bias, out, stats = ctx.saved_tensors
        dq, dk, dv, db = attention_bwd(q, k, v, key_bias, out, g,
                                       ctx.sm_scale,
                                       bias_grad=ctx.needs_input_grad[3],
                                       stats=stats)
        return dq, dk, dv, db, None


def fused_attention(q, k, v, key_bias=None, sm_scale=None):
    """q (B, H, Lq, D); k, v (B, H, Lk, D), any strides with D contiguous;
    key_bias optional (B, Lk) additive f32 (-1e9 for padded keys). Returns
    (B, H, Lq, D) in q.dtype and q's layout.

    Differentiable in q, k, v and key_bias. CUDA tensors need q/k/v of one
    dtype, bf16 or f32 (any D); anything else raises.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _FusedAttention.apply(q, k, v, key_bias, sm_scale)


fused_attention.launches = 0        # K1 calls
attention_bwd.launches = 0          # K4 calls
