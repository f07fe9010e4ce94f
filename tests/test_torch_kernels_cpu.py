"""The plain PyTorch version of each ported kernel against the JAX package's
Pallas kernel in interpret mode, on the CPU.

On a CPU tensor each wrapper of hoigen_tpu_torch.ops runs its kernel's
plain version, which repeats the TPU kernel's rounding points; the CUDA
kernels themselves are checked against these plain versions on the card by
chip_smoke.py. Inputs are made with numpy from a seed and fed to both sides
as float32 (or bf16 where stated).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from hoigen_tpu.ops.attention import _pallas_attention_bwd as j_attention_bwd
from hoigen_tpu.ops.attention import fused_attention as j_fused_attention
from hoigen_tpu.ops.fused_resnet import \
    fused_bottleneck_chain as j_fused_bottleneck_chain
from hoigen_tpu.ops.pallas_cache import _fused_forward as j_cache_forward
from hoigen_tpu.ops.pallas_cache import \
    fused_cache_logits as j_fused_cache_logits

from hoigen_tpu_torch.engine import cuda_graph
from hoigen_tpu_torch.models.detr import resnet as t_resnet
from hoigen_tpu_torch.ops.attention import _attn_plan, _layout_like, \
    _head_dim, _pad_heads, _unpad, attention_bwd, attention_bwd_reference, \
    attention_forward, attention_reference, fused_attention
from hoigen_tpu_torch.ops.conv_epilogue import conv_epilogue, \
    conv_epilogue_reference
from hoigen_tpu_torch.ops.fused_resnet import _chain_plan, \
    bottleneck_chain_reference, fused_bottleneck_chain, pad_chain
from hoigen_tpu_torch.ops.pallas_cache import _gemm_plan, \
    fused_cache_logits, kernel_operands


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a, np.float32)).to(dtype)


# ------------------------------------------------------------ K1 attention
@pytest.mark.parametrize("lq,with_bias", [(70, True), (70, False),
                                          (36, True)],
                         ids=["bias", "no-bias", "lq-ne-lk"])
def test_attention_plain_matches_pallas_interpret(lq, with_bias):
    """K1 (ops/attention.py::_attn_kernel) at the shapes of the JAX
    package's own parity test: 70 keys (not a multiple of 128, so the
    kernel pads Lk with -1e9), 20% of keys masked. 2e-5 is that test's
    tolerance: both sides are f32 with a reciprocal-multiply softmax."""
    rng = np.random.default_rng(0)
    b, h, lk, d = 2, 3, 70, 32
    q = rng.normal(size=(b, h, lq, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, h, lk, d)).astype(np.float32)
            for _ in range(2))
    bias = np.where(rng.random((b, lk)) < 0.2, -1e9, 0.0).astype(np.float32) \
        if with_bias else None
    want = np.asarray(j_fused_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        key_bias=None if bias is None else jnp.asarray(bias),
        interpret=True))
    got = fused_attention(_t(q), _t(k), _t(v),
                          key_bias=None if bias is None else _t(bias))
    assert got.dtype == torch.float32 and got.shape == (b, h, lq, d)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)


def test_attention_plain_keeps_the_bf16_rounding_points():
    """bf16 q/k/v: p is rounded to bf16 before the PV product and the
    output is bf16, as in the TPU kernel. 1e-2 absolute on outputs of
    magnitude <= 1 is one bf16 ulp at 1, for the rare p that rounds the
    other way under another summation order."""
    rng = np.random.default_rng(3)
    b, h, l, d = 1, 2, 40, 32
    q, k, v = (rng.normal(size=(b, h, l, d)).astype(np.float32)
               for _ in range(3))
    bias = np.where(rng.random((b, l)) < 0.2, -1e9, 0.0).astype(np.float32)
    bf = jnp.bfloat16
    want = np.asarray(j_fused_attention(
        jnp.asarray(q, bf), jnp.asarray(k, bf), jnp.asarray(v, bf),
        key_bias=jnp.asarray(bias), interpret=True), np.float32)
    got = fused_attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                          _t(v, torch.bfloat16), key_bias=_t(bias))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2)


# ------------------------------------------------- K4 attention backward
def _bwd_inputs(lq, with_bias, seed=4):
    rng = np.random.default_rng(seed)
    b, h, lk, d = 2, 3, 70, 32
    q = rng.normal(size=(b, h, lq, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, h, lk, d)).astype(np.float32)
            for _ in range(2))
    g = rng.normal(size=(b, h, lq, d)).astype(np.float32)
    # -1e9 on 20% of the keys, small values elsewhere, so that the bias
    # gradient of the unmasked keys is not trivially zero
    bias = np.where(rng.random((b, lk)) < 0.2, -1e9,
                    rng.normal(size=(b, lk)) * 0.5).astype(np.float32) \
        if with_bias else None
    return q, k, v, g, bias


BWD_CASES = pytest.mark.parametrize(
    "lq,with_bias", [(70, True), (70, False), (36, True)],
    ids=["bias", "no-bias", "lq-ne-lk"])


@BWD_CASES
def test_attention_bwd_plain_matches_pallas_interpret(lq, with_bias):
    """K4 (ops/attention.py::_attn_bwd_kernel): dq, dk, dv and d(key_bias)
    of the plain version against the Pallas backward in interpret mode,
    from the same forward output. 70 keys (not a multiple of 128, so the
    TPU kernel pads Lk with -1e9), Lq != Lk in one case. 2e-5 relative to
    each gradient's scale: both sides f32, sums over keys, queries and
    heads in another order."""
    q, k, v, g, bias = _bwd_inputs(lq, with_bias)
    scale = 1.0 / float(np.sqrt(q.shape[-1]))   # a Python float: no x64
    jb = np.zeros((q.shape[0], k.shape[2]), np.float32) if bias is None \
        else bias
    out = np.asarray(j_fused_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        key_bias=jnp.asarray(jb), interpret=True))
    want = j_attention_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(jb), jnp.asarray(out), jnp.asarray(g),
                           scale, True, 384)
    got = attention_bwd_reference(_t(q), _t(k), _t(v),
                                  None if bias is None else _t(bias),
                                  _t(out), _t(g))
    assert got[3] is None if bias is None else got[3].shape == jb.shape
    for name, a, w in zip(("dq", "dk", "dv", "db"), got, want):
        if a is None:
            continue
        w = np.asarray(w)
        assert a.dtype == torch.float32 and a.shape == w.shape, name
        np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                   atol=2e-5 * np.abs(w).max(), err_msg=name)


@BWD_CASES
def test_attention_function_grads_match_autograd(lq, with_bias):
    """The autograd.Function around K1/K4 (on the CPU, their plain
    versions) against torch autograd through the plain forward: the
    gradients of q, k, v and the key bias, each in its own slot, and no
    bias gradient without a bias. 2e-5 of each gradient's scale."""
    q, k, v, g, bias = _bwd_inputs(lq, with_bias, seed=6)

    def grads(fn):
        ins = [_t(a).requires_grad_() for a in (q, k, v)]
        tb = None if bias is None else _t(bias).requires_grad_()
        out = fn(*ins, tb)
        out.backward(_t(g))
        return [a.grad for a in ins] + [None if tb is None else tb.grad]

    got = grads(fused_attention)
    want = grads(attention_reference)
    for name, a, w in zip(("dq", "dk", "dv", "db"), got, want):
        if w is None:
            assert a is None
            continue
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=0,
                                   atol=2e-5 * w.abs().max().item(),
                                   err_msg=name)
    # no bias gradient is computed where none is asked for
    _, _, _, db = attention_bwd(_t(q), _t(k), _t(v),
                                None if bias is None else _t(bias),
                                fused_attention(_t(q), _t(k), _t(v)), _t(g),
                                bias_grad=False)
    assert db is None


def test_attention_bwd_plain_rounds_at_the_kernel_points():
    """compute_dtype=bf16 (the card's check): f32 inputs round to bf16 for
    every product, as K4 does; the result differs from the f32 one by
    about a bf16 ulp of scale, no more."""
    q, k, v, g, bias = _bwd_inputs(70, True, seed=8)
    args = [_t(a) for a in (q, k, v)] + [_t(bias)]
    out = attention_reference(*args)
    f32 = attention_bwd_reference(*args, out, _t(g))
    b16 = attention_bwd_reference(*args, out, _t(g),
                                  compute_dtype=torch.bfloat16)
    for a, w in zip(b16, f32):
        assert a.dtype == torch.float32
        err = (a - w).abs().max().item() / w.abs().max().item()
        assert 1e-5 < err < 2 ** -5


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no-bias"])
def test_attention_bwd_plain_on_saved_stats(with_bias):
    """K4 reads the forward's row max and 1/sum instead of recomputing
    them. The plain backward on those saved statistics
    (``attention_reference(..., return_stats=True)``) against the
    recomputing one: 1e-6 of each gradient's scale (both rebuild p from
    the same f32 max and 1/sum, so they agree to the bit here). Both
    against the Pallas backward in interpret mode at Lq 36 != Lk 70,
    within that test's 2e-5 of scale."""
    q, k, v, g, bias = _bwd_inputs(36, with_bias, seed=9)
    scale = 1.0 / float(np.sqrt(q.shape[-1]))
    tb = None if bias is None else _t(bias)
    out, stats = attention_reference(_t(q), _t(k), _t(v), tb,
                                     return_stats=True)
    b, h, lq, _ = q.shape
    assert stats.shape == (2, b, h, lq) and stats.dtype == torch.float32
    saved = attention_bwd_reference(_t(q), _t(k), _t(v), tb, out, _t(g),
                                    stats=stats)
    recomputed = attention_bwd_reference(_t(q), _t(k), _t(v), tb, out, _t(g))
    jb = np.zeros((b, k.shape[2]), np.float32) if bias is None else bias
    want = j_attention_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(jb), jnp.asarray(out.numpy()),
                           jnp.asarray(g), scale, True, 384)
    for name, a, r, w in zip(("dq", "dk", "dv", "db"), saved, recomputed,
                             want):
        if a is None:
            assert r is None and bias is None
            continue
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=0,
                                   atol=1e-6 * np.abs(w).max(), err_msg=name)
        for x in (a, r):
            np.testing.assert_allclose(x.numpy(), w, rtol=0,
                                       atol=2e-5 * np.abs(w).max(),
                                       err_msg=name)


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no-bias"])
def test_attention_keeps_the_callers_layout(with_bias):
    """q, k and v as (B, H, L, D) views of (B, L, H, D) buffers, as the
    CLIP tower passes them: the output and dq, dk and dv come back as the
    same kind of view (``_layout_like``), and the values and the gradients
    through autograd agree with those of contiguous copies within 1e-6 (on
    the card the kernels read both through strides and must agree bit for
    bit; CPU matmuls may take another path for a strided operand)."""
    rng = np.random.default_rng(10)
    b, l, h, d = 2, 37, 3, 32
    q, k, v, g = (rng.normal(size=(b, l, h, d)).astype(np.float32)
                  for _ in range(4))
    bias = _t(rng.normal(size=(b, l)) * 0.5) if with_bias else None
    views = [_t(x).transpose(1, 2) for x in (q, k, v, g)]
    contig = [t.contiguous() for t in views]
    assert all(_layout_like(t) for t in views)
    assert not any(_layout_like(t) for t in contig)

    out_v, st_v = attention_forward(*views[:3], bias, return_stats=True)
    out_c, st_c = attention_forward(*contig[:3], bias, return_stats=True)
    assert out_v.stride() == views[0].stride() and out_c.is_contiguous()
    np.testing.assert_allclose(out_v.numpy(), out_c.numpy(), atol=1e-6)
    np.testing.assert_allclose(st_v.numpy(), st_c.numpy(), atol=1e-6)
    got = attention_bwd(*views[:3], bias, out_v, views[3], stats=st_v)
    want = attention_bwd(*contig[:3], bias, out_c, contig[3], stats=st_c)
    for a, w, like in zip(got[:3], want[:3], views):
        assert a.stride() == like.stride() and w.is_contiguous()
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=1e-6)

    def grads(make):
        ins = [_t(x).requires_grad_() for x in (q, k, v)]
        tb = None if bias is None else bias.clone().requires_grad_()
        out = fused_attention(*(make(t) for t in ins), tb)
        out.backward(make(_t(g)))
        return out, [t.grad for t in ins] + [None if tb is None else tb.grad]

    out_v, g_v = grads(lambda t: t.transpose(1, 2))
    out_c, g_c = grads(lambda t: t.transpose(1, 2).contiguous())
    assert out_v.stride() == views[0].stride()
    np.testing.assert_allclose(out_v.detach().numpy(),
                               out_c.detach().numpy(), atol=1e-6)
    for a, w in zip(g_v, g_c):
        if w is None:
            assert a is None
            continue
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=1e-6)


def _check_head_padding(d, d_run, with_bias, layout):
    """The plain forward and backward on operands zero-padded from head
    dim ``d`` to ``d_run`` (_pad_heads) at the caller's scale 1/sqrt(d),
    unpadded (_unpad), against the same on the originals: out and all
    four gradients, in the inputs' layout. f32 on both sides; only zero
    terms join the sums, so 1e-6 of each output's scale."""
    rng = np.random.default_rng(8)
    b, h, lq, lk = 2, 3, 20, 27

    def make(l):
        t = _t(rng.normal(size=(b, l, h, d)))
        return t.transpose(1, 2) if layout == "blhd-views" \
            else t.transpose(1, 2).contiguous()
    q, g = make(lq), make(lq)
    k, v = make(lk), make(lk)
    bias = _t(0.5 * rng.normal(size=(b, lk))) if with_bias else None
    sm = 1.0 / np.sqrt(d)
    out = attention_reference(q, k, v, bias)
    padded = _pad_heads(q, k, v)
    assert padded[0].shape == (b, h, lq, d_run)
    got = _unpad(attention_reference(*padded, bias, sm_scale=sm), q)
    assert got.shape == q.shape and got.stride() == q.stride()
    want = attention_bwd_reference(q, k, v, bias, out, g)
    grads = attention_bwd_reference(*padded, bias, *_pad_heads(out, g),
                                    sm_scale=sm)
    got_grads = [_unpad(t, like) for t, like in zip(grads, (q, k, v))]
    for t, like in zip(got_grads, (q, k, v)):
        assert t.stride() == like.stride()
    for gv, wv in zip([got, *got_grads, grads[3]], [out, *want]):
        if wv is None:
            assert gv is None
            continue
        scale = wv.abs().max().item()
        np.testing.assert_allclose(gv.numpy(), wv.numpy(),
                                   atol=1e-6 * scale)


@pytest.mark.parametrize("layout", ["contiguous", "blhd-views"])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no-bias"])
def test_attention_head_padding_is_exact(with_bias, layout):
    """Head dims other than 32 and 64 (here 48) run on the card through
    the kernels at 64 with zero columns (_pad_heads, then _unpad)."""
    _check_head_padding(48, 64, with_bias, layout)


@pytest.mark.parametrize("d,d_run", [(80, 128), (128, 128), (200, 256)])
@pytest.mark.parametrize("layout", ["contiguous", "blhd-views"])
def test_attention_wide_head_padding_is_exact(d, d_run, layout):
    """Head dims above 64 run on the card through the wide kernels at the
    next multiple of 64, with zero columns."""
    assert _head_dim(d) == d_run
    _check_head_padding(d, d_run, True, layout)


@pytest.mark.parametrize("d", [80, 128, 256, 320])
@pytest.mark.parametrize("lq", [197, 64, 1])
def test_attn_plan_of_wide_heads_covers_every_slice(d, lq):
    """A head dim above 64 launches one block for each 64-query tile and
    64-column slice of the padded head dim, and no ring."""
    bq, stages, smem, grid = _attn_plan(4, 8, lq, 197, _head_dim(d),
                                        torch.float32)
    assert (bq, stages, smem) == (64, 0, 0)
    assert grid == (-(-lq // 64) * (_head_dim(d) // 64), 8, 4)
    assert [_head_dim(x) for x in (1, 32, 33, 64, 65, 128, 129)] == \
        [32, 32, 64, 64, 128, 128, 192]


@pytest.mark.parametrize("b,h,lq,lk,d,dtype",
                         [(4, 12, 197, 197, 64, torch.float32),
                          (4, 8, 1050, 1050, 32, torch.bfloat16),
                          (2, 3, 70, 150, 32, torch.bfloat16)],
                         ids=["clip-f32", "detr-bf16", "cross-bf16"])
def test_attn_plan_covers_the_queries_and_fits(b, h, lq, lk, d, dtype):
    """K1's launch (``_attn_plan``): the grid covers Lq with no empty
    query tile, and every head and image; the block's shared memory (the
    q tile and the ring of K and V tiles) fits the 232,448 bytes a block
    may have, and at f32 two blocks fit an SM's 233,472; the CLIP
    training shape gets at least one block for each of the 132 SMs."""
    bq, stages, smem, grid = _attn_plan(b, h, lq, lk, d, dtype)
    assert bq in (32, 64) and stages in (2, 3)
    assert grid[0] * bq >= lq and (grid[0] - 1) * bq < lq
    assert grid[1:] == (h, b)
    item = 4 if dtype == torch.float32 else 2
    assert stages * 64 * 2 * d * item < smem <= 232448
    if dtype == torch.float32:
        assert 2 * (smem + 1024) <= 233472
    if (h, lq, d) == (12, 197, 64):
        assert grid[0] * grid[1] * grid[2] >= 132


# ------------------------------------------------- K2 fused bottleneck chain
def _chain_blocks(rng, c, m, k):
    def conv(o, i, kk, std):
        return {"w": rng.normal(size=(o, i, kk, kk)).astype(np.float32) * std,
                "scale": (1 + 0.1 * rng.normal(size=o)).astype(np.float32),
                "bias": (0.1 * rng.normal(size=o)).astype(np.float32)}
    return [{"conv1": conv(m, c, 1, 0.2), "conv2": conv(m, m, 3, 0.1),
             "conv3": conv(c, m, 1, 0.2)} for _ in range(k)]


def _to(blocks, lib):
    conv = (lambda a: jnp.asarray(a)) if lib == "jax" else torch.as_tensor
    return [{n: {f: conv(v) for f, v in cp.items()} for n, cp in bp.items()}
            for bp in blocks]


# (dtype, tolerance, blocks K, C, M, plane (H, W)); the first two cases
# keep the ids they had when the test took one chain
CHAIN_CASES = [
    pytest.param("float32", 1e-4, 2, 128, 32, (13, 10), id="float32-0.0001"),
    pytest.param("bfloat16", 2 ** -6, 2, 128, 32, (13, 10),
                 id="bfloat16-0.015625"),
    pytest.param("float32", 1e-4, 1, 64, 16, (9, 7), id="k1-c64-m16-f32"),
    pytest.param("bfloat16", 2 ** -6, 1, 64, 16, (9, 8),
                 id="k1-c64-m16-bf16"),
    pytest.param("float32", 1e-4, 3, 64, 16, (11, 6), id="k3-c64-m16-f32"),
    pytest.param("bfloat16", 2 ** -6, 3, 64, 16, (11, 6),
                 id="k3-c64-m16-bf16"),
    pytest.param("float32", 1e-4, 3, 128, 32, (5, 12),
                 id="k3-c128-m32-short-f32"),
]


@pytest.mark.parametrize("dtype,tol,k,c,m,hw", CHAIN_CASES)
def test_bottleneck_chain_plain_matches_pallas_interpret(dtype, tol, k, c, m,
                                                         hw):
    """K2 (ops/fused_resnet.py::_chain_kernel): chains of 1 to 3 blocks at
    (C, M) of (128, 32) and (64, 16). 13, 9 and 11 rows are not multiples
    of the row tile (8), so the TPU kernel's clamped halo windows and its
    edge-row masking both run; 5 rows are fewer than one DMA window (8 +
    2K), which the TPU kernel pads. The plain version zero-pads the whole
    plane instead. Nonzero BN biases make a wrongly activated SAME padding
    visible. In bf16 the TPU kernel bitcasts pairs of columns, so W is
    even there. Tolerances are relative to the output's scale: f32, 1e-4 for
    the reordered f32 sums of three chained products per block; bf16 (m1,
    m2 and each block's output rounded to bf16 at the same points on both
    sides), two bf16 ulps (2**-6), for roundings that an f32 summation
    order can flip."""
    rng = np.random.default_rng(2)
    b, (h, w) = 2, hw
    x = np.maximum(rng.normal(size=(b, h, w, c)), 0).astype(np.float32)
    blocks = _chain_blocks(rng, c, m, k)
    want = np.asarray(j_fused_bottleneck_chain(
        jnp.asarray(x, getattr(jnp, dtype)), _to(blocks, "jax"),
        interpret=True), np.float32)
    got = fused_bottleneck_chain(_t(x, getattr(torch, dtype)),
                                 _to(blocks, "torch"))
    assert got.shape == (b, h, w, c) and got.dtype == getattr(torch, dtype)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol * scale,
                               rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,c,m", [(2, 200, 50), (3, 96, 24)],
                         ids=["to-fused-widths", "to-layered-widths"])
def test_bottleneck_chain_padding_is_exact(k, c, m, dtype):
    """The CUDA wrapper zero-pads C and M to the kernels' channel step
    (pad_chain, to the widths _chain_plan gives) and slices the output:
    the plain version on the padded x and weights, sliced, equals it on
    the originals. f32: the products gain only zero terms, so 1e-6 of the
    scale covers another summation order; bf16: bit for bit, checked at
    the same rounding points."""
    rng = np.random.default_rng(5)
    x = _t(np.maximum(rng.normal(size=(2, 7, 9, c)), 0),
           getattr(torch, dtype))
    blocks = _to(_chain_blocks(rng, c, m, k), "torch")
    plan = _chain_plan(2, 7, 9, c, m, k)
    assert (plan.c, plan.m) == (-(-c // 64) * 64, -(-m // 64) * 64)
    xp, bp = pad_chain(x, blocks, plan.c, plan.m)
    assert xp.shape == (2, 7, 9, plan.c)
    assert bp[0]["conv2"]["w"].shape == (plan.m, plan.m, 3, 3)
    got = bottleneck_chain_reference(xp, bp)
    want = bottleneck_chain_reference(x, blocks)
    assert not got[..., c:].any()
    scale = want.float().abs().max().item()
    np.testing.assert_allclose(got[..., :c].float().numpy(),
                               want.float().numpy(),
                               atol=1e-6 * scale if dtype == "float32" else 0)


@pytest.mark.parametrize("b,h,w,c,m,k,route", [
    (4, 200, 336, 256, 64, 2, "fused"),      # layer1 tail, the main path
    (4, 100, 168, 512, 128, 3, "layered"),   # layer2 tail
    (4, 50, 84, 1024, 256, 5, "layered"),    # layer3 tail
    (4, 25, 42, 2048, 512, 2, "layered"),    # layer4 tail
    (2, 37, 45, 256, 64, 2, "fused"),        # ragged plane
    (2, 37, 45, 200, 50, 2, "fused"),        # padded widths
    (1, 3, 250, 256, 64, 2, "fused"),        # a plane of one tile's rows
    (2, 29, 19, 96, 24, 3, "layered")],
    ids=["layer1", "layer2", "layer3", "layer4", "ragged", "padded",
         "wide-strip", "padded-layered"])
def test_chain_plan_covers_the_plane_and_fits(b, h, w, c, m, k, route):
    """K2's launch (_chain_plan, as csrc/fused_resnet.cu computes its
    shared memory): the route, a grid that covers the plane once, and
    shared memory within the H100's 232,448 B a block, for the four
    ResNet-50 layer tails at the 800x1344 bucket's planes and for ragged
    and padded shapes; the fused route at every tile and ring depth it
    takes."""
    plan = _chain_plan(b, h, w, c, m, k)
    assert plan.route == route
    assert plan.c % 64 == 0 and plan.m % 64 == 0
    assert c <= plan.c < c + 64 and m <= plan.m < m + 64
    assert plan.smem <= 232448
    if route == "layered":
        rows = plan.tile[0]
        assert plan.grid[0] * rows >= b * h * w > (plan.grid[0] - 1) * rows
        assert plan.grid[1] * 64 == max(plan.c, plan.m)
        return
    th, tw = plan.tile
    assert plan.grid[2] == b
    assert plan.grid[0] * tw >= w > (plan.grid[0] - 1) * tw
    assert plan.grid[1] * th >= h > (plan.grid[1] - 1) * th
    # one warpgroup for each 64 pixels of the (TH+4) x (TW+4) region
    assert plan.threads == -(-(th + 4) * (tw + 4) // 64) * 128
    if (h, w) == (200, 336):
        assert plan.tile == (8, 16) and plan.grid == (21, 25, 4)
    for tile in ((8, 16), (16, 8)):
        for stages in range(2, 9):
            try:
                alt = _chain_plan(b, h, w, c, m, k, tile, stages)
            except ValueError:
                assert stages > 5
                continue
            assert alt.smem <= 232448 and alt.tile == tile
            # x's box in four chunks, m1 on it, m2 on the smaller region
            r0, r1 = (tile[0] + 4) * (tile[1] + 4), (tile[0] + 2) * (
                tile[1] + 2)
            assert alt.smem >= 5 * r0 * 128 + r1 * 128 + stages * 8192


# ------------------------------------------------- frozen-BN epilogue
def _epilogue_inputs(seed, c, dtype, shape=(2, 5, 7)):
    """A raw conv output y, the block input x, the downsample's raw
    output yd, and scales and biases drawn so that rounding matters: y of
    a few units, scales about 1 +- 0.3, biases about 0.5 (so a product's
    low bits decide how the bias add rounds)."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dtype)
    y, x, yd = (t(rng.normal(scale=3.0, size=shape + (c,)))
                for _ in range(3))
    sc, sd = (t(1 + 0.3 * rng.normal(size=c)) for _ in range(2))
    bi, bd = (t(0.5 * rng.normal(size=c)) for _ in range(2))
    return y, sc, bi, torch.relu(x), (yd, sd, bd)


def _rounded_at_each_point(y, s, b, identity=None, down=None):
    """The kernel's arithmetic, lane by lane: each product and sum in f32,
    rounded to y's dtype after the multiply, the bias add and the residual
    add, then the ReLU."""
    dt = y.dtype

    def bn(v, s, b):
        return ((v.float() * s.float()).to(dt).float() + b.float()).to(dt)
    out = bn(y, s, b)
    if down is not None:
        identity = bn(*down)
    if identity is not None:
        out = (out.float() + identity.float()).to(dt)
    return torch.relu(out)


EPILOGUE_MODES = ["site", "identity", "down"]


def _mode_args(mode, x, down):
    return {"site": {}, "identity": {"identity": x},
            "down": {"down": down}}[mode]


@pytest.mark.parametrize("mode", EPILOGUE_MODES)
@pytest.mark.parametrize("c", [64, 256, 2048])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_conv_epilogue_plain_equals_the_aten_chain(dtype, c, mode):
    """The epilogue's plain version, the ATen chain (and the wrapper on a
    CPU tensor), in both modes, at a site and at a block end with the block
    input or the downsample, rounds where the kernel rounds: it equals the
    kernel's arithmetic (f32 products and sums, rounded after the
    multiply, the bias add and the residual add) bit for bit."""
    y, s, b, x, down = _epilogue_inputs(10 + c, c, getattr(torch, dtype))
    kw = _mode_args(mode, x, down)
    want = _rounded_at_each_point(y, s, b, **kw)
    got = conv_epilogue_reference(y, s, b, **kw)
    assert got.dtype == y.dtype and got.shape == y.shape
    assert torch.equal(got, want)
    assert torch.equal(conv_epilogue(y, s, b, **kw), want)


def _single_rounding(y, s, b, identity=None, down=None):
    """What a kernel that drops the rounding points would give: the whole
    epilogue in a wider type (f32 for bf16, f64 for f32), rounded once."""
    wide = torch.float64 if y.dtype == torch.float32 else torch.float32
    out = y.to(wide) * s.to(wide) + b.to(wide)
    if down is not None:
        identity = down[0].to(wide) * down[1].to(wide) + down[2].to(wide)
    if identity is not None:
        out = out + identity.to(wide)
    return torch.relu(out.to(y.dtype))


@pytest.mark.parametrize("mode", EPILOGUE_MODES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_conv_epilogue_plain_keeps_every_rounding_point(dtype, mode):
    """On inputs drawn as in the test above, a version that rounds once (as
    an FMA would, or a kernel that leaves out a rounding point) differs
    from the plain version, so the kernel's bit-for-bit check would catch
    such a kernel; the two agree within a few units in the last place of
    the output's scale."""
    dt = getattr(torch, dtype)
    y, s, b, x, down = _epilogue_inputs(20, 256, dt)
    kw = _mode_args(mode, x, down)
    plain = conv_epilogue_reference(y, s, b, **kw)
    once = _single_rounding(y, s, b, **kw)
    assert not torch.equal(plain, once)
    ulp = torch.finfo(dt).eps * plain.float().abs().max().item()
    assert (plain.float() - once.float()).abs().max().item() <= 4 * ulp


def test_conv_epilogue_refuses_a_mixed_block_end():
    """A block end takes the block input or the downsample, not both."""
    y, s, b, x, down = _epilogue_inputs(3, 64, torch.float32)
    with pytest.raises(ValueError):
        conv_epilogue(y, s, b, identity=x, down=down)


def _aten_resnet(params, x):
    """``resnet50_forward_nhwc`` with every epilogue as the ATen chain (no
    fused tail, no remat)."""
    def conv_bn(x, p, stride=1, padding=0, relu=True):
        y = t_resnet._conv_nhwc(x, p["w"], stride, padding)
        y = y * p["scale"].to(y.dtype) + p["bias"].to(y.dtype)
        return torch.relu(y) if relu else y
    x = t_resnet._max_pool_3x3_s2_nhwc(conv_bn(x, params["stem"], 2, 3))
    for li, blocks in enumerate(params["layers"]):
        for bi, p in enumerate(blocks):
            stride = 2 if li > 0 and bi == 0 else 1
            out = conv_bn(x, p["conv1"])
            out = conv_bn(out, p["conv2"], stride, 1)
            out = conv_bn(out, p["conv3"], relu=False)
            identity = conv_bn(x, p["down"], stride, relu=False) \
                if "down" in p else x
            x = torch.relu(out + identity)
    return x


def _varied_resnet(seed):
    """ResNet-50 parameters whose folded BN is not the identity."""
    gen = torch.Generator().manual_seed(seed)
    params = t_resnet.init_resnet50_params(gen)
    convs = [params["stem"]] + [p for blocks in params["layers"]
                                for bp in blocks for p in bp.values()]
    for p in convs:
        n = p["scale"].shape[0]
        p["scale"] = 1 + 0.2 * torch.randn(n, generator=gen)
        p["bias"] = 0.2 * torch.randn(n, generator=gen)
    return params


def test_resnet_epilogues_take_the_aten_chain_where_autograd_records(
        monkeypatch):
    """``resnet50_forward_nhwc`` with parameters that require grad, under
    grad mode (the offline DETR finetune's route), never calls the
    epilogue wrapper: its output and every gradient equal the ATen chain's
    bit for bit. Under ``no_grad`` (the towers of the eval and training
    steps) it calls the wrapper at every epilogue site, 1 + 3 a block
    (49; 43 with layer1's tail fused, as the DETR tower runs on the card),
    and gives the same output bit for bit."""
    from hoigen_tpu_torch.engine.partition import named_leaves
    calls = []

    def counted(*args, **kw):
        calls.append(kw)
        return conv_epilogue(*args, **kw)
    monkeypatch.setattr(t_resnet, "conv_epilogue", counted)
    params = _varied_resnet(7)
    x = torch.relu(torch.randn((1, 64, 64, 3),
                               generator=torch.Generator().manual_seed(8)))
    leaves = [t.requires_grad_() for _, t in named_leaves(params)]
    got = t_resnet.resnet50_forward_nhwc(params, x)
    assert not calls
    want = _aten_resnet(params, x)
    assert torch.equal(got, want)
    for a, b in zip(torch.autograd.grad(got.square().sum(), leaves),
                    torch.autograd.grad(want.square().sum(), leaves)):
        assert torch.equal(a, b)
    with torch.no_grad():
        plain = t_resnet.resnet50_forward_nhwc(params, x)
        assert len(calls) == 49
        assert sum("down" in kw for kw in calls) == 4
        assert sum("identity" in kw for kw in calls) == 12
        assert torch.equal(plain, want)
        calls.clear()
        t_resnet.resnet50_forward_nhwc(params, x, fused_tail=(0,))
        assert len(calls) == 43


# ------------------------------------------------------ K3 cache scoring
def _cache_inputs():
    rng = np.random.default_rng(11)
    n, d, r, c = 70, 128, 256, 384     # N not a multiple of the 256 tile
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(r, d)).astype(np.float32) * 0.1
    b = -np.ones(r, np.float32)
    l = (rng.random((r, c)) < 0.05).astype(np.float32)
    s = l.sum(0) + 1.0
    return x, w, b, l, s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_logits_plain_matches_pallas_interpret(dtype):
    """K3 (ops/pallas_cache.py::_kernel) with compute_dtype f32 and bf16
    on both sides. f32: 1e-4, the JAX package's own tolerance. bf16: the
    operands and phi are rounded to bf16 at the same points on both sides
    and only the f32 summation order differs, so 1e-4 holds too."""
    x, w, b, l, s = _cache_inputs()
    want = np.asarray(j_cache_forward(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jnp.asarray(l),
        jnp.asarray(s), interpret=True, compute_dtype=getattr(jnp, dtype)))
    got = fused_cache_logits(_t(x), _t(w), _t(b), _t(l), _t(s),
                             compute_dtype=getattr(torch, dtype))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("c", [37, 117, 236])
def test_cache_logits_padded_operands_match_pallas_interpret(c):
    """K3 at class counts that are not a multiple of 8: a ragged 37 (with
    R = 150, not a multiple of 8 either), the 117-verb HICO configuration
    and V-COCO's 236 interactions (R = 2C). The kernel's operands
    (``kernel_operands``: bf16 W, L^T padded with zeros to (LC, RP), s
    with ones) through the kernel's two stages in plain PyTorch: phi =
    bf16(X W^T + b) over RP columns, the rows of W past R being zeros as
    TMA fills them, then phi times the stored L^T, divided by s, cut back
    to C columns. Against the Pallas kernel in interpret mode on the
    unpadded operands, bf16 on both sides, within 1e-4. X and W lie on a
    2**-7 grid, so that every f32 sum of both products is exact in any
    order and only the rounding points (phi + b in f32, then bf16) can
    make the two sides differ: with random f32 inputs another summation
    order flips a phi rounding now and then, one bf16 ulp."""
    rng = np.random.default_rng(12)
    n, d, r = 70, 128, 150 if c == 37 else 2 * c
    rp, lc = -(-r // 8) * 8, -(-c // 8) * 8
    x = np.round(np.clip(rng.normal(size=(n, d)) * 0.3, -1, 1) * 128) / 128
    w = np.round(rng.normal(size=(r, d)) * 0.1 * 128) / 128
    b = -np.ones(r, np.float32)
    l = (rng.random((r, c)) < 0.05).astype(np.float32)
    s = l.sum(0) + 1.0
    want = np.asarray(j_cache_forward(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jnp.asarray(l),
        jnp.asarray(s), interpret=True, compute_dtype=jnp.bfloat16))
    w16, lt, sp = kernel_operands(_t(w), _t(l), _t(s))
    assert w16.shape == (r, d) and w16.dtype == torch.bfloat16
    assert lt.shape == (lc, rp) and lt.dtype == torch.bfloat16
    assert not lt[c:].any() and not lt[:, r:].any()
    assert torch.equal(lt[:c, :r], _t(l).t().to(torch.bfloat16))
    assert sp.shape == (lc,) and bool((sp[c:] == 1).all())
    bf = torch.bfloat16
    w_rows = torch.zeros(rp, d)
    w_rows[:r] = w16.float()
    b_pad = torch.zeros(rp)
    b_pad[:r] = _t(b)
    phi = (torch.matmul(_t(x).to(bf).float(), w_rows.t()) + b_pad).to(bf)
    assert not phi[:, r:].any()
    got = torch.matmul(phi.float(), lt.float().t()) / sp
    np.testing.assert_allclose(got[:, :c].numpy(), want, atol=1e-4)


@pytest.mark.parametrize("n,d,r,c", [(1800, 512, 1200, 600),
                                     (1800, 512, 234, 117),
                                     (1800, 512, 472, 236),
                                     (70, 128, 150, 37),
                                     (1800, 1024, 1200, 600)],
                         ids=["eval-c600", "train-c117", "vcoco-c236",
                              "ragged", "d1024"])
def test_gemm_plan_covers_the_output_and_fits(n, d, r, c):
    """The tiles of K3's two launches (``_gemm_plan``): phi (n, RP) from
    X (n, D) and W, then the logits (n, C) from phi and L^T (K = RP). The
    grid covers the output with no empty tile, the block width suits
    wgmma (a multiple of 8, at most 256), the K box is one 128-byte
    swizzled row, the ring's shared memory fits a block's 232,448 bytes,
    and at the eval shape each launch has at least 100 blocks for the
    H100's 132 SMs."""
    rp = -(-r // 8) * 8
    for m, cols, k in ((n, rp, d), (n, c, rp)):
        bm, bn, bk, stages, smem, grid = _gemm_plan(m, cols, k)
        assert grid[0] * bm >= m and (grid[0] - 1) * bm < m
        assert grid[1] * bn >= cols and (grid[1] - 1) * bn < cols
        assert bn % 8 == 0 and 8 <= bn <= 256 and bm == 64
        assert bk * 2 == 128 and 3 <= stages <= 4
        assert stages * (bm + bn) * bk * 2 < smem <= 232448
        if (n, c) == (1800, 600):
            assert grid[0] * grid[1] >= 100


def test_cache_logits_function_grads_match_jax():
    """The autograd.Function around K3: its backward (the JAX package's
    ``_bwd`` as plain f32 products) against jax.grad of the custom_vjp
    ``fused_cache_logits(interpret=True)``, for x (with leading dims), w and
    b, at 117 classes. Both sides f32: 1e-4 of each gradient's scale."""
    rng = np.random.default_rng(13)
    c = 117
    x = rng.normal(size=(2, 35, 64)).astype(np.float32)
    w = rng.normal(size=(2 * c, 64)).astype(np.float32) * 0.1
    b = -np.ones(2 * c, np.float32)
    l = (rng.random((2 * c, c)) < 0.05).astype(np.float32)
    s = l.sum(0) + 1.0
    g = rng.normal(size=(2, 35, c)).astype(np.float32)

    def jloss(x_, w_, b_):
        out = j_fused_cache_logits(x_, w_, b_, jnp.asarray(l),
                                   jnp.asarray(s), True, jnp.float32)
        return jnp.sum(out * g)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    ins = [_t(a).requires_grad_() for a in (x, w, b)]
    lt, st = _t(l).requires_grad_(), _t(s)
    out = fused_cache_logits(*ins, lt, st, compute_dtype=torch.float32)
    out.backward(_t(g))
    assert lt.grad is None
    for name, a, wnt in zip(("dx", "dw", "db"), ins, want):
        wnt = np.asarray(wnt)
        np.testing.assert_allclose(a.grad.numpy(), wnt, rtol=0,
                                   atol=1e-4 * np.abs(wnt).max(),
                                   err_msg=name)


def test_cache_logits_keeps_leading_dims():
    x, w, b, l, s = _cache_inputs()
    x3 = x[:68].reshape(2, 34, -1)
    got = fused_cache_logits(_t(x3), _t(w), _t(b), _t(l), _t(s))
    flat = fused_cache_logits(_t(x[:68]), _t(w), _t(b), _t(l), _t(s))
    assert got.shape == (2, 34, l.shape[1])
    np.testing.assert_array_equal(got.reshape(68, -1).numpy(), flat.numpy())


def test_wrappers_count_no_launch_on_the_cpu():
    """The launch counters count CUDA launches only: the plain versions
    that a CPU tensor takes leave them untouched."""
    before = (fused_attention.launches, fused_bottleneck_chain.launches,
              fused_cache_logits.launches, attention_bwd.launches,
              conv_epilogue.launches)
    assert {fused_attention, attention_bwd, fused_bottleneck_chain,
            fused_cache_logits, conv_epilogue} <= set(cuda_graph.COUNTED)
    y, sc, bi, _, _ = _epilogue_inputs(2, 64, torch.bfloat16)
    conv_epilogue(y, sc, bi)
    x, w, b, l, s = _cache_inputs()
    fused_cache_logits(_t(x), _t(w), _t(b), _t(l), _t(s))
    q = torch.zeros(1, 1, 4, 32, requires_grad=True)
    fused_attention(q, q, q).sum().backward()
    fused_bottleneck_chain(torch.zeros(1, 3, 3, 8), [
        {"conv1": {"w": torch.zeros(2, 8, 1, 1), "scale": torch.ones(2),
                   "bias": torch.zeros(2)},
         "conv2": {"w": torch.zeros(2, 2, 3, 3), "scale": torch.ones(2),
                   "bias": torch.zeros(2)},
         "conv3": {"w": torch.zeros(8, 2, 1, 1), "scale": torch.ones(8),
                   "bias": torch.zeros(8)}}])
    assert (fused_attention.launches, fused_bottleneck_chain.launches,
            fused_cache_logits.launches, attention_bwd.launches,
            conv_epilogue.launches) == before


def test_prepared_weights_are_made_once_and_follow_writes():
    """The kernel-ready weight copies (ops/_weights.py): one copy while the
    source is unchanged, a new one after an in-place write, none where the
    dtype already matches, and no entry left once the source is gone."""
    import gc

    from hoigen_tpu_torch.ops import _weights
    w = torch.arange(6, dtype=torch.float32).reshape(2, 3) / 7
    assert _weights.cast(w, torch.float32) is w
    first = _weights.cast(w, torch.bfloat16)
    assert first.dtype == torch.bfloat16
    assert _weights.cast(w, torch.bfloat16) is first
    np.testing.assert_array_equal(first.float().numpy(),
                                  w.to(torch.bfloat16).float().numpy())
    w.mul_(2)
    second = _weights.cast(w, torch.bfloat16)
    assert second is not first
    np.testing.assert_array_equal(second.float().numpy(),
                                  w.to(torch.bfloat16).float().numpy())
    n = len(_weights._copies)
    del w, first, second
    gc.collect()
    assert len(_weights._copies) == n - 1
