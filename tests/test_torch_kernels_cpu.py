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

from hoigen_tpu_torch.ops.attention import attention_bwd, \
    attention_bwd_reference, attention_reference, fused_attention
from hoigen_tpu_torch.ops.fused_resnet import fused_bottleneck_chain
from hoigen_tpu_torch.ops.pallas_cache import cache_logits_reference, \
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


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2 ** -6)])
def test_bottleneck_chain_plain_matches_pallas_interpret(dtype, tol):
    """K2 (ops/fused_resnet.py::_chain_kernel): 2 chained blocks on a
    13 x 10 plane. 13 rows are not a multiple of the row tile (8), so the
    TPU kernel's clamped halo windows and its edge-row masking both run;
    the plain version zero-pads the whole plane instead. Nonzero BN biases
    make a wrongly activated SAME padding visible. Tolerances are relative
    to the output's scale: f32, 1e-4 for the reordered f32 sums of three
    chained products per block; bf16 (m1, m2 and each block's output
    rounded to bf16 at the same points on both sides), two bf16 ulps
    (2**-6), for roundings that an f32 summation order can flip."""
    rng = np.random.default_rng(2)
    b, h, w, c, m = 2, 13, 10, 128, 32
    x = np.maximum(rng.normal(size=(b, h, w, c)), 0).astype(np.float32)
    blocks = _chain_blocks(rng, c, m, 2)
    want = np.asarray(j_fused_bottleneck_chain(
        jnp.asarray(x, getattr(jnp, dtype)), _to(blocks, "jax"),
        interpret=True), np.float32)
    got = fused_bottleneck_chain(_t(x, getattr(torch, dtype)),
                                 _to(blocks, "torch"))
    assert got.shape == (b, h, w, c) and got.dtype == getattr(torch, dtype)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol * scale,
                               rtol=tol)


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


@pytest.mark.parametrize("c", [117, 236])
def test_cache_logits_padded_operands_match_pallas_interpret(c):
    """K3 at class counts that are not a multiple of 8: the 117-verb HICO
    configuration and V-COCO's 236 interactions. The kernel's operands
    (``kernel_operands``: bf16 W, L padded with zero columns and s with
    ones to a multiple of 8) through the plain version, cut back to C
    columns, against the Pallas kernel in interpret mode on the unpadded
    operands, bf16 on both sides; 1e-4 as above."""
    rng = np.random.default_rng(12)
    n, d, r = 70, 128, 2 * c
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(r, d)).astype(np.float32) * 0.1
    b = -np.ones(r, np.float32)
    l = (rng.random((r, c)) < 0.05).astype(np.float32)
    s = l.sum(0) + 1.0
    want = np.asarray(j_cache_forward(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jnp.asarray(l),
        jnp.asarray(s), interpret=True, compute_dtype=jnp.bfloat16))
    w16, lp, sp = kernel_operands(_t(w), _t(l), _t(s))
    lc = -(-c // 8) * 8
    assert lp.shape == (r, lc) and lp.dtype == torch.bfloat16
    assert sp.shape == (lc,) and not lp[:, c:].any()
    got = cache_logits_reference(_t(x), w16.float(), _t(b), lp.float(), sp,
                                 torch.bfloat16)
    np.testing.assert_allclose(got[:, :c].numpy(), want, atol=1e-4)


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
              fused_cache_logits.launches, attention_bwd.launches)
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
            fused_cache_logits.launches, attention_bwd.launches) == before


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
