"""Fused chain of stride-1 frozen-BN ResNet bottlenecks (NHWC, inference).

Port of ``hoigen_tpu/ops/fused_resnet.py``. On a CUDA tensor
:func:`fused_bottleneck_chain` launches the hand-written Hopper kernels of
``csrc/fused_resnet.cu`` for any chain the TPU kernel ``_chain_kernel``
takes (K >= 1 blocks, any C and M), by one of two routes that
:func:`_chain_plan` chooses:

- ``fused``: two blocks with C = 256 and M = 64 (the DETR-R50 layer1 tail,
  the eval step's main path), one launch of a TMA + ``wgmma`` kernel that
  runs both blocks on a tile of pixels with its halo in shared memory;
- ``layered``: every other chain, three launches of an implicit-GEMM
  kernel a block (1x1, 3x3, 1x1 with the residual), m1, m2 and each
  block's output passing through device memory in bf16.

Widths that are not multiples of 64 are zero-padded first
(:func:`pad_chain`: exact, since a padded channel of m1, m2 or the output
is relu(0 * 0 + 0) = 0) and the output sliced back. On a CPU tensor it runs
:func:`bottleneck_chain_reference`, the plain PyTorch version of
``_chain_kernel`` with the same rounding points. ``models/detr/resnet.py``
calls it for ``fused_tail``.
"""
import collections
import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build, _weights

# channel step of both routes (64 bf16 = one 128-byte row of a tile)
_STEP = 64
# the fused route's widths and tiles (csrc/fused_resnet.cu instantiates
# these), and the weight ring depths its launcher accepts
_FUSED_CM = (256, 64)
_FUSED_TILES = ((8, 16), (16, 8))
_FUSED_STAGES = range(2, 9)
# the layered route's block of threads: 128 pixels x 64 channels, a ring
# of 3 stages of A (128 x 64) and B (64 x 64) bf16 tiles
_LAYER_ROWS = 128
_LAYER_SMEM = 1024 + 3 * (_LAYER_ROWS * 128 + _STEP * 128)
# dynamic shared memory a block may use on an H100
_SMEM_LIMIT = 232448

ChainPlan = collections.namedtuple(
    "ChainPlan", "route c m tile stages smem threads grid")


def _ceil(a, b):
    return -(-a // b)


def _fused_smem(th, tw, stages):
    """Shared memory of a fused block of threads, as ``Geo::smem`` in the
    source: x's (TH + 4) x (TW + 4) box in four 64-channel chunks, m1 on
    that region, m2 on the (TH + 2) x (TW + 2) one (each rounded up to the
    swizzle's 1024-byte atom), both blocks' scales and biases in f32,
    the weight ring of 8 KB tiles with a barrier and a release count a
    stage, a barrier for each x chunk, and 1024 B to align it all."""
    r0, r1 = (th + 4) * (tw + 4), (th + 2) * (tw + 2)

    def atoms(n):
        return _ceil(n, 1024) * 1024
    c, m = _FUSED_CM
    return (1024 + 5 * atoms(r0 * 128) + atoms(r1 * 128)
            + 2 * (2 * c + 4 * m) * 4 + stages * (8192 + 12) + 32)


@functools.lru_cache(maxsize=None)
def _chain_plan(b, h, w, c, m, k, tile=None, stages=None):
    """The launch of a chain of ``k`` blocks (widths ``c`` and ``m``) on a
    (b, h, w) plane: ``ChainPlan(route, c, m, tile, stages, smem, threads,
    grid)`` with c and m padded to the channel step.

    ``fused`` where the padded chain is two blocks of (256, 64): tile (TH,
    TW) of output pixels, 8 x 16 or 16 x 8 (whichever needs fewer blocks
    of threads on the plane; both fill 64-row wgmma tiles with little
    waste, and a larger one would not fit x's box in shared memory), a
    ring of ``stages`` weight tiles (4 unless asked;
    ``tools/sweep_fused_resnet.py`` times every choice on the card), one
    warpgroup for each 64 pixels of the (TH + 4) x (TW + 4) region, grid
    (W tiles, H tiles, B).
    ``layered`` otherwise: 128-pixel blocks of 256 threads; grid is that of
    its widest launch (pixel blocks, max(c, m) / 64)."""
    cp, mp = _ceil(c, _STEP) * _STEP, _ceil(m, _STEP) * _STEP
    if k == 2 and (cp, mp) == _FUSED_CM:
        if tile is None:
            tile = min(_FUSED_TILES,
                       key=lambda t: _ceil(h, t[0]) * _ceil(w, t[1]))
        stages = 4 if stages is None else stages
        th, tw = tile
        if tile not in _FUSED_TILES or stages not in _FUSED_STAGES:
            raise ValueError(f"_chain_plan: tile {tile} stages {stages}")
        smem = _fused_smem(th, tw, stages)
        if smem > _SMEM_LIMIT:
            raise ValueError(f"_chain_plan: tile {tile} with {stages} stages "
                             f"needs {smem} B of shared memory")
        threads = _ceil((th + 4) * (tw + 4), 64) * 128
        return ChainPlan("fused", cp, mp, tile, stages, smem, threads,
                         (_ceil(w, tw), _ceil(h, th), b))
    return ChainPlan("layered", cp, mp, (_LAYER_ROWS,), 3, _LAYER_SMEM, 256,
                     (_ceil(b * h * w, _LAYER_ROWS), max(cp, mp) // _STEP))


def _prep(bp, dt):
    """Block params (OIHW weights, folded BN) -> the product layouts, each
    weight as (out, in): w1 (M, C), w2 (M, 9M) with in = tap * M + channel
    and tap = dy * 3 + dx, w3 (C, M); scales and biases in f32."""
    m = bp["conv1"]["w"].shape[0]
    f32 = torch.float32
    return (bp["conv1"]["w"][:, :, 0, 0].to(dt).contiguous(),
            bp["conv1"]["scale"].to(f32).contiguous(),
            bp["conv1"]["bias"].to(f32).contiguous(),
            bp["conv2"]["w"].permute(0, 2, 3, 1).reshape(m, 9 * m)
            .to(dt).contiguous(),
            bp["conv2"]["scale"].to(f32).contiguous(),
            bp["conv2"]["bias"].to(f32).contiguous(),
            bp["conv3"]["w"][:, :, 0, 0].to(dt).contiguous(),
            bp["conv3"]["scale"].to(f32).contiguous(),
            bp["conv3"]["bias"].to(f32).contiguous())


def _pad_block(bp, c, m):
    """One block's parameters zero-padded to C = ``c`` and M = ``m``."""
    sizes = {"conv1": (m, c), "conv2": (m, m), "conv3": (c, m)}

    def conv(name, p):
        o, i = sizes[name]
        wo, wi = p["w"].shape[:2]
        return {"w": F.pad(p["w"], (0, 0, 0, 0, 0, i - wi, 0, o - wo)),
                "scale": F.pad(p["scale"], (0, o - wo)),
                "bias": F.pad(p["bias"], (0, o - wo))}
    return {n: conv(n, p) for n, p in bp.items()}


def pad_chain(x, blocks, c, m):
    """x and the blocks' parameters zero-padded to C = ``c`` and M = ``m``
    channels: x's channels, W1's and W3's rows and columns, W2's input and
    output channels, and every scale and bias. The padded chain's output
    sliced to x's channels is the original chain's: each padded channel of
    m1, m2 and the output is relu(0 * 0 + 0) = 0 and meets only zero
    weights."""
    if (c, m) == (x.shape[-1], blocks[0]["conv1"]["w"].shape[0]):
        return x, blocks
    return (F.pad(x, (0, c - x.shape[-1])),
            [_pad_block(bp, c, m) for bp in blocks])


def bottleneck_chain_reference(x, blocks):
    """Plain version of ``_chain_kernel`` over the whole plane: products
    accumulate in f32, epilogues run in f32, m1 and m2 are rounded to x's
    dtype, and the 3x3 reads zeros outside the image (SAME padding)."""
    _, h, w, _ = x.shape
    dt = x.dtype
    for bp in blocks:
        w1, s1, b1, w2, s2, b2, w3, s3, b3 = _prep(bp, dt)
        m1 = torch.relu(torch.matmul(x.float(), w1.float().t()) * s1 + b1)
        mp = F.pad(m1.to(dt), (0, 0, 1, 1, 1, 1))
        patches = torch.cat([mp[:, dy:dy + h, dx:dx + w]
                             for dy in range(3) for dx in range(3)], dim=-1)
        m2 = torch.relu(torch.matmul(patches.float(), w2.float().t()) * s2
                        + b2).to(dt)
        y = torch.matmul(m2.float(), w3.float().t()) * s3 + b3 + x.float()
        x = torch.relu(y).to(dt)
    return x


@functools.cache
def _fused_launcher():
    return _build.function("fused_resnet", "bottleneck_chain_fused",
                           [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                           + [ctypes.c_void_p])


@functools.cache
def _layer_launcher():
    return _build.function("fused_resnet", "bottleneck_conv_forward",
                           [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                           + [ctypes.c_void_p])


def _check(x, blocks):
    """Shapes and dtypes the CUDA kernels take; raises on anything else."""
    c = x.shape[-1]
    if x.dtype != torch.bfloat16 or x.dim() != 4 or not blocks:
        raise ValueError("fused_bottleneck_chain: the CUDA kernels take a "
                         "bf16 (B, H, W, C) input and at least one block; "
                         f"got {x.dtype} {tuple(x.shape)}, {len(blocks)} "
                         "blocks")
    m = blocks[0]["conv1"]["w"].shape[0]
    want = {"conv1": (m, c, 1, 1), "conv2": (m, m, 3, 3),
            "conv3": (c, m, 1, 1)}
    for bp in blocks:
        for n, shape in want.items():
            p = bp[n]
            if tuple(p["w"].shape) != shape or not all(
                    t.is_cuda for t in p.values()):
                raise ValueError(
                    f"fused_bottleneck_chain: {n} weight "
                    f"{tuple(p['w'].shape)} on {p['w'].device}, expected a "
                    f"CUDA {shape} (stride-1 blocks of one width)")
    return m


def fused_bottleneck_chain(x, blocks, plan=None):
    """x (B, H, W, C) NHWC; blocks: K bottleneck param dicts (conv1/conv2/
    conv3 with OIHW 'w' and folded 'scale'/'bias'), stride 1, no
    downsample. Returns the K blocks' chained output in x's dtype.

    CUDA tensors need bf16 x and K >= 1 blocks of one width; anything else
    raises. ``plan`` overrides :func:`_chain_plan`'s (for the sweep)."""
    if not x.is_cuda:
        return bottleneck_chain_reference(x, blocks)
    m = _check(x, blocks)
    b, h, w, c = x.shape
    p = plan or _chain_plan(b, h, w, c, m, len(blocks))
    if p.route == "fused" and (len(blocks), p.c, p.m) != (2, *_FUSED_CM):
        raise ValueError(f"fused_bottleneck_chain: {p} for {len(blocks)} "
                         f"blocks of C={c}, M={m}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    # the kernels' weight layouts, made at the first call and reused while
    # the blocks' parameters are unchanged (copies, not views: a view of
    # conv1's weight would keep the cache entry's key alive)
    padded = (p.c, p.m) != (c, m)
    weights = [_weights.prepared(
        ("chain", p.c, p.m),
        [t[k] for t in bp.values() for k in ("w", "scale", "bias")],
        lambda bp=bp: [t.clone() if t._is_view() else t for t in _prep(
            _pad_block(bp, p.c, p.m) if padded else bp, torch.bfloat16)])
        for bp in blocks]
    if p.c != c:
        x = F.pad(x, (0, p.c - c))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if p.route == "fused":
        ptrs = (ctypes.c_void_p * 18)(*(t.data_ptr() for ws in weights
                                        for t in ws))
        out = torch.empty_like(x)
        _build.check(_fused_launcher()(
            x.data_ptr(), out.data_ptr(), ptrs, b, h, w, p.tile[0],
            p.tile[1], p.stages, stream), "fused_resnet")
    else:
        npix = b * h * w
        m1, m2 = (torch.empty((npix, p.m), dtype=x.dtype, device=x.device)
                  for _ in range(2))
        out = x
        for w1, s1, b1, w2, s2, b2, w3, s3, b3 in weights:
            y = torch.empty_like(x)
            for args in ((out, w1, s1, b1, None, m1, p.c, p.m, 1),
                         (m1, w2, s2, b2, None, m2, p.m, p.m, 9),
                         (m2, w3, s3, b3, out, y, p.m, p.c, 1)):
                a, wt, s, bias, res, o, cin, n, taps = args
                _build.check(_layer_launcher()(
                    a.data_ptr(), wt.data_ptr(), s.data_ptr(),
                    bias.data_ptr(), None if res is None else res.data_ptr(),
                    o.data_ptr(), npix, h, w, cin, n, taps, stream),
                    "fused_resnet")
            out = y
    fused_bottleneck_chain.launches += 1
    return out if p.c == c else out[..., :c].contiguous()


fused_bottleneck_chain.launches = 0
