"""Fused chain of stride-1 frozen-BN ResNet bottlenecks (NHWC, inference).

Port of ``hoigen_tpu/ops/fused_resnet.py``. On a CUDA tensor
:func:`fused_bottleneck_chain` launches the hand-written Hopper kernel
``csrc/fused_resnet.cu`` (two blocks, C = 256, M = 64: the DETR-R50 layer1
tail); on a CPU tensor it runs :func:`bottleneck_chain_reference`, the
plain PyTorch version of the TPU kernel ``_chain_kernel`` with the same
rounding points. ``models/detr/resnet.py`` calls it for ``fused_tail``.
"""
import ctypes

import torch
import torch.nn.functional as F

from . import _build, _weights


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


def fused_bottleneck_chain(x, blocks):
    """x (B, H, W, C) NHWC; blocks: K bottleneck param dicts (conv1/conv2/
    conv3 with OIHW 'w' and folded 'scale'/'bias'), stride 1, no
    downsample. Returns the K blocks' chained output in x's dtype.

    CUDA tensors need bf16 x, K = 2, C = 256 and M = 64; anything else
    raises."""
    if not x.is_cuda:
        return bottleneck_chain_reference(x, blocks)
    b, h, w, c = x.shape
    m = blocks[0]["conv1"]["w"].shape[0]
    if x.dtype != torch.bfloat16 or len(blocks) != 2 or c != 256 or m != 64:
        raise ValueError(
            "fused_bottleneck_chain: the CUDA kernel takes bf16 input, 2 "
            f"blocks, C=256 and M=64; got {x.dtype}, {len(blocks)} blocks, "
            f"C={c}, M={m}")
    x = x.contiguous()
    # the kernel's weight layouts, made at the first call and reused while
    # the block's parameters are unchanged (copies, not views: a view of
    # conv1's weight would keep the cache entry's key alive)
    tensors = [t for bp in blocks for t in _weights.prepared(
        "chain", [c[k] for c in bp.values() for k in ("w", "scale", "bias")],
        lambda bp=bp: [t.clone() if t._is_view() else t
                       for t in _prep(bp, torch.bfloat16)])]
    for t in tensors:
        if not t.is_cuda:
            raise ValueError("fused_bottleneck_chain: block params must lie "
                             "on the CUDA device")
    ptrs = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
    out = torch.empty_like(x)
    fn = _build.function("fused_resnet", "bottleneck_chain_forward",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                         + [ctypes.c_void_p])
    _build.check(fn(x.data_ptr(), out.data_ptr(), ptrs, b, h, w, c, m,
                    torch.cuda.current_stream(x.device).cuda_stream),
                 "fused_resnet")
    fused_bottleneck_chain.launches += 1
    return out


fused_bottleneck_chain.launches = 0
