"""A chain of stride-1 frozen-BN ResNet bottlenecks (NHWC, inference) in
plain PyTorch, with the rounding points of the hand-written kernel: the
products accumulate in f32, the epilogues run in f32, m1 and m2 are
rounded to x's dtype, the 3x3 reads zeros outside the image."""
import torch
import torch.nn.functional as F


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
    """x (B, H, W, C) NHWC; blocks: bottleneck param dicts (OIHW 'w' and
    folded 'scale'/'bias'). The chained output in x's dtype."""
    return bottleneck_chain_reference(x, blocks)
