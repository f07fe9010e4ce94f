"""The CLIP ModifiedResNet image tower of the RN checkpoints (port of
``hoigen_tpu/models/clip/resnet.py``; the reference's ModifiedResNet and
AttentionPool2d, CLIP_models_adapter_prior2.py:205-420).

- A 3-conv stem (the first of stride 2) and a 2x2 average pool.
- Anti-aliased striding: every conv has stride 1; an average pool of the
  stride follows the 3x3 conv and prefixes the downsample's 1x1 conv.
- The last pool is a QKV attention over [mean token; spatial tokens] with
  a learned positional embedding whose spatial part is sliced [:H, :W] at
  forward time (not interpolated). It returns the global feature and the
  local feature map.

BatchNorms come folded into per-channel (scale, bias) from the converter:
nothing in this tower trains (the reference puts no adapter in it). The
convolutions run NCHW in the input's dtype, as the JAX package's run in
theirs; the public layout is the JAX package's: images NCHW in, the local
map channels-last (B, H, W, D) out. No kernel of the port runs here: the
JAX tower is plain XLA too (its convolutions are not the fused chain).
"""
import math

import torch
import torch.nn.functional as F


def _conv_bn(x, p, stride=1, padding=0, relu=True):
    dt = x.dtype
    y = F.conv2d(x, p["w"].to(dt), stride=stride, padding=padding)
    y = y * p["scale"].to(dt)[:, None, None] + p["bias"].to(dt)[:, None, None]
    return torch.relu(y) if relu else y


def _avg_pool(x, k):
    """nn.AvgPool2d(k): window k, stride k, no padding (floor mode)."""
    return x if k <= 1 else F.avg_pool2d(x, k)


def _bottleneck(x, p, stride):
    """Bottleneck.forward: the stride as an average pool after conv2; the
    downsample an average pool and a 1x1 conv."""
    out = _conv_bn(x, p["conv1"])
    out = _conv_bn(out, p["conv2"], padding=1)
    out = _avg_pool(out, stride)
    out = _conv_bn(out, p["conv3"], relu=False)
    identity = _conv_bn(_avg_pool(x, stride), p["down"], relu=False) \
        if "down" in p else x
    return torch.relu(out + identity)


def attention_pool(p, x, num_heads):
    """AttentionPool2d.forward. x: (B, H, W, E) -> (global (B, D), local
    (B, H, W, D))."""
    b, h, w, e = x.shape
    tokens = x.reshape(b, h * w, e)
    t = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
    s = round(math.isqrt(p["pos"].shape[0] - 1))
    spatial = p["pos"][1:].reshape(s, s, e)[:h, :w].reshape(h * w, e)
    t = t + torch.cat([p["pos"][:1], spatial], dim=0)[None].to(t.dtype)

    def proj(name):
        return t @ p[name + "_w"].to(t.dtype).T + p[name + "_b"].to(t.dtype)

    hd = e // num_heads
    lq = t.shape[1]
    q, k, v = (proj(n).reshape(b, lq, num_heads, hd) for n in "qkv")
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    attn = torch.softmax(scores.float(), dim=-1).to(t.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, lq, e)
    out = out @ p["c_w"].to(t.dtype).T + p["c_b"].to(t.dtype)
    return out[:, 0], out[:, 1:].reshape(b, h, w, -1)


def modified_resnet_forward(params, images, num_heads):
    """images: (B, 3, H, W) -> (global (B, embed), local (B, H/32, W/32,
    embed)): stem, layer1..4, attention pool."""
    x = _conv_bn(images, params["stem1"], stride=2, padding=1)
    x = _conv_bn(x, params["stem2"], padding=1)
    x = _conv_bn(x, params["stem3"], padding=1)
    x = _avg_pool(x, 2)
    for li, blocks in enumerate(params["layers"]):
        for bi, bp in enumerate(blocks):
            x = _bottleneck(x, bp, 2 if li > 0 and bi == 0 else 1)
    return attention_pool(params["attnpool"], x.permute(0, 2, 3, 1),
                          num_heads)


# ------------------------------------------------------------------ init --
def _conv_bn_init(gen, out_c, in_c, k):
    w = torch.randn((out_c, in_c, k, k), generator=gen) \
        * math.sqrt(2.0 / (in_c * k * k))
    return {"w": w, "scale": torch.ones(out_c), "bias": torch.zeros(out_c)}


def init_modified_resnet_params(gen, layers, width, embed_dim, spacial_dim):
    """Random parameters from the torch.Generator ``gen``, with the JAX
    package's distributions (the reference's initialize_parameters for the
    RN branch: attention-pool projections of std embed^-0.5, bn3's weight
    zero, so its folded scale is 0)."""
    p = {"stem1": _conv_bn_init(gen, width // 2, 3, 3),
         "stem2": _conv_bn_init(gen, width // 2, width // 2, 3),
         "stem3": _conv_bn_init(gen, width, width // 2, 3),
         "layers": []}
    in_c = width
    for li, n_blocks in enumerate(layers):
        planes = width * 2 ** li
        out_c = planes * 4
        blocks = []
        for bi in range(n_blocks):
            blk = {"conv1": _conv_bn_init(gen, planes, in_c, 1),
                   "conv2": _conv_bn_init(gen, planes, planes, 3),
                   "conv3": _conv_bn_init(gen, out_c, planes, 1)}
            blk["conv3"]["scale"] = torch.zeros(out_c)
            if (li > 0 and bi == 0) or in_c != out_c:
                blk["down"] = _conv_bn_init(gen, out_c, in_c, 1)
            blocks.append(blk)
            in_c = out_c
        p["layers"].append(blocks)
    e = width * 32
    std = e ** -0.5

    def normal(*shape):
        return torch.randn(shape, generator=gen) * std
    p["attnpool"] = {
        "pos": normal(spacial_dim ** 2 + 1, e),
        "q_w": normal(e, e), "q_b": torch.zeros(e),
        "k_w": normal(e, e), "k_b": torch.zeros(e),
        "v_w": normal(e, e), "v_b": torch.zeros(e),
        "c_w": normal(embed_dim, e), "c_b": torch.zeros(embed_dim),
    }
    return p
