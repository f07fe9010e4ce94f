"""ResNet-50 backbone with frozen BatchNorm, NHWC (port of the NHWC path of
``hoigen_tpu/models/detr/resnet.py``).

torchvision resnet50 v1.5 (stride in the 3x3 conv) as DETR uses it, with
frozen BN folded into a per-channel (scale, bias) after each conv.
Activations are NHWC at the public functions and weights OIHW, as in the
JAX package. The unfused convs go to ``torch.nn.functional.conv2d`` on a
channels-last view (cuDNN on the card), as the JAX package leaves them to
XLA; ``fused_tail`` routes a layer's stride-1 tail blocks through the fused
bottleneck-chain kernel (``ops/fused_resnet.py``); ``remat`` recomputes
each block in the backward. The JAX package's NCHW route
(``DETRConfig.nchw_backbone``, a layout experiment that computes the same
function) is not ported.
"""
import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...ops.fused_resnet import fused_bottleneck_chain
from ...ops._weights import cast

LAYER_BLOCKS = (3, 4, 6, 3)
BN_EPS = 1e-5


def _conv_nhwc(x, w_oihw, stride=1, padding=0):
    # an NHWC tensor permuted to NCHW is a channels-last view: conv2d keeps
    # the layout, and permuting back is free
    y = F.conv2d(x.permute(0, 3, 1, 2), cast(w_oihw, x.dtype), stride=stride,
                 padding=padding)
    return y.permute(0, 2, 3, 1)


def _conv_bn_nhwc(x, p, stride=1, padding=0, relu=True):
    y = _conv_nhwc(x, p["w"], stride, padding)
    # the epilogue runs in the activation dtype, as in the JAX package
    y = y * cast(p["scale"], x.dtype) + cast(p["bias"], x.dtype)
    return torch.relu(y) if relu else y


def _max_pool_3x3_s2_nhwc(x):
    # max_pool2d pads with -inf, as reduce_window's init value
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, padding=1)
    return y.permute(0, 2, 3, 1)


def _bottleneck_nhwc(x, p, stride):
    out = _conv_bn_nhwc(x, p["conv1"])
    out = _conv_bn_nhwc(out, p["conv2"], stride=stride, padding=1)
    out = _conv_bn_nhwc(out, p["conv3"], relu=False)
    identity = _conv_bn_nhwc(x, p["down"], stride=stride, relu=False) \
        if "down" in p else x
    return torch.relu(out + identity)


def _checkpointed(x, p, stride):
    return checkpoint(_bottleneck_nhwc, x, p, stride, use_reentrant=False)


def resnet50_forward_nhwc(params, x, fused_tail=(), remat=False):
    """x: (B, H, W, 3) -> C5 (B, H/32, W/32, 2048).

    ``fused_tail``: residual-layer indices whose stride-1 tail blocks run
    through :func:`fused_bottleneck_chain` (inference only). ``remat``:
    each bottleneck under ``torch.utils.checkpoint``, so that the backward
    recomputes a block's activations instead of keeping them (the offline
    DETR finetune's memory, as ``jax.checkpoint`` in the JAX package); it
    takes effect only where a gradient is recorded."""
    x = _conv_bn_nhwc(x, params["stem"], stride=2, padding=3)
    x = _max_pool_3x3_s2_nhwc(x)
    block = _checkpointed if remat and torch.is_grad_enabled() \
        else _bottleneck_nhwc
    for li, blocks in enumerate(params["layers"]):
        stride = 1 if li == 0 else 2
        if li in fused_tail and len(blocks) > 1 and not remat:
            x = _bottleneck_nhwc(x, blocks[0], stride)
            x = fused_bottleneck_chain(x.contiguous(), blocks[1:])
        else:
            for bi, bp in enumerate(blocks):
                x = block(x, bp, stride if bi == 0 else 1)
    return x


def _conv_bn_init(gen, out_c, in_c, k):
    fan = in_c * k * k
    w = torch.randn((out_c, in_c, k, k), generator=gen) * np.sqrt(2.0 / fan)
    return {"w": w, "scale": torch.ones(out_c), "bias": torch.zeros(out_c)}


def init_resnet50_params(gen):
    """Random ResNet-50 parameters (He-normal convs, identity BN) drawn from
    the torch.Generator ``gen``, on the CPU, in the JAX package's layout."""
    widths = (256, 512, 1024, 2048)
    params = {"stem": _conv_bn_init(gen, 64, 3, 7), "layers": []}
    in_c = 64
    for n_blocks, out_c in zip(LAYER_BLOCKS, widths):
        mid = out_c // 4
        blocks = []
        for bi in range(n_blocks):
            blk = {"conv1": _conv_bn_init(gen, mid, in_c, 1),
                   "conv2": _conv_bn_init(gen, mid, mid, 3),
                   "conv3": _conv_bn_init(gen, out_c, mid, 1)}
            if bi == 0:
                blk["down"] = _conv_bn_init(gen, out_c, in_c, 1)
            blocks.append(blk)
            in_c = out_c
        params["layers"].append(blocks)
    return params


def fold_bn(conv_w, bn_w, bn_b, bn_mean, bn_var, eps=BN_EPS):
    """Frozen BN (y = (x-mean)/sqrt(var+eps)*w + b) -> post-conv scale/bias.
    Takes numpy arrays or tensors; returns f32 tensors. The arithmetic is
    numpy's float32, as in the JAX package (``torch.sqrt`` on the CPU can
    round an element the other way)."""
    def a(x):
        return x.detach().cpu().float().numpy() \
            if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)
    scale = a(bn_w) / np.sqrt(a(bn_var) + eps)
    return {"w": torch.as_tensor(a(conv_w)), "scale": torch.as_tensor(scale),
            "bias": torch.as_tensor(a(bn_b) - a(bn_mean) * scale)}
