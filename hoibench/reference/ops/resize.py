"""Device-side bicubic resize and square crops with PIL semantics, as dense
matmuls (port of ``hoigen_tpu/ops/resize.py``).

The weight matrices implement PIL's convention: sample centres at
``(i + 0.5) * scale``, the Keys kernel with a = -0.5, support scaled by
``max(scale, 1)`` when downsampling, and the tap window clipped to the
source extent with weights renormalised over it. ``_quant_u8`` emulates
PIL's uint8 store between its horizontal and vertical passes. The crop
functions take a batch of boxes and build one weight matrix per box, so a
batch of crops is one pair of batched products.
"""
import math

import numpy as np
import torch

from ._weights import constant
from .pixels import IMAGENET_MEAN, IMAGENET_STD

_EPS = 1e-8


def _keys_cubic(x):
    """Keys bicubic kernel, a = -0.5 (PIL's BICUBIC filter)."""
    ax = x.abs()
    return torch.where(
        ax < 1.0, (1.5 * ax - 2.5) * ax * ax + 1.0,
        torch.where(ax < 2.0, ((-0.5 * ax + 2.5) * ax - 4.0) * ax + 2.0,
                    torch.zeros_like(ax)))


def resize_weights(in_size: int, out_size: int, window, win_lo=0.0,
                   valid_lo=None, valid_hi=None, norm_len: int = None,
                   device=None):
    """(in_size, out_size) PIL-bicubic weight matrix, or a batch of them
    (..., in_size, out_size) when the range arguments are tensors of shape
    (...,). Maps the virtual source window ``[win_lo, win_lo + window)``
    onto ``out_size`` pixels; taps outside ``[valid_lo, valid_hi)`` add no
    value but keep their kernel weight in the normaliser. All arithmetic is
    float32, as in the JAX package."""
    f32 = torch.float32

    def as_t(v):
        if not isinstance(v, torch.Tensor) and np.ndim(v) == 0:
            # a number is filled in on the device, not copied from the host
            return torch.full((1, 1), float(v), dtype=f32, device=device)
        return torch.as_tensor(v, dtype=f32, device=device)[..., None, None]

    window = as_t(window)
    win_lo = as_t(win_lo)
    valid_lo = win_lo if valid_lo is None else as_t(valid_lo)
    valid_hi = win_lo + window if valid_hi is None else as_t(valid_hi)
    dev = window.device
    scale = window / out_size
    fscale = torch.clamp(scale, min=1.0)
    centers = win_lo + (torch.arange(out_size, dtype=f32, device=dev)
                        + 0.5)[None, :] * scale                  # (..., 1, O)
    taps = (torch.arange(in_size, dtype=f32, device=dev) + 0.5)[:, None]
    w = _keys_cubic((taps - centers) / fscale)                   # (..., I, O)
    if norm_len is None:
        norm_len = in_size + 2
    vtaps = torch.floor(win_lo) + 0.5 + torch.arange(
        norm_len, dtype=f32, device=dev)[:, None]                # (..., N, 1)
    vw = _keys_cubic((vtaps - centers) / fscale)
    in_window = (vtaps >= win_lo) & (vtaps < win_lo + window)
    norm = torch.where(in_window, vw, 0.0).sum(-2, keepdim=True)
    keep = (taps >= valid_lo) & (taps < valid_hi) & (taps >= win_lo) & \
        (taps < win_lo + window)
    w = torch.where(keep, w, 0.0)
    return w / torch.clamp(norm, min=_EPS)


def _quant_u8(x):
    """PIL's per-pass fixed-point store: round half up, clamp to [0, 255]."""
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)


def batch_resize_normalize(images_u8, sizes, resolution: int,
                           mean=IMAGENET_MEAN, std=IMAGENET_STD,
                           dtype=torch.float32, pil_rounding: bool = True):
    """(B, 3, Hb, Wb) uint8 padded batch + (B, 2) valid (h, w) ->
    (B, 3, r, r) normalised CLIP stream, PIL bicubic from the valid extent.
    ``pil_rounding`` emulates PIL's per-pass uint8 quantisation."""
    x = images_u8.float()
    if images_u8.is_floating_point():
        x = x * 255.0
    _, _, hb, wb = x.shape
    sizes = sizes.float()
    wy = resize_weights(hb, resolution, sizes[:, 0], device=x.device)
    wx = resize_weights(wb, resolution, sizes[:, 1], device=x.device)
    tmp = torch.einsum("bchw,bwx->bchx", x, wx)
    if pil_rounding:
        tmp = _quant_u8(tmp)
    out = torch.einsum("bchx,bhy->bcyx", tmp, wy)
    if pil_rounding:
        out = _quant_u8(out)
    out = out / 255.0
    mean, std = (constant(tuple(np.asarray(v, np.float32).tolist()),
                          x.device).reshape(1, 3, 1, 1) for v in (mean, std))
    return ((out - mean) / std).to(dtype)


def resize_image(image, size_hw, out_hw):
    """(C, H, W) float image, valid extent (h, w) -> (C, oh, ow), PIL
    bicubic. Padded pixels beyond (h, w) never contribute."""
    _, hb, wb = image.shape
    oh, ow = out_hw
    wy = resize_weights(hb, oh, size_hw[0], device=image.device)
    wx = resize_weights(wb, ow, size_hw[1], device=image.device)
    return torch.einsum("chx,hy->cyx",
                        torch.einsum("chw,wx->chx", image, wx), wy)


def resize_image_pil_u8(image, size_hw, out_hw):
    """(C, H, W) float image in [0, 255], valid extent (h, w) -> (C, oh, ow)
    emulating PIL's uint8 bicubic resize: a horizontal then a vertical
    pass, each rounded and clamped to uint8 (Pillow's Resample.c)."""
    _, hb, wb = image.shape
    oh, ow = out_hw
    wy = resize_weights(hb, oh, size_hw[0], device=image.device)
    wx = resize_weights(wb, ow, size_hw[1], device=image.device)
    tmp = _quant_u8(torch.einsum("chw,wx->chx", image, wx))
    return _quant_u8(torch.einsum("chx,hy->cyx", tmp, wy))


def _square_crop_weights(image, boxes, resolution):
    """The (N, hb, r) and (N, wb, r) weights, on the image's device, of a
    batch of xyxy ``boxes`` (N, 4; a tensor or array on any device)
    cropped, zero-padded to a square centred on the short side
    (expand2square) and resized to r: the normaliser runs over the virtual
    square window, so the zero fill dilutes edge pixels as PIL's resize of
    the padded crop does."""
    _, hb, wb = image.shape
    boxes = torch.as_tensor(boxes, dtype=torch.float32)
    # the normaliser's run of virtual taps must cover the longest side;
    # taps past a window are masked out, so a longer run changes nothing.
    # Read on the boxes' own device: host boxes cost the card no sync
    sides = torch.maximum(boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1])
    n = max(hb, wb, int(math.ceil(float(sides.max()))) if len(boxes) else 0) \
        + 2
    x0, y0, x1, y1 = boxes.to(image.device).unbind(-1)
    bw, bh = x1 - x0, y1 - y0
    side = torch.maximum(bw, bh)
    # expand2square pastes at x_off = (side - w) // 2 when h > w and at
    # y_off = (side - h) // 2 when w > h: the window starts that far before
    # the crop
    pad_x = torch.where(bh > bw, torch.floor((side - bw) / 2.0), 0.0)
    pad_y = torch.where(bw > bh, torch.floor((side - bh) / 2.0), 0.0)
    wy = resize_weights(hb, resolution, side, win_lo=y0 - pad_y,
                        valid_lo=y0, valid_hi=y1, norm_len=n)
    wx = resize_weights(wb, resolution, side, win_lo=x0 - pad_x,
                        valid_lo=x0, valid_hi=x1, norm_len=n)
    return wy, wx


def crop_resize_square(image, boxes, resolution: int):
    """(C, H, W) float image + xyxy ``boxes`` (N, 4) (float; round at the
    caller for PIL-crop parity) -> (N, C, r, r): each box cropped,
    zero-padded to a square and bicubic-resized, as expand2square and
    PIL's resize do (``data/crops.py::clip_preprocess_crop``)."""
    wy, wx = _square_crop_weights(image, boxes, resolution)
    tmp = torch.einsum("chw,nwx->nchx", image, wx)
    return torch.einsum("nchx,nhy->ncyx", tmp, wy)


def crop_resize_square_pil_u8(image, boxes, resolution: int):
    """:func:`crop_resize_square` on a [0, 255] image with PIL's per-pass
    uint8 quantisation (the host path quantises each resample pass, see
    :func:`resize_image_pil_u8`). Returns (N, C, r, r) in [0, 255]."""
    wy, wx = _square_crop_weights(image, boxes, resolution)
    tmp = _quant_u8(torch.einsum("chw,nwx->nchx", image, wx))
    return _quant_u8(torch.einsum("nchx,nhy->ncyx", tmp, wy))
