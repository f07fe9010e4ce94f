"""Device-side bicubic resize with PIL semantics, as dense matmuls (port of
``hoigen_tpu/ops/resize.py``: the CLIP-stream path).

The weight matrices implement PIL's convention: sample centres at
``(i + 0.5) * scale``, the Keys kernel with a = -0.5, support scaled by
``max(scale, 1)`` when downsampling, and the tap window clipped to the
source extent with weights renormalised over it. ``_quant_u8`` emulates
PIL's uint8 store between its horizontal and vertical passes.
"""
import torch

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
    mean = torch.as_tensor(mean, dtype=torch.float32,
                           device=x.device).reshape(1, 3, 1, 1)
    std = torch.as_tensor(std, dtype=torch.float32,
                          device=x.device).reshape(1, 3, 1, 1)
    return ((out - mean) / std).to(dtype)
