"""Device-side pixel preparation (port of ``hoigen_tpu/ops/pixels.py``).

The feed ships uint8 pixels plus per-image (h, w) sizes; the device
rebuilds the ImageNet normalisation and the padding plane.
"""
import numpy as np
import torch

from ._weights import constant

# torchvision ImageNet stats — both streams use them (reference parity)
IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def device_normalize(images, dtype=torch.float32, pad_mask=None):
    """(B, 3, H, W) uint8 pixels -> ImageNet-normalised ``dtype``.

    Float inputs are taken as already normalised and only cast.
    ``pad_mask`` (B, H, W, True = padding) zeroes padded pixels after the
    normalisation, as the reference pads with 0.0 post-Normalize."""
    if images.is_floating_point():
        return images.to(dtype)
    x = images.float() / 255.0
    mean = constant(tuple(IMAGENET_MEAN.tolist()), x.device).reshape(
        1, 3, 1, 1)
    std = constant(tuple(IMAGENET_STD.tolist()), x.device).reshape(
        1, 3, 1, 1)
    x = (x - mean) / std
    if pad_mask is not None:
        x = torch.where(pad_mask[:, None, :, :], 0.0, x)
    return x.to(dtype)


def pad_mask_from_sizes(sizes, height: int, width: int):
    """(B, 2) (h, w) unpadded extents -> bool (B, H, W), True = padding."""
    ys = torch.arange(height, device=sizes.device)[None, :, None]
    xs = torch.arange(width, device=sizes.device)[None, None, :]
    h = sizes[:, 0].to(torch.int32)[:, None, None]
    w = sizes[:, 1].to(torch.int32)[:, None, None]
    return (ys >= h) | (xs >= w)
