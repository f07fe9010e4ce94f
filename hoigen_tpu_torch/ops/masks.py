"""Anti-aliased box masks (port of ``hoigen_tpu/ops/masks.py``).

The reference's one native op (pocket/csrc/masks.cpp:13-67,
GenerateMasks). A pixel's coverage by a box is separable:
    w_y(r) = clip(min(r + 1, y2) - max(r, y1), 0, 1)
    mask[r, c] = w_y(r) * w_x(c)
which is the C++ floor/ceil boundary-fraction logic (interior rows 1,
boundary rows their covered fraction, a box within one row y2 - y1). The
JAX package keeps a C++ copy as a host cross-check
(``hoigen_tpu/native/masks.cpp``); the port keeps none, and its tests
hold this function against both.
"""
import torch


def generate_masks(boxes, h: int, w: int):
    """boxes: (N, 4) float xyxy -> (N, h, w) fractional-coverage masks in
    the boxes' dtype, on their device."""
    rows = torch.arange(h, dtype=boxes.dtype, device=boxes.device)
    cols = torch.arange(w, dtype=boxes.dtype, device=boxes.device)
    x1, y1, x2, y2 = boxes.unbind(-1)
    w_y = torch.clamp(torch.minimum(rows[None, :] + 1, y2[:, None])
                      - torch.maximum(rows[None, :], y1[:, None]), 0, 1)
    w_x = torch.clamp(torch.minimum(cols[None, :] + 1, x2[:, None])
                      - torch.maximum(cols[None, :], x1[:, None]), 0, 1)
    return w_y[:, :, None] * w_x[:, None, :]
