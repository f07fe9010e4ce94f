"""36-d pairwise box spatial encodings (port of
``hoigen_tpu/ops/spatial.py``; reference ops.py:377-436,
compute_spatial_encodings): 18 geometric features and their logs, over a
batch of box pairs with one (h, w) image size."""
import torch

from .boxes import box_iou


def compute_spatial_encodings(b1, b2, shape, eps: float = 1e-10):
    """b1, b2: (N, 4) xyxy pairs; shape: (2,) = (h, w). -> (N, 36)."""
    h, w = shape[0], shape[1]
    c1_x = (b1[:, 0] + b1[:, 2]) / 2
    c1_y = (b1[:, 1] + b1[:, 3]) / 2
    c2_x = (b2[:, 0] + b2[:, 2]) / 2
    c2_y = (b2[:, 1] + b2[:, 3]) / 2
    b1_w = b1[:, 2] - b1[:, 0]
    b1_h = b1[:, 3] - b1[:, 1]
    b2_w = b2[:, 2] - b2[:, 0]
    b2_h = b2[:, 3] - b2[:, 1]

    d_x = torch.abs(c2_x - c1_x) / (b1_w + eps)
    d_y = torch.abs(c2_y - c1_y) / (b1_h + eps)
    iou = torch.diagonal(box_iou(b1, b2))

    f = torch.stack([
        c1_x / w, c1_y / h, c2_x / w, c2_y / h,
        b1_w / w, b1_h / h, b2_w / w, b2_h / h,
        b1_w * b1_h / (h * w), b2_w * b2_h / (h * w),
        b2_w * b2_h / (b1_w * b1_h + eps),
        b1_w / (b1_h + eps), b2_w / (b2_h + eps),
        iou,
        (c2_x > c1_x) * d_x, (c2_x < c1_x) * d_x,
        (c2_y > c1_y) * d_y, (c2_y < c1_y) * d_y,
    ], dim=1)
    return torch.cat([f, torch.log(f + eps)], dim=1)
