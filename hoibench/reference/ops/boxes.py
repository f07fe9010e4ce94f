"""Box primitives (port of ``hoigen_tpu/ops/boxes.py``)."""
import torch


def box_cxcywh_to_xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack(
        [cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(b):
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0],
                       dim=-1)


def box_area(b):
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def box_iou(a, b):
    """Pairwise IoU: a (..., N, 4), b (..., M, 4) -> (..., N, M)."""
    area_a = box_area(a)
    area_b = box_area(b)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def union_boxes(boxes_h, boxes_o):
    """Tight union of paired boxes."""
    lt = torch.minimum(boxes_h[..., :2], boxes_o[..., :2])
    rb = torch.maximum(boxes_h[..., 2:], boxes_o[..., 2:])
    return torch.cat([lt, rb], dim=-1)


def recover_boxes(boxes, size):
    """Normalised cxcywh -> absolute xyxy for an (h, w) image size."""
    b = box_cxcywh_to_xyxy(boxes)
    h, w = size[..., 0], size[..., 1]
    scale = torch.stack([w, h, w, h], dim=-1)
    return b * scale[..., None, :] if b.dim() > scale.dim() else b * scale
