"""Static-shape class-aware NMS (port of ``hoigen_tpu/ops/nms.py``).

Boxes of different classes never suppress each other; a box is suppressed
by any higher-scoring kept box of the same class with IoU strictly greater
than ``iou_threshold``. Ties in score go to the earlier index: the order is
a stable sort, as ``jnp.argsort(stable=True)`` in the JAX package.
"""
import torch

from .boxes import box_iou


def batched_nms_mask(boxes, scores, classes, iou_threshold: float,
                     valid=None):
    """boxes (..., N, 4), scores (..., N), classes (..., N) -> bool keep
    mask (..., N). ``valid`` marks real slots (padding slots are neither
    kept nor suppress anything). Leading dims are a batch."""
    n = boxes.shape[-2]
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool,
                           device=scores.device)
    order = torch.argsort(-scores, dim=-1, stable=True)
    boxes_s = torch.gather(boxes, -2, order[..., None].expand(
        *order.shape, 4))
    valid_s = torch.gather(valid, -1, order)
    cls_s = torch.gather(classes, -1, order)
    same_class = cls_s[..., :, None] == cls_s[..., None, :]
    iou = box_iou(boxes_s, boxes_s)
    later = torch.arange(n, device=boxes.device)
    suppress = (iou > iou_threshold) & same_class \
        & valid_s[..., :, None] & valid_s[..., None, :] \
        & (later[None, :] > later[:, None])
    keep = valid_s.clone()
    for i in range(n):
        # a kept slot i (in score order) drops every later overlapping slot
        keep &= ~(suppress[..., i, :] & keep[..., i:i + 1])
    return torch.zeros_like(keep).scatter(-1, order, keep)
