"""Set matching and detection criteria (port of
``hoigen_tpu/ops/matching.py``): the DETR Hungarian matcher's cost and
SetCriterion's losses (detr/models/matcher.py:12-86, detr.py:84-250) for
the offline detector finetune, the pair-level matching cost
(ops.py:148-247), BoxPairCoder (ops.py:56-146) and balanced sampling.

Costs are computed on the device; the assignment runs on the host (scipy)
between the forward and the loss, as in the JAX package; the loss takes
the padded matches as tensors.
"""
import math

import numpy as np
import torch

from .boxes import box_area, box_cxcywh_to_xyxy


def _giou(a, b):
    """GIoU of broadcast xyxy boxes a (..., 4) and b (..., 4) -> (...),
    in the JAX package's arithmetic: the IoU first, then the intersection
    recovered from it."""
    area_a, area_b = box_area(a), box_area(b)
    wh = torch.clamp(torch.minimum(a[..., 2:], b[..., 2:])
                     - torch.maximum(a[..., :2], b[..., :2]), min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a + area_b - inter
    iou = torch.where(union > 0, inter / union, 0.0)
    hull_wh = torch.clamp(torch.maximum(a[..., 2:], b[..., 2:])
                          - torch.minimum(a[..., :2], b[..., :2]), min=0)
    hull = hull_wh[..., 0] * hull_wh[..., 1]
    inter = iou * (area_a + area_b) / torch.clamp(1 + iou, min=1e-9)
    union = area_a + area_b - inter
    return iou - (hull - union) / torch.clamp(hull, min=1e-9)


def generalized_box_iou(a, b):
    """GIoU on xyxy boxes: (..., N, 4) x (..., M, 4) -> (..., N, M)."""
    return _giou(a[..., :, None, :], b[..., None, :, :])


def detr_matching_cost(pred_logits, pred_boxes, gt_labels, gt_boxes,
                       cost_class=1.0, cost_bbox=5.0, cost_giou=2.0):
    """DETR matching cost (matcher.py:35-81): -prob[gt] + L1 + GIoU on
    cxcywh/xyxy boxes. pred (..., Q, C+1) / (..., Q, 4); gt (..., G) /
    (..., G, 4 cxcywh), any leading batch dims. -> (..., Q, G)."""
    prob = torch.softmax(pred_logits, -1)
    c_class = -torch.gather(
        prob, -1, gt_labels.long()[..., None, :].expand(
            *prob.shape[:-1], gt_labels.shape[-1]))
    c_bbox = (pred_boxes[..., :, None, :]
              - gt_boxes[..., None, :, :]).abs().sum(-1)
    c_giou = -generalized_box_iou(box_cxcywh_to_xyxy(pred_boxes),
                                  box_cxcywh_to_xyxy(gt_boxes))
    return cost_class * c_class + cost_bbox * c_bbox + cost_giou * c_giou


def hungarian_assign(cost: np.ndarray, n_valid: int):
    """Host-side assignment over the first n_valid columns.
    Returns (row_idx, col_idx) numpy int64 arrays."""
    from scipy.optimize import linear_sum_assignment
    if n_valid == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    r, c = linear_sum_assignment(np.asarray(cost)[:, :n_valid])
    return r.astype(np.int64), c.astype(np.int64)


def _last_write(rows, values, n_rows, fill):
    """out[b, q] = values[b, j] for the last j with rows[b, j] == q, else
    ``fill``: the result of JAX's ``.at[b, rows].set(values)`` on the CPU,
    where the last of duplicate indices wins, made deterministic."""
    m = rows.shape[1]
    hit = rows[:, :, None] == torch.arange(n_rows, device=rows.device)
    last = torch.where(hit, torch.arange(m, device=rows.device)[:, None],
                       -1).amax(1)                               # (B, Q)
    picked = torch.gather(values, 1, last.clamp(min=0))
    return torch.where(last >= 0, picked, fill)


def detr_set_criterion(pred_logits, pred_boxes, gt_labels, gt_boxes,
                       gt_valid, match_rows, match_cols, match_valid,
                       num_classes: int, eos_coef: float = 0.1,
                       bbox_loss_coef: float = 5.0,
                       giou_loss_coef: float = 2.0):
    """DETR losses given padded host-side matches (detr.py SetCriterion
    loss_labels/loss_boxes :126-180).

    pred (B, Q, C+1) / (B, Q, 4); gt (B, G) / (B, G, 4); matches (B, M)
    row/col indices with a validity mask (padding rows and cols 0).
    num_boxes is the batch's valid-GT count. Every query defaults to
    no-object; the matched ones take their GT class, written in index
    order so that a padding entry at row 0 overrides a match of query 0,
    as the JAX package's scatter does on the CPU. Returns a dict of scalar
    losses."""
    b, q, _ = pred_logits.shape
    no_object = num_classes
    match_rows, match_cols = match_rows.long(), match_cols.long()
    gt_cls = torch.gather(gt_labels.long(), 1, match_cols)
    upd = torch.where(match_valid, gt_cls, no_object)
    target = _last_write(match_rows, upd, q, no_object)
    logp = torch.log_softmax(pred_logits, -1)
    weights = torch.where(target == no_object, eos_coef, 1.0)
    ce = -torch.gather(logp, -1, target[..., None])[..., 0]
    loss_ce = (ce * weights).sum() / weights.sum()

    num_boxes = torch.clamp(gt_valid.float().sum(), min=1.0)
    pb = torch.gather(pred_boxes, 1, match_rows[..., None].expand(-1, -1, 4))
    gb = torch.gather(gt_boxes, 1, match_cols[..., None].expand(-1, -1, 4))
    mv = match_valid.float()
    l1 = ((pb - gb).abs() * mv[..., None]).sum() / num_boxes
    diag = _giou(box_cxcywh_to_xyxy(pb), box_cxcywh_to_xyxy(gb))
    loss_giou = ((1 - diag) * mv).sum() / num_boxes
    return {"loss_ce": loss_ce, "loss_bbox": bbox_loss_coef * l1,
            "loss_giou": giou_loss_coef * loss_giou,
            "total": loss_ce + bbox_loss_coef * l1
            + giou_loss_coef * loss_giou}


def pair_matching_cost(verb_scores, object_scores, boxes_h, boxes_o,
                       gt_verbs, gt_objects, gt_bh, gt_bo,
                       cost_object=1.0, cost_verb=1.0, cost_bbox=1.0,
                       cost_giou=1.0):
    """Pair-level matching cost (ops.py HungarianMatcher :148-247): verb
    focal-style score cost + object prob cost + max-over-(h, o) of L1 and
    GIoU. Boxes in normalised cxcywh. Returns (N, G)."""
    c_verb = -(gt_verbs @ torch.log(torch.clamp(verb_scores, 1e-8, 1)).T
               + (1 - gt_verbs) @ torch.log(
                   torch.clamp(1 - verb_scores, 1e-8, 1)).T).T \
        / torch.clamp(gt_verbs.sum(-1), min=1)
    c_obj = -object_scores[:, gt_objects.long()]
    l1 = torch.maximum(
        (boxes_h[:, None] - gt_bh[None]).abs().sum(-1),
        (boxes_o[:, None] - gt_bo[None]).abs().sum(-1))
    giou = torch.maximum(
        -generalized_box_iou(box_cxcywh_to_xyxy(boxes_h),
                             box_cxcywh_to_xyxy(gt_bh)),
        -generalized_box_iou(box_cxcywh_to_xyxy(boxes_o),
                             box_cxcywh_to_xyxy(gt_bo)))
    return cost_verb * c_verb + cost_object * c_obj + cost_bbox * l1 \
        + cost_giou * giou


class BoxPairCoder:
    """Box-pair regression encode/decode (ops.py:56-146)."""

    def __init__(self, weights=(10.0, 10.0, 5.0, 5.0),
                 bbox_xform_clip=math.log(1000.0 / 16)):
        self.weights = tuple(float(w) for w in weights)
        self.clip = bbox_xform_clip

    def encode(self, props_h, props_o, target_h, target_o):
        wx, wy, ww, wh = self.weights

        def enc(p, t):
            return torch.stack([wx * (t[:, 0] - p[:, 0]),
                                wy * (t[:, 1] - p[:, 1]),
                                ww * torch.log(t[:, 2] / p[:, 2]),
                                wh * torch.log(t[:, 3] / p[:, 3])], 1)
        return torch.cat([enc(props_h, target_h), enc(props_o, target_o)], 1)

    def decode(self, props_h, props_o, deltas):
        w = torch.as_tensor(self.weights * 2, dtype=deltas.dtype,
                            device=deltas.device)
        d = deltas / w

        def dec(p, dx, dy, dw, dh):
            dw = torch.clamp(dw, max=self.clip)
            dh = torch.clamp(dh, max=self.clip)
            return torch.stack([p[:, 0] + dx, p[:, 1] + dy,
                                p[:, 2] * torch.exp(dw),
                                p[:, 3] * torch.exp(dh)], 1)
        return (dec(props_h, d[:, 0], d[:, 1], d[:, 2], d[:, 3]),
                dec(props_o, d[:, 4], d[:, 5], d[:, 6], d[:, 7]))


def balanced_box_sample(labels_binary, num_samples: int,
                        positive_fraction: float, rng):
    """Balanced positive/negative sampling over binary pair labels
    (pocket BalancedBoxSampler semantics): returns index arrays."""
    labels_binary = np.asarray(labels_binary)
    pos = np.nonzero(labels_binary > 0)[0]
    neg = np.nonzero(labels_binary == 0)[0]
    n_pos = min(len(pos), int(num_samples * positive_fraction))
    n_neg = min(len(neg), num_samples - n_pos)
    return (rng.permutation(pos)[:n_pos], rng.permutation(neg)[:n_neg])
