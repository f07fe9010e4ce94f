"""Associate detections with ground truth (host-side numpy).

Mirrors reference/pocket/pocket/utils/association.py:18-116
(BoxAssociation / BoxPairAssociation): each detection is assigned to the
ground-truth instance with the highest IoU; for every ground-truth instance,
among its assigned detections whose IoU exceeds ``min_iou`` (strict >), only
the highest-scoring one is a true positive.

Port of ``hoigen_tpu/eval/association.py``, the same algorithm in the same order
(the tests hold the two packages equal).
"""
from typing import Optional, Tuple

import numpy as np


def box_iou(a: np.ndarray, b: np.ndarray, encoding: str = "coord") -> np.ndarray:
    """Pairwise IoU of xyxy boxes: float64[len(a), len(b)].

    encoding='coord': width = x2 - x1 (torchvision semantics)
    encoding='pixel': width = x2 - x1 + 1 (pixel-index boxes)
    """
    off = 0.0 if encoding == "coord" else 1.0
    a = np.asarray(a, np.float64).reshape(-1, 4)
    b = np.asarray(b, np.float64).reshape(-1, 4)
    area_a = (a[:, 2] - a[:, 0] + off) * (a[:, 3] - a[:, 1] + off)
    area_b = (b[:, 2] - b[:, 0] + off) * (b[:, 3] - b[:, 1] + off)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt + off, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None, :] - inter)


class BoxAssociation:
    """Binary TP labels for detections against ground truth boxes."""

    def __init__(self, min_iou: float, encoding: str = "coord") -> None:
        self.min_iou = min_iou
        self.encoding = encoding
        self.max_iou: Optional[np.ndarray] = None
        self.max_idx: Optional[np.ndarray] = None

    def _iou(self, gt, det) -> np.ndarray:
        return box_iou(gt, det, self.encoding)

    def __call__(self, gt_boxes, det_boxes,
                 scores: Optional[np.ndarray] = None) -> np.ndarray:
        iou = self._iou(gt_boxes, det_boxes)  # (G, D)
        max_idx = iou.argmax(0)               # best GT per detection
        max_iou = iou[max_idx, np.arange(iou.shape[1])]
        self.max_iou, self.max_idx = max_iou, max_idx
        if scores is None:
            scores = max_iou
        scores = np.asarray(scores, np.float64).reshape(-1)

        labels = np.zeros(iou.shape[1], np.float64)
        matched = max_iou > self.min_iou
        for g in range(iou.shape[0]):
            cand = np.nonzero(matched & (max_idx == g))[0]
            if len(cand) == 0:
                continue
            labels[cand[scores[cand].argmax()]] = 1.0
        return labels


class BoxPairAssociation(BoxAssociation):
    """Pair variant: IoU of a pair is min(IoU_h, IoU_o)
    (association.py:92-116)."""

    def _iou(self, gt, det) -> np.ndarray:
        return np.minimum(
            box_iou(gt[0], det[0], self.encoding),
            box_iou(gt[1], det[1], self.encoding),
        )
