"""Detection average-precision meters (host-side, vectorized numpy).

Numerically mirrors the reference meters
(reference/pocket/pocket/utils/meters.py:255-269,414-607) but replaces
the per-class Python loops + multiprocessing spawn pool with O(N) vectorized
numpy per class (a host wins from vectorization, not from process
pools).

AP algorithms ('11P' is what HICO-DET eval uses):
  11P  11-point interpolation (VOC<2010)
  INT  all-point interpolation (VOC2010+)
  AUC  raw area under the PR curve (with the reference's exact quirks)

Port of ``hoigen_tpu/eval/ap.py``, the same algorithm in the same order
(the tests hold the two packages equal).
"""
from typing import List, Optional, Sequence

import numpy as np


def _pr_curve(scores: np.ndarray, labels: np.ndarray, num_gt: Optional[float]):
    """Sorted precision/recall (meters.py compute_pr_for_each).

    Uses a stable descending sort so equal scores keep insertion order,
    matching torch.argsort(descending=True) on CPU.
    """
    order = np.argsort(-scores, kind="stable")
    tp = labels[order].astype(np.float64)
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(1.0 - tp)
    prec = tp_cum / (tp_cum + fp_cum)
    denom = labels.sum() if num_gt is None else num_gt
    rec = np.zeros_like(tp_cum) if denom == 0 else tp_cum / denom
    return prec, rec


def ap_11_point(prec: np.ndarray, rec: np.ndarray) -> float:
    """11-point interpolated AP (meters.py:255-269), vectorized.

    For t in {0, .1, ..., 1}: AP += max(prec[rec >= t]) / 11.
    rec is nondecreasing, so rec >= t is a suffix; use a suffix max.
    """
    if len(prec) == 0:
        return 0.0
    suffix_max = np.maximum.accumulate(prec[::-1])[::-1]
    # i/10 (exact for i=6,7) rather than np.linspace (which accumulates
    # rounding error and flips inclusion when recall hits the threshold
    # exactly); matches torch.linspace used by the reference.
    thresholds = np.arange(11) / 10.0
    idx = np.searchsorted(rec, thresholds, side="left")
    valid = idx < len(rec)
    return float(suffix_max[idx[valid]].sum() / 11.0)


def ap_auc(prec: np.ndarray, rec: np.ndarray) -> float:
    """Trapezoidal AUC with the reference's exact semantics
    (meters.py compute_per_class_ap_as_auc): iterate until rec reaches its
    maximum, skip zero-width steps, seed with prec[0]*rec[0]."""
    n = len(prec)
    if n == 0:
        return 0.0
    max_rec = rec[-1]
    # first index where rec >= max_rec: loop body runs for idx < k
    k = int(np.searchsorted(rec, max_rec, side="left"))
    if k == 0:
        return 0.0
    ap = prec[0] * rec[0] if (rec[0] - rec[-1]) != 0 else 0.0
    if k > 1:
        d_x = rec[1:k] - rec[:k - 1]
        contrib = 0.5 * (prec[1:k] + prec[:k - 1]) * d_x
        ap += contrib[d_x != 0].sum()
    return float(ap)


def ap_interpolated(prec: np.ndarray, rec: np.ndarray) -> float:
    """All-point interpolation (meters.py compute_per_class_ap_with_interpolation)."""
    n = len(prec)
    if n == 0:
        return 0.0
    max_rec = rec[-1]
    k = int(np.searchsorted(rec, max_rec, side="left"))
    if k == 0:
        return 0.0
    suffix_max = np.maximum.accumulate(prec[::-1])[::-1]
    ap = suffix_max[0] * rec[0] if (rec[0] - rec[-1]) != 0 else 0.0
    if k > 1:
        d_x = rec[1:k] - rec[:k - 1]
        # 0.5 * (max_[idx] + max(prec[idx-1], max_[idx])) * d_x
        m = suffix_max[1:k]
        contrib = 0.5 * (m + np.maximum(prec[:k - 1], m)) * d_x
        ap += contrib[d_x != 0].sum()
    return float(ap)


_ALGORITHMS = {"11P": ap_11_point, "AUC": ap_auc, "INT": ap_interpolated}


class DetectionAPMeter:
    """Class-specific AP meter (meters.py:414-607 DetectionAPMeter).

    Detections arrive as (score, predicted class, binary label) triples;
    each class accumulates its own score/label list.

    Usage:
        meter = DetectionAPMeter(600, num_gt=num_anno, algorithm='11P')
        meter.append(scores, classes, labels)   # numpy 1-D arrays
        ap = meter.eval()                        # float64[600]
    """

    def __init__(self, num_cls: int, num_gt: Optional[Sequence] = None,
                 algorithm: str = "AUC") -> None:
        if num_gt is not None and len(num_gt) != num_cls:
            raise ValueError("num_gt must have num_cls entries")
        self.num_cls = num_cls
        self.num_gt = None if num_gt is None else np.asarray(num_gt, np.float64)
        if algorithm not in _ALGORITHMS:
            raise ValueError(f"Unknown algorithm {algorithm}")
        self.algorithm = algorithm
        self._scores: List[List[np.ndarray]] = [[] for _ in range(num_cls)]
        self._labels: List[List[np.ndarray]] = [[] for _ in range(num_cls)]
        self.max_rec = np.zeros(num_cls, np.float64)

    def append(self, scores, classes, labels) -> None:
        """Add detections: scores[N], predicted classes[N], binary labels[N]."""
        scores = np.asarray(scores, np.float64).reshape(-1)
        classes = np.asarray(classes).reshape(-1).astype(np.int64)
        labels = np.asarray(labels, np.float64).reshape(-1)
        if not (scores.shape == classes.shape == labels.shape):
            raise ValueError("scores/classes/labels must be same length")
        order = np.argsort(classes, kind="stable")
        classes_s = classes[order]
        uniq, starts = np.unique(classes_s, return_index=True)
        bounds = np.append(starts, len(classes_s))
        for c, lo, hi in zip(uniq, bounds[:-1], bounds[1:]):
            sel = order[lo:hi]
            self._scores[c].append(scores[sel])
            self._labels[c].append(labels[sel])

    def _eval_one(self, c):
        alg = _ALGORITHMS[self.algorithm]
        scores = np.concatenate(self._scores[c])
        labels = np.concatenate(self._labels[c])
        ngt = None if self.num_gt is None else self.num_gt[c]
        if ngt is not None and labels.sum() > ngt:
            raise AssertionError(
                f"Class {c}: true positives ({labels.sum()}) exceed "
                f"ground truth count ({ngt})")
        if len(scores) == 0:
            return 0.0, 0.0
        prec, rec = _pr_curve(scores, labels, ngt)
        return alg(prec, rec), (rec[-1] if len(rec) else 0.0)

    def eval(self, num_workers: int = 0) -> np.ndarray:
        """Per-class AP. ``num_workers`` > 1 fans the classes over a
        process pool (the reference spawns a Pool for the 600-class
        sort/cumsum, pocket/pocket/utils/meters.py:535-541); 0/1 stays
        in-process."""
        ap = np.zeros(self.num_cls, np.float64)
        todo = [c for c in range(self.num_cls) if self._scores[c]]
        if num_workers and num_workers > 1 and len(todo) > 1:
            from concurrent.futures import ProcessPoolExecutor
            with ProcessPoolExecutor(max_workers=num_workers) as pool:
                for c, (a, mr) in zip(todo, pool.map(
                        self._eval_one, todo,
                        chunksize=max(1, len(todo) // num_workers))):
                    ap[c] = a
                    self.max_rec[c] = mr
            return ap
        for c in todo:
            ap[c], self.max_rec[c] = self._eval_one(c)
        return ap

    def reset(self) -> None:
        self._scores = [[] for _ in range(self.num_cls)]
        self._labels = [[] for _ in range(self.num_cls)]
        self.max_rec[:] = 0.0


def classification_ap(output: np.ndarray, labels: np.ndarray,
                      num_gt: Optional[Sequence] = None,
                      algorithm: str = "AUC") -> np.ndarray:
    """Classification-setting AP: scores of all classes retained per sample
    (AveragePrecisionMeter, meters.py:143-413). output/labels: (N, K)."""
    output = np.asarray(output, np.float64)
    labels = np.asarray(labels, np.float64)
    alg = _ALGORITHMS[algorithm]
    k = output.shape[1]
    ap = np.zeros(k, np.float64)
    for c in range(k):
        ngt = None if num_gt is None else num_gt[c]
        prec, rec = _pr_curve(output[:, c], labels[:, c], ngt)
        ap[c] = alg(prec, rec)
    return ap
