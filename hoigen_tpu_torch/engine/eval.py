"""HICO-DET mAP evaluation and official-format result caching.

Host-side equivalents of CustomisedDLE.test_hico / cache_hico / cache_vcoco
(reference/utils_tip_cache_and_union_finetune.py:348-540): the device
produces dense (P, C) pair-score matrices per image (one eval step per
batch); the host extracts nonzero entries, converts verbs to interactions,
associates with ground truth and feeds the AP meter.

Port of ``hoigen_tpu/engine/eval.py``, the same algorithm in the same order
(the tests hold the two packages equal).
"""
import os
import pickle
from collections import defaultdict
from typing import Optional

import numpy as np

from ..eval import BoxPairAssociation, DetectionAPMeter
from ..models.proposals import pair_indices


def _extract_detections(scores_mat, boxes, objects, pair_x, pair_y,
                        verbs_mat=None):
    """(P, C) dense or (P, Vmax) compact -> sparse detections (reference
    postprocessing, upt...py:1408-1427: entries with nonzero prior
    product). Compact form (``verbs_mat`` given): column k of row p holds
    the score of verb verbs_mat[p, k]; LUT rows ascend, so the extraction
    order matches the dense np.nonzero row-major order exactly."""
    ps, cs = np.nonzero(scores_mat)
    verbs = cs if verbs_mat is None else verbs_mat[ps, cs]
    return {
        "scores": scores_mat[ps, cs],
        "verbs": verbs.astype(np.int64),
        "objects": objects[ps],
        "boxes_h": boxes[pair_x[ps]],
        "boxes_o": boxes[pair_y[ps]],
    }


def _batch_arrays(outputs):
    """(scores, verbs-or-None, boxes, objects) numpy views of one eval
    batch's outputs, handling dense and compact forms."""
    return (np.asarray(outputs["detection_scores"]),
            np.asarray(outputs["detection_verbs"])
            if "detection_verbs" in outputs else None,
            np.asarray(outputs["boxes"]),
            np.asarray(outputs["objects"]))


def _recover_gt(boxes_cxcywh, size_hw):
    b = np.asarray(boxes_cxcywh, np.float64)
    cx, cy, w, h = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    xyxy = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], 1)
    sh, sw = size_hw
    return xyxy * np.asarray([sw, sh, sw, sh])


def evaluate_hico(run_batches, dataset, num_classes: int,
                  proposal_cfg, object_n_verb_to_interaction=None,
                  zs_unseen: Optional[list] = None, gather_fn=None,
                  ap_workers: int = 0, train_anno_interaction=None):
    """run_batches: iterable of (host_outputs, batch) where host_outputs has
    detection_scores (B, P, C), boxes (B, S, 4), objects (B, P) and batch
    carries GT (normalized cxcywh in the CLIP frame) + clip_sizes + indices.

    Returns dict with ap (600,), mAP full/rare/non-rare and, for zero-shot,
    seen/unseen (main_tip_finetune.py:908-950).

    ``gather_fn`` (multi-host eval) merges the per-process (scores, inter,
    labels) triplets before the AP computation — a
    ragged all-gather; the reference analog is the meter
    all_gather in pocket/pocket/utils/distributed.py:17-64.
    """
    associate = BoxPairAssociation(min_iou=0.5)
    num_gt = dataset.anno_interaction
    meter = DetectionAPMeter(600, num_gt=num_gt, algorithm="11P")
    px, py = (np.asarray(x) for x in pair_indices(proposal_cfg))
    conv = object_n_verb_to_interaction
    acc_s, acc_i, acc_l = [], [], []

    for outputs, batch in run_batches:
        scores_all, verbs_all, boxes_all, objects_all = \
            _batch_arrays(outputs)
        for i in range(scores_all.shape[0]):
            det = _extract_detections(
                scores_all[i], boxes_all[i], objects_all[i], px, py,
                None if verbs_all is None else verbs_all[i])
            if num_classes == 117:
                inter = conv[det["objects"], det["verbs"]]
            else:
                inter = det["verbs"]
            keep = inter >= 0
            for k in det:
                det[k] = det[k][keep]
            inter = inter[keep]

            gv = np.asarray(batch.gt_valid[i])
            gt_h = _recover_gt(batch.boxes_h[i][gv], batch.clip_sizes[i])
            gt_o = _recover_gt(batch.boxes_o[i][gv], batch.clip_sizes[i])
            gt_hoi = np.asarray(batch.hoi[i][gv])
            labels = np.zeros(len(inter))
            # only classes present in BOTH GT and detections can produce
            # positives — iterating GT classes (<=32) instead of predicted
            # classes (~hundreds) cuts the host association loop ~20x
            for hoi_idx in np.intersect1d(gt_hoi, inter):
                gt_idx = np.nonzero(gt_hoi == hoi_idx)[0]
                det_idx = np.nonzero(inter == hoi_idx)[0]
                labels[det_idx] = associate(
                    (gt_h[gt_idx], gt_o[gt_idx]),
                    (det["boxes_h"][det_idx], det["boxes_o"][det_idx]),
                    det["scores"][det_idx])
            acc_s.append(det["scores"])
            acc_i.append(inter)
            acc_l.append(labels)

    cat = {"scores": np.concatenate(acc_s) if acc_s else np.zeros(0),
           "inter": np.concatenate(acc_i) if acc_i
           else np.zeros(0, np.int64),
           "labels": np.concatenate(acc_l) if acc_l else np.zeros(0)}
    if gather_fn is not None:
        cat = gather_fn(cat)
    meter.append(cat["scores"], cat["inter"], cat["labels"])
    ap = meter.eval(num_workers=ap_workers)
    # rare = interactions with <10 TRAINING instances (the reference splits
    # on trainset.dataset.anno_interaction, main_tip_finetune.py:915-917 —
    # NOT the test-set counts the AP meter normalizes recall with)
    rare_counts = np.asarray(
        num_gt if train_anno_interaction is None else train_anno_interaction,
        np.float64)
    rare = rare_counts < 10

    def _mean(x):
        return float(x.mean()) if len(x) else 0.0

    result = {"ap": ap, "mAP": _mean(ap), "mAP_rare": _mean(ap[rare]),
              "mAP_non_rare": _mean(ap[~rare])}
    if zs_unseen is not None:
        unseen = np.zeros(600, bool)
        unseen[np.asarray(zs_unseen)] = True
        result["mAP_unseen"] = float(ap[unseen].mean())
        result["mAP_seen"] = float(ap[~unseen].mean())
    return result


def cache_hico(run_batches, dataset, proposal_cfg,
               object_n_verb_to_interaction, object_to_interaction,
               num_classes: int, cache_dir: str,
               gather_fn=None, is_primary: bool = True):
    """Official HICO-DET .mat result dump (cache_hico, :413-492).

    Multi-process (beyond the reference, which caches on rank 0 only and
    therefore re-scores every image there): each process scores its shard,
    the sparse (class, image, rows) entries ride ``gather_fn``
    (an object all-gather) and the primary process assembles + writes."""
    import scipy.io as sio
    px, py = (np.asarray(x) for x in pair_indices(proposal_cfg))
    nimages = len(dataset.annotations)
    conv = object_n_verb_to_interaction
    entries = []          # (interaction cls, official image idx, (n,9) rows)
    for outputs, batch in run_batches:
        scores_all, verbs_all, boxes_all, objects_all = \
            _batch_arrays(outputs)
        for i in range(scores_all.shape[0]):
            ds_idx = int(batch.indices[i])
            image_idx = dataset._idx[ds_idx]
            det = _extract_detections(
                scores_all[i], boxes_all[i], objects_all[i], px, py,
                None if verbs_all is None else verbs_all[i])
            inter = (conv[det["objects"], det["verbs"]]
                     if num_classes == 117 else det["verbs"])
            keep = inter >= 0
            ow, oh = dataset.image_size(ds_idx)
            h, w = batch.clip_sizes[i]
            scale = np.asarray([ow / w, oh / h, ow / w, oh / h])
            bh = det["boxes_h"][keep] * scale
            bo = det["boxes_o"][keep] * scale
            bh[:, 2:] -= 1   # coordinates -> pixel indices
            bo[:, 2:] -= 1
            sc = det["scores"][keep]
            for cls in np.unique(inter[keep]):
                m = inter[keep] == cls
                entries.append((int(cls), int(image_idx), np.concatenate(
                    [bh[m], bo[m], sc[m, None]], axis=1)))
    parts = [entries] if gather_fn is None else gather_fn(entries)
    if not is_primary:
        return
    all_results = np.empty((600, nimages), dtype=object)
    for part in parts:
        for cls, image_idx, rows in part:
            all_results[cls, image_idx] = rows
    for c in range(600):
        for j in range(nimages):
            if all_results[c, j] is None:
                all_results[c, j] = np.zeros((0, 0))
    os.makedirs(cache_dir, exist_ok=True)
    for obj in range(80):
        sio.savemat(os.path.join(cache_dir, f"detections_{obj + 1:02d}.mat"),
                    {"all_boxes": all_results[object_to_interaction[obj]]})


class _VcocoResult(defaultdict):
    """V-COCO cache entry (CacheTemplate, :312-325): missing agent keys
    score 0, missing role keys get a tiny zero-score box."""

    def __init__(self, **kw):
        super().__init__()
        for k, v in kw.items():
            self[k] = v

    def __missing__(self, k):
        return 0.0 if k.endswith("_agent") else [0.0, 0.0, 0.1, 0.1, 0.0]


def collect_vcoco_results(run_batches, dataset, proposal_cfg):
    """Detections in the official V-COCO cache format (CacheTemplate
    entries, utils...py:494-540) as an in-memory list — shared by the
    ``cache.pkl`` dump and the in-repo role-AP evaluation."""
    px, py = (np.asarray(x) for x in pair_indices(proposal_cfg))
    all_results = []
    for outputs, batch in run_batches:
        scores_all, verbs_all, boxes_all, objects_all = \
            _batch_arrays(outputs)
        for i in range(scores_all.shape[0]):
            ds_idx = int(batch.indices[i])
            det = _extract_detections(
                scores_all[i], boxes_all[i], objects_all[i], px, py,
                None if verbs_all is None else verbs_all[i])
            ow, oh = dataset.image_size(ds_idx) if hasattr(
                dataset, "image_size") else (batch.clip_sizes[i][1],
                                             batch.clip_sizes[i][0])
            h, w = batch.clip_sizes[i]
            scale = np.asarray([ow / w, oh / h, ow / w, oh / h])
            image_id = dataset.image_id(ds_idx)
            for bh, bo, s, a in zip(det["boxes_h"] * scale,
                                    det["boxes_o"] * scale,
                                    det["scores"], det["verbs"]):
                name = dataset.actions[a].split()
                r = _VcocoResult(image_id=image_id, person_box=bh.tolist())
                r[name[0] + "_agent"] = float(s)
                r["_".join(name)] = bo.tolist() + [float(s)]
                all_results.append(r)
    return all_results


def cache_vcoco(run_batches, dataset, proposal_cfg, cache_dir: str,
                gather_fn=None, is_primary: bool = True):
    """Official V-COCO pickle dump (cache_vcoco, :494-540). Under
    multi-process, ``gather_fn`` merges the per-shard result lists and the
    primary process writes (and is the only one to return results)."""
    all_results = collect_vcoco_results(run_batches, dataset, proposal_cfg)
    if gather_fn is not None:
        all_results = [r for part in gather_fn(all_results) for r in part]
    if not is_primary:
        return None
    os.makedirs(cache_dir, exist_ok=True)
    with open(os.path.join(cache_dir, "cache.pkl"), "wb") as f:
        pickle.dump(all_results, f, 2)
    return all_results


def evaluate_vcoco(run_batches, dataset, proposal_cfg,
                   cache_dir: Optional[str] = None, gather_fn=None,
                   is_primary: bool = True):
    """In-repo V-COCO role/agent AP (beyond reference parity: the
    reference only dumps cache.pkl for the official toolkit,
    main_tip_finetune.py:912). Optionally also writes the pickle.
    Multi-process: every process scores its shard, results merge via
    ``gather_fn`` and every process computes the (deterministic) AP."""
    from ..eval.vcoco_ap import evaluate_vcoco_results
    if cache_dir is not None and is_primary:
        results = cache_vcoco(run_batches, dataset, proposal_cfg, cache_dir,
                              gather_fn=gather_fn)
    else:
        results = collect_vcoco_results(run_batches, dataset, proposal_cfg)
        if gather_fn is not None:
            results = [r for part in gather_fn(results) for r in part]
    return evaluate_vcoco_results(results, dataset)
