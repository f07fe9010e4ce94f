"""V-COCO role / agent AP over ``cache.pkl``-format results.

The reference never evaluates V-COCO in-repo: ``main_tip_finetune.py:912``
raises ``NotImplementedError`` and the user carries ``cache.pkl``
(written by ``utils_tip_cache_and_union_finetune.py:494-540``) to the
official v-coco toolkit's ``vsrl_eval.VCOCOeval``. This module
re-implements that toolkit's role-AP computation (scenarios 1 and 2) and
agent AP so ``--eval`` closes the loop in-repo, over the same result
format and the instances-json ground truth produced by
``data/vcoco.py::generate_vcoco_annotations``.

Semantics follow the public vsrl_eval algorithm (s-gupta/v-coco
``vsrl_eval.py``), certified on randomized scenes against the test-only
transcription in ``tests/ref_vsrl_eval.py`` (round-4):

* Detections for action-role class ``a`` are ``(person_box, role_box,
  score)`` triples; within an image they are processed in descending
  score order, ranked globally by score for AP.
* Each detection is matched to the single highest-IoU ground-truth
  PERSON in its image — over ALL persons, acting or not. "If matched
  with an instance with no this action, it is a false positive": a
  non-acting person can shadow an acting one.
* A match is a true positive iff person IoU >= 0.5, the matched person
  has the action, the person is not yet covered for this class, and the
  role condition holds:
    - ground truth has a role box -> role IoU >= 0.5;
    - ground truth role is absent (NaN) -> scenario 1 requires the
      predicted role box be all-zero or NaN ("agent reports no object"),
      scenario 2 accepts any predicted role box.
* ``npos`` counts ground-truth PERSONS with the action; AP is the
  VOC-style all-point interpolated area under P(R).

Ground truth may be given in two forms per image:

* person-level (the toolkit's vcocodb shape): ``persons`` (P, 4),
  ``action_multihot`` (P, A) and ``role_boxes`` (P, A, 4) with NaN rows
  for actions without an annotated role — this form can express
  non-acting persons;
* pair-level (``data/vcoco.py::VCOCODataset.target``): ``boxes_h`` /
  ``boxes_o`` / ``actions`` — persons are reconstructed by exact-box
  dedup. Persons with no action at all are not representable in this
  form (the instances json only stores positive pairs), matching the
  information available to the reference's own annotation producer
  (``vcoco/utilities/generate_annotations.py:76-140``).

Port of ``hoigen_tpu/eval/vcoco_ap.py``, the same algorithm in the same order
(the tests hold the two packages equal).
"""
from typing import Dict, List, Sequence

import numpy as np

__all__ = ["role_ap", "agent_ap", "evaluate_vcoco_results"]


def _box_iou_1_to_many(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """IoU of one xyxy box against (N, 4) xyxy boxes."""
    if boxes.shape[0] == 0:
        return np.zeros((0,), np.float64)
    x1 = np.maximum(box[0], boxes[:, 0])
    y1 = np.maximum(box[1], boxes[:, 1])
    x2 = np.minimum(box[2], boxes[:, 2])
    y2 = np.minimum(box[3], boxes[:, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    a = np.clip(box[2] - box[0], 0, None) * np.clip(box[3] - box[1], 0, None)
    b = np.clip(boxes[:, 2] - boxes[:, 0], 0, None) * \
        np.clip(boxes[:, 3] - boxes[:, 1], 0, None)
    union = a + b - inter
    with np.errstate(invalid="ignore"):
        return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _voc_ap(tp: np.ndarray, fp: np.ndarray, scores: np.ndarray,
            npos: int) -> float:
    """All-point interpolated AP (the toolkit's VOC-style formula)."""
    if npos == 0 or scores.size == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    tp_c = np.cumsum(tp[order])
    fp_c = np.cumsum(fp[order])
    rec = tp_c / npos
    prec = tp_c / np.maximum(tp_c + fp_c, 1e-12)
    mrec = np.concatenate([[0.0], rec, [1.0]])
    mpre = np.concatenate([[0.0], prec, [0.0]])
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _person_level_gt(t: dict, num_actions: int):
    """One image's GT as (persons (P,4), actions (P,A), roles (P,A,4))."""
    if "persons" in t:
        persons = np.asarray(t["persons"], np.float64).reshape(-1, 4)
        acts = np.asarray(t["action_multihot"], np.int64).reshape(
            -1, num_actions)
        roles = np.asarray(t["role_boxes"], np.float64).reshape(
            -1, num_actions, 4)
        return persons, acts, roles
    # reconstruct from pair-level rows: exact-box person dedup (the rows
    # all originate from the same annotation file, so bytes agree)
    bh = np.asarray(t["boxes_h"], np.float64).reshape(-1, 4)
    bo = np.asarray(t["boxes_o"], np.float64).reshape(-1, 4)
    acts_idx = np.asarray(t["actions"], np.int64).reshape(-1)
    persons: List[np.ndarray] = []
    index: Dict[bytes, int] = {}
    rows = []
    for k in range(bh.shape[0]):
        key = bh[k].tobytes()
        if key not in index:
            index[key] = len(persons)
            persons.append(bh[k])
            rows.append(k)
    P = len(persons)
    acts = np.zeros((P, num_actions), np.int64)
    roles = np.full((P, num_actions, 4), np.nan)
    for k in range(bh.shape[0]):
        p = index[bh[k].tobytes()]
        a = int(acts_idx[k])
        acts[p, a] = 1
        roles[p, a] = bo[k]
    if P == 0:
        return (np.zeros((0, 4)), np.zeros((0, num_actions), np.int64),
                np.zeros((0, num_actions, 4)))
    return np.stack(persons), acts, roles


def _index_gt(gt_by_image: Dict[int, dict], num_actions: int):
    table: Dict[int, tuple] = {}
    npos = np.zeros((num_actions,), np.int64)
    for image_id, t in gt_by_image.items():
        persons, acts, roles = _person_level_gt(t, num_actions)
        table[int(image_id)] = (persons, acts, roles)
        npos += (acts == 1).sum(axis=0)
    return table, npos


def _collect_dets(results: Sequence[dict], key: str, agent_key: str,
                  want_role: bool):
    """(image_ids, person (N,4), role (N,4), scores) for one class."""
    ids, ph, ro, sc = [], [], [], []
    for r in results:
        if want_role:
            if key not in r:
                continue
            v = np.asarray(r[key], np.float64)
            ids.append(int(r["image_id"]))
            ph.append(np.asarray(r["person_box"], np.float64))
            ro.append(v[:4])
            sc.append(float(v[4]))
        else:
            if agent_key not in r:
                continue
            ids.append(int(r["image_id"]))
            ph.append(np.asarray(r["person_box"], np.float64))
            ro.append(np.zeros((4,)))
            sc.append(float(r[agent_key]))
    if not ids:
        z = np.zeros((0, 4))
        return np.zeros((0,), np.int64), z, z, np.zeros((0,))
    return (np.asarray(ids), np.stack(ph), np.stack(ro), np.asarray(sc))


def _match_class(ids, ph, ro, sc, table, a, scenario, iou_thresh,
                 use_role: bool):
    """tp/fp streams for one flattened class, toolkit matching: global
    descending-score order (== per-image descending for the per-image
    covered bookkeeping), argmax-IoU person match over ALL persons."""
    order = np.argsort(-sc, kind="stable")
    tp = np.zeros((sc.size,))
    fp = np.zeros((sc.size,))
    covered: Dict[int, np.ndarray] = {}
    for d in order:
        if np.isnan(ph[d]).any():      # toolkit skips NaN agent boxes
            tp[d] = 0.0
            fp[d] = 1.0
            continue
        gt = table.get(int(ids[d]))
        ok = False
        if gt is not None and gt[0].shape[0] > 0:
            persons, acts, roles = gt
            ov = _box_iou_1_to_many(ph[d], persons)
            jmax = int(ov.argmax())
            ovmax = float(ov[jmax])
            if acts[jmax, a] == 1 and ovmax >= iou_thresh:
                if use_role:
                    gt_role = roles[jmax, a]
                    if np.isnan(gt_role).all():
                        if scenario == 2:
                            ov_role = 1.0
                        else:
                            pred = ro[d]
                            ov_role = 1.0 if (np.all(pred == 0.0)
                                              or np.isnan(pred).all()) \
                                else 0.0
                    else:
                        with np.errstate(invalid="ignore"):
                            ov_role = float(_box_iou_1_to_many(
                                ro[d], gt_role[None])[0])
                else:
                    ov_role = 1.0
                if ov_role >= iou_thresh:
                    cov = covered.setdefault(
                        int(ids[d]), np.zeros((persons.shape[0],), bool))
                    if not cov[jmax]:
                        cov[jmax] = True
                        ok = True
        tp[d] = float(ok)
        fp[d] = float(not ok)
    return tp, fp


def role_ap(results: Sequence[dict], gt_by_image: Dict[int, dict],
            actions: Sequence[str], scenario: int = 1,
            iou_thresh: float = 0.5) -> Dict[str, float]:
    """Role AP per action-role class + ``mean`` (the headline number).

    ``results``: cache.pkl entries; ``gt_by_image``: image_id -> GT dict
    (person-level or pair-level, see module docstring); ``actions``:
    class names like ``"hold obj"`` (role key = ``hold_obj``).
    """
    assert scenario in (1, 2)
    table, npos = _index_gt(gt_by_image, len(actions))
    out: Dict[str, float] = {}
    aps = []
    for a, name in enumerate(actions):
        key = "_".join(name.split())
        ids, ph, ro, sc = _collect_dets(results, key, "", want_role=True)
        tp, fp = _match_class(ids, ph, ro, sc, table, a, scenario,
                              iou_thresh, use_role=True)
        ap = _voc_ap(tp, fp, sc, int(npos[a]))
        out[name] = ap
        if npos[a] > 0:
            aps.append(ap)
    out["mean"] = float(np.mean(aps)) if aps else 0.0
    return out


def agent_ap(results: Sequence[dict], gt_by_image: Dict[int, dict],
             actions: Sequence[str], iou_thresh: float = 0.5
             ) -> Dict[str, float]:
    """Agent AP per class: person box + ``<verb>_agent`` score only.

    The toolkit scores agents per *verb*; with the flattened action-role
    classes several classes share one agent key (``cut_obj``/``cut_instr``
    -> ``cut_agent``), and each cache entry carries the agent score of its
    own pair, so per-class agent AP is evaluated against that class's GT
    with the toolkit's person-matching rules (argmax over all persons,
    wrong-action match = FP, per-person covered array).
    """
    table, npos = _index_gt(gt_by_image, len(actions))
    out: Dict[str, float] = {}
    aps = []
    for a, name in enumerate(actions):
        agent_key = name.split()[0] + "_agent"
        role_key = "_".join(name.split())
        # entries for THIS class: agent key present and the class's role
        # key present (distinguishes cut_obj from cut_instr entries)
        sub = [r for r in results if agent_key in r and role_key in r]
        ids, ph, ro, sc = _collect_dets(sub, "", agent_key, want_role=False)
        tp, fp = _match_class(ids, ph, ro, sc, table, a, scenario=1,
                              iou_thresh=iou_thresh, use_role=False)
        ap = _voc_ap(tp, fp, sc, int(npos[a]))
        out[name] = ap
        if npos[a] > 0:
            aps.append(ap)
    out["mean"] = float(np.mean(aps)) if aps else 0.0
    return out


def evaluate_vcoco_results(results: Sequence[dict], dataset,
                           iou_thresh: float = 0.5) -> Dict[str, dict]:
    """Full report over a VCOCODataset: role AP (both scenarios) + agent
    AP, keyed like the toolkit's printout."""
    gt = {dataset.image_id(i): dataset.target(i)
          for i in range(len(dataset))}
    actions = dataset.actions
    return {
        "role_ap_scenario_1": role_ap(results, gt, actions, 1, iou_thresh),
        "role_ap_scenario_2": role_ap(results, gt, actions, 2, iou_thresh),
        "agent_ap": agent_ap(results, gt, actions, iou_thresh),
    }
