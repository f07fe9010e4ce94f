"""The port's host evaluation (hoigen_tpu_torch: eval/, engine/eval.py,
labels/) against the JAX package's (hoigen_tpu) on the same numpy inputs.

Both are numpy code with the same algorithm and summation order, so every
AP vector, table and written file must be equal, not merely close.
"""
import pickle

import numpy as np
import pytest
import scipy.io as sio

from hoigen_tpu.data.factory import DataFactory as JDataFactory, \
    collate_batch as j_collate
from hoigen_tpu.engine import eval as jeval
from hoigen_tpu.eval import ap as jap
from hoigen_tpu.eval import association as jassoc
from hoigen_tpu.labels import HICO as JHICO, VCOCO_LABELS as JVCOCO
from hoigen_tpu.models.proposals import ProposalConfig as JProposalConfig

from hoigen_tpu_torch.data.factory import DataFactory as TDataFactory, \
    collate_batch as t_collate
from hoigen_tpu_torch.engine import eval as teval
from hoigen_tpu_torch.eval import ap as tap
from hoigen_tpu_torch.eval import association as tassoc
from hoigen_tpu_torch.labels import HICO as THICO, VCOCO_LABELS as TVCOCO
from hoigen_tpu_torch.models.proposals import ProposalConfig as \
    TProposalConfig
from hoigen_tpu_torch.tools.make_hicodet import write_hicodet

TINY = dict(eval_min_side=48, max_side=80)
MAX_INSTANCES = 4


def _detections(rng, n, num_cls):
    """Scores on a coarse grid (ties), classes with some left empty, and
    binary labels."""
    scores = np.round(rng.random(n), 1)
    classes = rng.integers(0, num_cls - 3, n)      # the last 3 are empty
    labels = (rng.random(n) < 0.4).astype(np.float64)
    return scores, classes, labels


@pytest.mark.parametrize("algorithm", ["11P", "INT", "AUC"])
@pytest.mark.parametrize("with_num_gt", [True, False])
def test_detection_ap_meter_matches_jax(algorithm, with_num_gt):
    rng = np.random.default_rng(0)
    num_cls = 12
    num_gt = None
    batches = [_detections(rng, n, num_cls) for n in (40, 0, 25)]
    if with_num_gt:
        tp = np.zeros(num_cls)
        for _, c, lab in batches:
            np.add.at(tp, c, lab)
        num_gt = tp + rng.integers(0, 3, num_cls)
    meters = [m.DetectionAPMeter(num_cls, num_gt=num_gt, algorithm=algorithm)
              for m in (jap, tap)]
    for meter in meters:
        for b in batches:
            meter.append(*b)
    want, got = (m.eval() for m in meters)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(meters[1].max_rec, meters[0].max_rec)
    assert (got[-3:] == 0).all() and got.any()


def test_ap_functions_match_jax():
    rng = np.random.default_rng(1)
    prec = np.sort(rng.random(30))[::-1]
    rec = np.sort(rng.random(30))
    for name in ("ap_11_point", "ap_auc", "ap_interpolated"):
        assert getattr(tap, name)(prec, rec) == getattr(jap, name)(prec, rec)
    out = np.round(rng.random((20, 5)), 1)
    lab = (rng.random((20, 5)) < 0.5).astype(np.float64)
    for alg in ("11P", "INT", "AUC"):
        np.testing.assert_array_equal(
            tap.classification_ap(out, lab, algorithm=alg),
            jap.classification_ap(out, lab, algorithm=alg))


def test_box_iou_and_pair_association_match_jax():
    rng = np.random.default_rng(2)

    def boxes(n):
        xy = rng.random((n, 2)) * 50
        return np.concatenate([xy, xy + 5 + rng.random((n, 2)) * 40], 1)

    a, b = boxes(7), boxes(9)
    np.testing.assert_array_equal(tassoc.box_iou(a, b), jassoc.box_iou(a, b))
    gt = (boxes(4), boxes(4))
    # detections near the ground truth, so that some pass 0.5
    det = tuple(np.concatenate([g, g + rng.normal(0, 3, g.shape)])
                for g in gt)
    scores = np.round(rng.random(8), 1)
    for cls in ("BoxAssociation", "BoxPairAssociation"):
        j, t = (getattr(m, cls)(min_iou=0.5) for m in (jassoc, tassoc))
        args = (gt[0], det[0], scores) if cls == "BoxAssociation" \
            else (gt, det, scores)
        want, got = j(*args), t(*args)
        np.testing.assert_array_equal(got, want)
        assert want.any()


def test_label_tables_match_jax():
    for attr in ("class_corr", "objects", "verbs", "hoi_to_object",
                 "object_n_verb_to_interaction", "object_to_interaction",
                 "unseen_index"):
        np.testing.assert_equal(getattr(THICO, attr), getattr(JHICO, attr))
    for attr in ("keys", "values", "class_corr", "hoi_to_verb",
                 "hoi_to_object", "object_to_verb", "detr_reserve_indices",
                 "verbs_sentence", "hoi_text_label"):
        np.testing.assert_equal(getattr(TVCOCO, attr), getattr(JVCOCO, attr))
    np.testing.assert_array_equal(TVCOCO.object_n_verb_to_interaction(),
                                  JVCOCO.object_n_verb_to_interaction())
    np.testing.assert_array_equal(TVCOCO.object_class_multihot(236),
                                  JVCOCO.object_class_multihot(236))


@pytest.fixture(scope="module")
def hico_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("hico"))
    return write_hicodet(root, [(64, 48), (48, 64), (64, 48), (56, 56),
                                (64, 40), (40, 64)], seed=3)


def _synthetic_outputs(batch, num_classes, seed):
    """Compact eval-step outputs for a collated batch: the ground truth's
    boxes (jittered) in the human and object slots plus random ones,
    random objects, and scores on a coarse grid with zeros, whose verb ids
    (117 classes), interaction ids (600) or V-COCO actions (24) partly hit
    the ground truth."""
    rng = np.random.default_rng(seed)
    cfg = JProposalConfig(max_instances=MAX_INSTANCES)
    px, py = (np.asarray(x) for x in jeval.pair_indices(cfg))
    b, vmax = len(batch.indices), 6
    boxes = rng.random((b, cfg.n_slots, 4)) * 20
    boxes[..., 2:] += boxes[..., :2] + 4
    objects = rng.integers(0, 80, (b, cfg.n_pairs))
    verbs = rng.integers(0, num_classes, (b, cfg.n_pairs, vmax))
    for i in range(b):
        gv = batch.gt_valid[i]
        gt_h = jeval._recover_gt(batch.boxes_h[i][gv], batch.clip_sizes[i])
        gt_o = jeval._recover_gt(batch.boxes_o[i][gv], batch.clip_sizes[i])
        for j in range(min(len(gt_h), MAX_INSTANCES)):
            boxes[i, j] = gt_h[j] + rng.normal(0, 1.0, 4)
            boxes[i, MAX_INSTANCES + j] = gt_o[j] + rng.normal(0, 1.0, 4)
            p = np.nonzero((px == j) & (py == MAX_INSTANCES + j))[0][0]
            hoi = batch.hoi[i][j]
            objects[i, p] = JHICO.hoi_to_object[hoi]
            verbs[i, p, 0] = {600: hoi, 117: JHICO.class_corr[hoi][2]}.get(
                num_classes, batch.labels[i][j])
    scores = np.round(rng.random((b, cfg.n_pairs, vmax)), 1)
    scores[rng.random(scores.shape) < 0.5] = 0
    return {"detection_scores": scores.astype(np.float32),
            "detection_verbs": verbs, "boxes": boxes.astype(np.float32),
            "objects": objects}


def _runs(factory, collate, num_classes):
    """(outputs, batch) pairs of batch 4 over the factory, in order."""
    idx = list(range(len(factory)))
    for n, lo in enumerate(range(0, len(idx), 4)):
        batch = collate([factory[i] for i in idx[lo:lo + 4]], 8)
        yield _synthetic_outputs(batch, num_classes, n), batch


def _both(hico_tree, fn):
    """fn(package eval module, factory, collate, HICO, ProposalConfig) for
    the JAX package and for the port, on the same tree."""
    res = []
    for ev, fac, col, hico, pcfg in (
            (jeval, JDataFactory, j_collate, JHICO, JProposalConfig),
            (teval, TDataFactory, t_collate, THICO, TProposalConfig)):
        factory = fac("hicodet", "test2015", hico_tree, training=False,
                      host_clip_stream=False, transform_kwargs=TINY)
        res.append(fn(ev, factory, col, hico,
                      pcfg(max_instances=MAX_INSTANCES)))
    return res


@pytest.mark.parametrize("num_classes", [117, 600])
@pytest.mark.parametrize("zs", [False, True], ids=["full", "zero_shot"])
def test_evaluate_hico_matches_jax(hico_tree, num_classes, zs):
    def run(ev, factory, collate, hico, pcfg):
        train = np.arange(600) % 13
        return ev.evaluate_hico(
            _runs(factory, collate, num_classes), factory.dataset,
            num_classes, pcfg, hico.object_n_verb_to_interaction,
            zs_unseen=hico.unseen_index["rare_first"] if zs else None,
            train_anno_interaction=train)

    want, got = _both(hico_tree, run)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert want["ap"].shape == (600,) and want["ap"].max() > 0


def test_cache_hico_matches_jax(hico_tree, tmp_path):
    def run(ev, factory, collate, hico, pcfg):
        out = tmp_path / ev.__name__.split(".")[0]
        ev.cache_hico(_runs(factory, collate, 117), factory.dataset, pcfg,
                      hico.object_n_verb_to_interaction,
                      hico.object_to_interaction, 117, str(out))
        return out

    want, got = _both(hico_tree, run)
    n_rows = 0
    for obj in range(80):
        name = f"detections_{obj + 1:02d}.mat"
        a = sio.loadmat(str(want / name))["all_boxes"]
        b = sio.loadmat(str(got / name))["all_boxes"]
        assert a.shape == b.shape
        for x, y in zip(a.ravel(), b.ravel()):
            np.testing.assert_array_equal(y, x)
            n_rows += x.shape[0] if x.size else 0
    assert n_rows > 0


def test_vcoco_outputs_match_jax(tmp_path):
    """collect_vcoco_results, cache_vcoco's pickle and evaluate_vcoco on
    the V-COCO fixture with synthetic outputs (24 actions)."""
    import tools.make_fixture as mf
    root = mf.build_vcoco(str(tmp_path / "vcoco"), n_images=6, seed=4)
    res = {}
    for name, ev, fac, col, pcfg in (
            ("jax", jeval, JDataFactory, j_collate, JProposalConfig),
            ("port", teval, TDataFactory, t_collate, TProposalConfig)):
        factory = fac("vcoco", "test", root, training=False,
                      host_clip_stream=False, transform_kwargs=TINY)
        runs = lambda: _runs(factory, col, 24)   # noqa: E731
        p = pcfg(max_instances=MAX_INSTANCES)
        collected = ev.collect_vcoco_results(runs(), factory.dataset, p)
        ev.cache_vcoco(runs(), factory.dataset, p, str(tmp_path / name))
        with open(tmp_path / name / "cache.pkl", "rb") as f:
            cached = pickle.load(f)
        res[name] = (collected, cached,
                     ev.evaluate_vcoco(runs(), factory.dataset, p))
    (jc, jp, jr), (tc, tp, tr) = res["jax"], res["port"]
    assert len(jc) > 0
    for a, b in ((jc, tc), (jp, tp)):
        assert [dict(r) for r in b] == [dict(r) for r in a]
    np.testing.assert_equal(tr, jr)
