"""The port's DETR offline finetune (``ops/matching.py``,
``cli/train_detr.py``, the backbone's ``remat``) and detections CLI
(``cli/detections.py``) against the JAX package's, on the CPU.

Matching costs and losses within 1e-5 of their scale (the set criterion's
gradients too), Hungarian indices equal, the coder and sampler equal; one
epoch of ``train_detr`` (a narrow transformer on the full ResNet-50) from
the JAX CLI's initial weights: its two steps' losses within 1e-4 and the
parameters within 2e-4 (Adam steps of at most 1e-4 each); the detections
CLI's files against the JAX CLI's on the 5-image fixture (GT files and
renderings byte for byte, dumped detections within 1e-5 of their scale,
every mAP within 1e-6).
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tools.make_fixture as make_fixture
from hoigen_tpu.cli import detections as jdc
from hoigen_tpu.cli import train_detr as jtd
from hoigen_tpu.data import factory as jfactory
from hoigen_tpu.models import detr as jdetr
from hoigen_tpu.ops import matching as jm

from hoigen_tpu_torch.bridge import to_torch
from hoigen_tpu_torch.cli import detections as tdc
from hoigen_tpu_torch.cli import train_detr as ttd
from hoigen_tpu_torch.data import factory as tfactory
from hoigen_tpu_torch.engine.partition import named_leaves
from hoigen_tpu_torch.models.detr import model as tdetr_model
from hoigen_tpu_torch.models.detr.config import DETRConfig as TDETRConfig
from hoigen_tpu_torch.ops import matching as tm
from hoigen_tpu_torch.tools.make_checkpoints import detr_state_dict

TOL = 1e-5
TRANSFORM = dict(eval_min_side=48, max_side=80, train_scales=(40, 48, 56),
                 crop_resize_choices=(56, 64), crop_range=(32, 64))
BUCKETS = ((56, 80), (80, 56), (80, 80))
# the narrow transformer of the JAX CLI's test, on the full ResNet-50
NARROW = dict(hidden_dim=64, nheads=2, enc_layers=1, dec_layers=2,
              dim_feedforward=64, num_queries=8)


def _close(got, want, tol=TOL, where=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, where
    err = np.abs(got - want).max(initial=0.0)
    assert err <= tol * max(1.0, np.abs(want).max(initial=0.0)), (where, err)


def _boxes_cxcywh(rng, *shape):
    c = rng.uniform(0.2, 0.8, shape + (2,))
    wh = rng.uniform(0.05, 0.4, shape + (2,))
    return np.concatenate([c, wh], -1).astype(np.float32)


def _xyxy(rng, n):
    lo = rng.uniform(0, 50, (n, 2))
    return np.concatenate([lo, lo + rng.uniform(1, 40, (n, 2))],
                          1).astype(np.float32)


def test_generalized_box_iou_matches_jax():
    rng = np.random.default_rng(0)
    a, b = _xyxy(rng, 7), _xyxy(rng, 5)
    b[0] = a[0]                               # identical boxes: GIoU 1
    b[1] = (200, 200, 210, 220)               # disjoint
    got = tm.generalized_box_iou(torch.as_tensor(a), torch.as_tensor(b))
    _close(got, jm.generalized_box_iou(jnp.asarray(a), jnp.asarray(b)))
    assert abs(float(got[0, 0]) - 1.0) < 1e-6


@pytest.fixture(scope="module")
def detr_outputs():
    """Aux-layer DETR outputs and ground truth: (L, B, Q, C+1) logits,
    (L, B, Q, 4) boxes, (B, G) labels and boxes with G padded to 6."""
    rng = np.random.default_rng(1)
    n_layers, b, q, c, g = 3, 2, 9, 5, 6
    logits = rng.normal(size=(n_layers, b, q, c + 1)).astype(np.float32)
    boxes = _boxes_cxcywh(rng, n_layers, b, q)
    gt_boxes = _boxes_cxcywh(rng, b, g)
    gt_labels = rng.integers(0, c, (b, g)).astype(np.int32)
    gt_valid = np.zeros((b, g), bool)
    gt_valid[0, :4] = True
    gt_valid[1, :g] = True
    gt_boxes[~gt_valid] = 0.0
    gt_labels[~gt_valid] = 0
    return logits, boxes, gt_labels, gt_boxes, gt_valid, c


def _jax_costs(logits, boxes, labels, gt_boxes):
    return np.stack([np.stack([np.asarray(jm.detr_matching_cost(
        jnp.asarray(logits[li, i]), jnp.asarray(boxes[li, i]),
        jnp.asarray(labels[i]), jnp.asarray(gt_boxes[i]), 2.0, 5.0, 2.0))
        for i in range(logits.shape[1])]) for li in range(logits.shape[0])])


def test_matching_cost_and_hungarian_match_jax(detr_outputs):
    logits, boxes, labels, gt_boxes, gt_valid, _ = detr_outputs
    got = tm.detr_matching_cost(torch.as_tensor(logits),
                                torch.as_tensor(boxes),
                                torch.as_tensor(labels).long(),
                                torch.as_tensor(gt_boxes), 2.0, 5.0, 2.0)
    want = _jax_costs(logits, boxes, labels, gt_boxes)
    _close(got, want)
    rows, cols, mvalid = ttd.match_layers(got.numpy(), gt_valid, 6)
    for li in range(want.shape[0]):
        for i in range(want.shape[1]):
            n = int(gt_valid[i].sum())
            r, c = jm.hungarian_assign(want[li, i], n)
            np.testing.assert_array_equal(rows[li, i, :n], r)
            np.testing.assert_array_equal(cols[li, i, :n], c)
            assert mvalid[li, i].sum() == n
    assert tm.hungarian_assign(want[0, 0], 0)[0].shape == (0,)


@pytest.mark.parametrize("query0_matched", [False, True])
def test_set_criterion_with_aux_layers_matches_jax(detr_outputs,
                                                   query0_matched):
    """Losses and the gradients of logits and boxes, every decoder layer
    with its own matches. With ``query0_matched`` query 0 of every layer
    is matched while padding entries also name row 0: the last write wins
    in both packages (JAX's scatter on the CPU)."""
    logits, boxes, labels, gt_boxes, gt_valid, c = detr_outputs
    costs = _jax_costs(logits, boxes, labels, gt_boxes)
    if query0_matched:
        costs[:, :, 0, 0] -= 100.0
    rows, cols, mvalid = ttd.match_layers(costs, gt_valid, 6)
    assert (rows[:, :, 0] == 0).all() == query0_matched

    def jax_total(lg, bx):
        parts = [jm.detr_set_criterion(
            lg[li], bx[li], jnp.asarray(labels), jnp.asarray(gt_boxes),
            jnp.asarray(gt_valid), jnp.asarray(rows[li]),
            jnp.asarray(cols[li]), jnp.asarray(mvalid[li]), c, 0.2, 5.0,
            2.0) for li in range(lg.shape[0])]
        return sum(p["total"] for p in parts), parts

    (jtotal, jparts), jgrads = jax.value_and_grad(jax_total, (0, 1),
                                                  has_aux=True)(
        jnp.asarray(logits), jnp.asarray(boxes))
    tlg = torch.as_tensor(logits).requires_grad_(True)
    tbx = torch.as_tensor(boxes).requires_grad_(True)
    tparts = [tm.detr_set_criterion(
        tlg[li], tbx[li], torch.as_tensor(labels), torch.as_tensor(gt_boxes),
        torch.as_tensor(gt_valid), torch.as_tensor(rows[li]),
        torch.as_tensor(cols[li]), torch.as_tensor(mvalid[li]), c, 0.2, 5.0,
        2.0) for li in range(3)]
    ttotal = sum(p["total"] for p in tparts)
    ttotal.backward()
    _close(ttotal, jtotal, where="total")
    for tp, jp in zip(tparts, jparts):
        for k in ("loss_ce", "loss_bbox", "loss_giou"):
            _close(tp[k], jp[k], where=k)
    _close(tlg.grad, jgrads[0], where="d logits")
    _close(tbx.grad, jgrads[1], where="d boxes")


def test_pair_cost_coder_and_sampler_match_jax():
    rng = np.random.default_rng(2)
    n, g, v = 6, 3, 7
    verb = rng.uniform(0.01, 0.99, (n, v)).astype(np.float32)
    obj = rng.uniform(0, 1, (n, 5)).astype(np.float32)
    bh, bo = _boxes_cxcywh(rng, n), _boxes_cxcywh(rng, n)
    gv = (rng.uniform(size=(g, v)) > 0.6).astype(np.float32)
    go = rng.integers(0, 5, g)
    gbh, gbo = _boxes_cxcywh(rng, g), _boxes_cxcywh(rng, g)
    args = (verb, obj, bh, bo, gv, go, gbh, gbo)
    _close(tm.pair_matching_cost(*map(torch.as_tensor, args)),
           jm.pair_matching_cost(*map(jnp.asarray, args)))
    coder, jcoder = tm.BoxPairCoder(), jm.BoxPairCoder()
    t_args = [torch.as_tensor(a) for a in (bh, bo, gbh[[0, 1, 2, 0, 1, 2]],
                                           gbo[[2, 1, 0, 2, 1, 0]])]
    deltas = coder.encode(*t_args)
    _close(deltas, jcoder.encode(*[jnp.asarray(a.numpy()) for a in t_args]))
    for got, want in zip(coder.decode(t_args[0], t_args[1], deltas),
                         jcoder.decode(jnp.asarray(bh), jnp.asarray(bo),
                                       jnp.asarray(deltas.numpy()))):
        _close(got, want)
    _close(coder.decode(t_args[0], t_args[1], deltas)[0], t_args[2])
    labels = (rng.uniform(size=40) > 0.7).astype(np.float32)
    for fraction in (0.25, 0.9):
        got = tm.balanced_box_sample(labels, 16, fraction,
                                     np.random.default_rng(3))
        want = jm.balanced_box_sample(labels, 16, fraction,
                                      np.random.default_rng(3))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_remat_backbone_changes_no_gradient():
    """Each bottleneck under torch.utils.checkpoint: the same loss and
    gradients, bit for bit, as the plain forward."""
    cfg = TDETRConfig(**NARROW, num_classes=5)
    params = tdetr_model.init_detr_params(torch.Generator().manual_seed(0),
                                          cfg)
    images = torch.randn((2, 3, 64, 64), generator=torch.Generator()
                         .manual_seed(1))
    mask = torch.zeros((2, 64, 64), dtype=torch.bool)
    mask[1, :, 48:] = True
    grads = []
    for remat in (False, True):
        for _, t in named_leaves(params):
            t.grad = None
            t.requires_grad_(True)
        c = TDETRConfig(**NARROW, num_classes=5, remat_backbone=remat)
        out = tdetr_model.detr_forward(params, images, mask, c)
        (out["aux_logits"].square().sum() + out["aux_boxes"].sum()).backward()
        grads.append([t.grad.clone() for _, t in named_leaves(params)])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


# ---------------------------------------------------------------- the CLIs
@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    return make_fixture.build(str(tmp_path_factory.mktemp("fx")),
                              n_images=5, seed=1)


def _small_data(monkeypatch, module, factory_module):
    monkeypatch.setattr(module, "DataFactory", functools.partial(
        factory_module.DataFactory, clip_resolution=32,
        transform_kwargs=TRANSFORM))
    monkeypatch.setattr(factory_module, "DEFAULT_BUCKETS", BUCKETS)


def test_train_detr_epoch_matches_jax(fixture, tmp_path, monkeypatch):
    """One epoch (two steps at batch 2, aux losses on, the coefficient and
    schedule flags set) from the JAX CLI's initial weights: the epoch's
    mean loss and every parameter after it against the JAX CLI's; then
    --resume of the port's checkpoint runs the next epoch."""
    monkeypatch.chdir(tmp_path)
    _small_data(monkeypatch, jtd, jfactory)
    _small_data(monkeypatch, ttd, tfactory)
    monkeypatch.setattr(jtd, "DETRConfig",
                        functools.partial(jdetr.DETRConfig, **NARROW))
    monkeypatch.setattr(ttd, "DETRConfig",
                        functools.partial(TDETRConfig, **NARROW))
    seed = 4
    record = {}

    def jax_init(key, cfg):
        record["init"] = jdetr.init_detr_params(key, cfg)
        return record["init"]

    def jax_run_epoch(*args, **kw):
        out = jrun(*args, **kw)
        record["params"], _, record["loss"] = out
        return out
    jrun = jtd.run_epoch
    monkeypatch.setattr(jtd, "init_detr_params", jax_init)
    monkeypatch.setattr(jtd, "run_epoch", jax_run_epoch)
    monkeypatch.setattr(ttd, "init_detr_params", lambda gen, cfg: to_torch(
        jax.tree.map(np.asarray, record["init"])))
    argv = ["--data-root", fixture, "--epochs", "1", "--batch-size", "2",
            "--max-gt", "4", "--set-cost-class", "2.0", "--eos-coef", "0.2",
            "--lr-drop", "1", "--lr", "1e-3", "--seed", str(seed)]
    jtd.main(argv + ["--output-dir", str(tmp_path / "j")])
    params, loss = ttd.main(argv + ["--output-dir", str(tmp_path / "t")],
                            device="cpu")
    assert np.isfinite(loss)
    assert abs(loss - record["loss"]) <= 1e-4 * max(1.0, abs(loss))
    want = dict(named_leaves(to_torch(jax.tree.map(np.asarray,
                                                   record["params"]))))
    got = dict(named_leaves(params))
    assert got.keys() == want.keys() and len(got) > 200
    init = dict(named_leaves(to_torch(jax.tree.map(np.asarray,
                                                   record["init"]))))
    for path, t in got.items():
        # Adam steps of at most lr (1e-3, then 1e-4 after the drop)
        _close(t, want[path], 2e-4, path)
    moved = [p for p in got if not torch.equal(got[p].detach(), init[p])]
    assert any(p[0] == "backbone" for p in moved) and \
        any(p[0] == "class_embed" for p in moved)
    # the port's own checkpoint resumes into the next epoch
    params2, loss2 = ttd.main(argv[:2] + ["--epochs", "2"] + argv[4:] + [
        "--output-dir", str(tmp_path / "t"), "--resume",
        str(tmp_path / "t")], device="cpu")
    assert np.isfinite(loss2)
    assert sorted(os.listdir(tmp_path / "t")) == ["ckpt_00000001.pt",
                                                  "ckpt_00000002.pt"]


class _Stop(Exception):
    pass


def test_train_detr_keeps_the_kernels_off(fixture, tmp_path, monkeypatch):
    """The finetune's DETR (drawn, and converted from a file) runs with
    the fused encoder attention and ResNet tail off and remat on, as the
    JAX CLI's: K1 and K2 are not launched on this path."""
    seen = []

    def record(cfg, *args, **kw):
        seen.append(cfg)
        raise _Stop
    monkeypatch.setattr(ttd, "detr_train_step_fns", record)
    _small_data(monkeypatch, ttd, tfactory)
    pth = str(tmp_path / "detr.pth")
    # the converter infers the width and the queries, and takes 6 + 6
    # layers
    torch.save({"model": detr_state_dict(TDETRConfig(
        hidden_dim=64, dim_feedforward=64, num_queries=8))}, pth)
    for extra in ([], ["--pretrained", pth]):
        with pytest.raises(_Stop):
            ttd.main(["--data-root", fixture, "--output-dir",
                      str(tmp_path / "out")] + extra, device="cpu")
    assert len(seen) == 2
    for cfg in seen:
        assert not cfg.fused_encoder_attention
        assert cfg.fused_resnet_tail == () and cfg.remat_backbone


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_detections_cli_matches_jax(fixture, tmp_path, monkeypatch):
    """gt, eval, dump (a DETR file both packages convert), eval of the
    dump, vis and remap: the port's files against the JAX CLI's."""
    monkeypatch.chdir(tmp_path)
    _small_data(monkeypatch, jdc, jfactory)
    _small_data(monkeypatch, tdc, tfactory)
    pth = str(tmp_path / "detr.pth")
    torch.save({"model": detr_state_dict(
        TDETRConfig(hidden_dim=64, dim_feedforward=128, num_queries=12),
        seed=2, spread=6.0)}, pth)

    def both(task, *argv, out=None):
        res = {}
        for name, main in (("jax", jdc.main),
                           ("port", lambda a: tdc.main(a, device="cpu"))):
            extra = ["--out-dir", str(tmp_path / name / out)] if out else []
            res[name] = main([task, "--data-root", fixture, *argv, *extra])
        return res

    both("gt", out="gt")
    names = sorted(os.listdir(tmp_path / "jax/gt"))
    assert len(names) == 5 and names == sorted(os.listdir(tmp_path /
                                                          "port/gt"))
    for n in names:
        assert _read(tmp_path / "jax/gt" / n) == _read(tmp_path / "port/gt"
                                                       / n)
    ap = both("eval", "--det-dir", str(tmp_path / "port/gt"))
    _close(ap["port"], ap["jax"], 1e-6)
    assert float(ap["port"][ap["port"] > 0].mean()) == 1.0

    both("dump", "--pretrained", pth, "--batch-size", "2", out="det")
    n_det = 0
    for n in names:
        got = json.load(open(tmp_path / "port/det" / n))
        want = json.load(open(tmp_path / "jax/det" / n))
        assert got["labels"] == want["labels"]
        _close(got["scores"], want["scores"])
        _close(got["boxes"], want["boxes"])
        n_det += len(got["labels"])
    assert n_det == 5 * 12
    ap = {k: jdc.main(["eval", "--data-root", fixture, "--det-dir",
                       str(tmp_path / k / "det")]) for k in ("jax", "port")}
    _close(ap["port"], ap["jax"], 1e-6)
    ap_port = tdc.main(["eval", "--data-root", fixture, "--det-dir",
                        str(tmp_path / "port/det")], device="cpu")
    _close(ap_port, ap["port"], 1e-6)

    both("vis", "--limit", "2", out="vis")
    for root, _, files in os.walk(tmp_path / "jax/vis"):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), tmp_path / "jax")
            assert _read(os.path.join(root, f)) == _read(tmp_path / "port" /
                                                         rel)
    label_map = {str(i): 79 - i for i in range(0, 80, 2)}
    with open(tmp_path / "map.json", "w") as f:
        json.dump(label_map, f)
    for name, main in (("jax", jdc.main), ("port", tdc.main)):
        main(["remap", "--det-dir", str(tmp_path / "jax/det"),
              "--label-map", str(tmp_path / "map.json"), "--out-dir",
              str(tmp_path / name / "remap")])
    for n in names:
        assert _read(tmp_path / "jax/remap" / n) == \
            _read(tmp_path / "port/remap" / n)
