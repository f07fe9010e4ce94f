"""The port's train / eval / cache CLI (``hoigen_tpu_torch/cli/
main_finetune.py``) against the JAX package's, on the CPU.

Host pieces first, bit for bit: the cache builders, the prior multihot,
the model configuration. Then ``main`` itself on the JAX CLI tests' 5-image
fixture (``tools/make_fixture.py::build``) with the tiny model of
``tests/test_cli_main.py``, from checkpoint files the test writes
(``hoigen_tpu_torch/tools/make_checkpoints.py``: CLIP and DETR state
dicts, a pair-embedding pickle): ``--cache`` writes the JAX CLI's files
and ``--eval`` gives its mAP. Each package draws the UPT head's prior MLP
and CLIP's missing adapters from its own generator, so a wrapper around
the port's ``init_hoi_model`` hands those leaves over from the JAX run,
after checking that every leaf read from a file is already the JAX one.
Last, the port's own train -> resume -> eval round trip, V-COCO and the
refusals.
"""
import dataclasses
import filecmp
import functools
import os

import jax
import numpy as np
import pytest
import scipy.io as sio
import torch

import tools.make_fixture as make_fixture
from hoigen_tpu.cli import main_finetune as jmf
from hoigen_tpu.data import factory as jfactory
from hoigen_tpu.labels import HICO as JHICO
from hoigen_tpu.models import cache as jcache
from hoigen_tpu.utils.config import RunConfig as JRunConfig

from hoigen_tpu_torch.bridge import to_torch
from hoigen_tpu_torch.cli import main_finetune as tmf
from hoigen_tpu_torch.data import factory as tfactory
from hoigen_tpu_torch.engine import hoi_model as thm
from hoigen_tpu_torch.engine.partition import named_leaves
from hoigen_tpu_torch.models import cache as tcache
from hoigen_tpu_torch.models.clip.config import CLIPConfig as TCLIPConfig
from hoigen_tpu_torch.models.detr.config import DETRConfig as TDETRConfig
from hoigen_tpu_torch.models.proposals import ProposalConfig as \
    TProposalConfig
from hoigen_tpu_torch.models.upt import UPTConfig as TUPTConfig
from hoigen_tpu_torch.tools import make_checkpoints, make_vcoco
from hoigen_tpu_torch.tools.make_hicodet import annotate_from_detections
from hoigen_tpu_torch.utils.config import RunConfig as TRunConfig

from test_cli_main import _tiny_model_config as _jax_tiny_model_config

TRANSFORM = dict(eval_min_side=48, max_side=80, train_scales=(40, 48, 56),
                 crop_resize_choices=(56, 64), crop_range=(32, 64))
BUCKETS = ((56, 80), (80, 56), (80, 80))
TEXT_TOL = 2e-4


# -------------------------------------------------------------- cache builders
@pytest.fixture(scope="module")
def pairs():
    return make_checkpoints.pair_annotations(
        [f"im_{i}.jpg" for i in range(300)], seed=4)


def _assert_caches_equal(got, want):
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(want, f.name), f.name)
        assert getattr(got, f.name).dtype == getattr(want, f.name).dtype


@pytest.mark.parametrize("num_classes,num_shot,label_choice,zs", [
    (117, 2, "random", False), (117, 3, "multi_first", False),
    (117, 2, "single_first", True), (117, 4, "single+multi", False),
    (117, 2, "rare_first", False), (600, 3, "non_rare_first", True),
    (600, 2, "rare+non_rare", False), (600, 2, "random", True)])
def test_build_pair_cache_matches_jax(pairs, num_classes, num_shot,
                                      label_choice, zs):
    """Per-class shots, padding, multi-hot merging, the zero-shot filter
    and its random backfill, every label_choice policy: bit for bit."""
    filtered = JHICO.unseen_index["rare_first"] if zs else []
    anno = np.random.default_rng(1).integers(0, 50, num_classes)
    obj_to_verb = [[] for _ in range(80)]
    for hoi, obj, verb in JHICO.class_corr:
        if hoi not in set(filtered):
            obj_to_verb[obj].append(verb)
    kw = dict(filtered_hoi_idx=filtered, use_multi_hot=label_choice != "random",
              label_choice=label_choice, num_anno=anno, seed=7)
    args = (num_classes, num_shot, JHICO.object_n_verb_to_interaction,
            obj_to_verb)
    want = jcache.build_pair_cache(pairs, *args, **kw)
    got = tcache.build_pair_cache(pairs, *args, **kw)
    _assert_caches_equal(got, want)
    assert (got.counts > 0).all() and got.one_hots.sum() > 0


@pytest.mark.parametrize("num_classes", [117, 600])
def test_gen_and_global_caches_match_jax(num_classes):
    rng = np.random.default_rng(2)
    n = 3 * 600
    feats = rng.normal(size=(3 * n, 512)).astype(np.float32)
    targets = np.tile(np.arange(600), 9).astype(np.int32)
    to_class = np.asarray(JHICO.hoi_to_verb) if num_classes == 117 \
        else np.arange(600)
    counts = rng.integers(0, 3, num_classes).astype(np.int32)
    for c in (counts, None):
        _assert_caches_equal(
            tcache.build_gen_cache(feats, targets, to_class, num_classes, 2,
                                   counts=c, seed=5),
            jcache.build_gen_cache(feats, targets, to_class, num_classes, 2,
                                   counts=c, seed=5))
    img = rng.normal(size=(40, 512)).astype(np.float32)
    hot = (rng.random((40, num_classes)) > 0.97).astype(np.float32)
    for got, want in zip(tcache.build_global_cache(img, hot, num_classes, 2,
                                                   seed=3),
                         jcache.build_global_cache(img, hot, num_classes, 2,
                                                   seed=3)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def test_refresh_unseen_cache_and_pair_pickle_match_jax(pairs, tmp_path):
    rng = np.random.default_rng(3)
    cache = rng.normal(size=(600 * 2, 512)).astype(np.float32)
    counts = rng.integers(0, 3, 600)
    text = rng.normal(size=(600, 512)).astype(np.float32)
    unseen = JHICO.unseen_index["rare_first"]
    seen = [i for i in range(600) if i not in set(unseen)]
    got = tcache.refresh_unseen_cache(cache, counts, text, seen, unseen, 2)
    np.testing.assert_array_equal(
        got, jcache.refresh_unseen_cache(cache, counts, text, seen, unseen,
                                         2))
    assert not np.array_equal(got, cache)
    import pickle
    path = tmp_path / "pairs.p"
    with open(path, "wb") as f:
        pickle.dump(pairs, f)
    back = tcache.load_pair_annotations(str(path))
    assert back.keys() == pairs.keys()
    np.testing.assert_array_equal(back["im_7.jpg"]["union_features"],
                                  pairs["im_7.jpg"]["union_features"])


@pytest.mark.parametrize("num_classes", [117, 600])
@pytest.mark.parametrize("zs_type", ["rare_first", "non_rare_first",
                                     "unseen_verb"])
def test_hico_prior_multihot_matches_jax(num_classes, zs_type):
    for zs in (False, True):
        for evaluating in (False, True):
            filtered = JHICO.unseen_index[zs_type] if zs else []
            got = tmf.hico_prior_multihot(num_classes, zs, evaluating,
                                          filtered, zs_type=zs_type)
            want = jmf.hico_prior_multihot(num_classes, zs, evaluating,
                                           filtered, zs_type=zs_type)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flags", [
    {}, {"dataset": "vcoco", "num_classes": 24},
    {"adapter_pos": "random", "adapter_num_layers": 2, "dtype": "bfloat16"},
    {"use_insadapter": False, "num_classes": 600, "eval": True},
    {"use_pallas_cache": 1, "zs": True, "max_instances": 10}])
def test_make_model_config_matches_jax(flags):
    """Every field of the port's configuration has the JAX CLI's value
    (the JAX one on the CPU backend); the fused cache is on where the run
    is on CUDA unless the flag says otherwise."""
    got = tmf.make_model_config(TRunConfig(**flags), "cpu")
    want = jmf.make_model_config(JRunConfig(**flags))

    def check(a, b, where):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if dataclasses.is_dataclass(x):
                check(x, y, f"{where}.{f.name}")
            else:
                assert x == y, f"{where}.{f.name}: {x} != {y}"
    check(got, want, "cfg")
    cuda = tmf.make_model_config(TRunConfig(**flags)).upt.use_pallas_cache
    assert cuda == (True if "use_pallas_cache" not in flags else
                    bool(flags["use_pallas_cache"]))


# --------------------------------------------------------------------- main
def _port_tiny_model_config(cfg, device=None):
    """The port's counterpart of ``test_cli_main._tiny_model_config``."""
    return thm.HOIModelConfig(
        clip=TCLIPConfig(image_resolution=32, vision_layers=2,
                         vision_width=64, vision_patch_size=8,
                         transformer_layers=2, transformer_width=64,
                         context_length=77, adapter_layers=(0, 1)),
        detr=TDETRConfig(hidden_dim=64, nheads=2, enc_layers=2, dec_layers=2,
                         dim_feedforward=128, num_queries=12,
                         num_classes=81 if cfg.dataset == "hicodet" else 92),
        upt=TUPTConfig(num_classes=cfg.num_classes, num_shot=cfg.num_shot,
                       clip_resolution=32, use_dino=False,
                       use_clip_global=cfg.clip_global,
                       cache_model=cfg.cache_model,
                       proposals=TProposalConfig(max_instances=4),
                       max_gt_pairs=cfg.max_gt_pairs,
                       generate_feature=False))


def _patch_port(monkeypatch):
    monkeypatch.setattr(tmf, "make_model_config", _port_tiny_model_config)
    monkeypatch.setattr(tmf, "DataFactory", functools.partial(
        tfactory.DataFactory, clip_resolution=32, transform_kwargs=TRANSFORM))
    monkeypatch.setattr(tfactory, "DEFAULT_BUCKETS", BUCKETS)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The 5-image fixture and the checkpoint files of the tiny model (its
    12 queries need the box head spread by 100 to give distinct boxes)."""
    root = tmp_path_factory.mktemp("cli")
    data = make_fixture.build(str(root / "data"), n_images=5, seed=1)
    cfg = _port_tiny_model_config(TRunConfig())
    paths = make_checkpoints.write_checkpoints(
        str(root / "ckpt"), cfg.clip, cfg.detr, seed=0,
        image_names=[f"im_{i}.jpg" for i in range(5)], dino=False,
        spread=100.0)
    return data, paths


def _common(files, out, **kw):
    data, paths = files
    return dict(dict(data_root=data, output_dir=out, batch_size=2,
                     num_workers=2, num_classes=600, dino=False,
                     generate_feature=False, max_gt_pairs=4, devices=1,
                     print_interval=1, epochs=1, seed=3,
                     clip_model_path=paths["clip"],
                     pretrained_detr=paths["detr"], file1=paths["pairs"]),
                **kw)


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _merge(trainable, frozen):
    if isinstance(trainable, dict):
        return {k: _merge(trainable[k], frozen[k]) for k in trainable}
    if isinstance(trainable, (list, tuple)):
        return [_merge(a, b) for a, b in zip(trainable, frozen)]
    return frozen if trainable is None else trainable


# leaves computed from the text tower's encodes: within TEXT_TOL
_FROM_TEXT = {("upt", "text_w"), "origin_text_embeddings", "object_embedding"}


def _hand_over(monkeypatch):
    """Record the JAX CLI's init_hoi_model; around the port's, check the
    leaves read from files (bit for bit) and the text encodes (2e-4), then
    hand over the leaves each package draws from its own generator.
    Returns the record."""
    record = {}
    j_init, t_init = jmf.init_hoi_model, tmf.init_hoi_model

    def jax_init(*args, **kw):
        record["jax"] = j_init(*args, **kw)
        return record["jax"]

    def port_init(*args, **kw):
        params, buffers = t_init(*args, **kw)
        trainable, frozen, jbuffers = jax.tree.map(np.asarray,
                                                   record["jax"])
        want = to_torch({"upt": _merge(trainable, frozen["upt"]),
                         "detr": frozen["detr"], "dino": frozen["dino"]})
        drawn = []
        for path, t in named_leaves(params):
            w = _leaf(want, path)
            if path in _FROM_TEXT:
                np.testing.assert_allclose(t.detach().numpy(), w.numpy(),
                                           rtol=0, atol=TEXT_TOL)
            elif not torch.equal(t.detach(), w):
                # the UPT head's prior MLP and CLIP's adapters only
                assert path[0] == "upt" and (
                    path[1] == "priors_downproj" or "adapter" in path), path
                with torch.no_grad():
                    t.copy_(w)
                drawn.append(path)
        assert drawn and any("adapter" in p for p in drawn)
        jbuffers = to_torch(jbuffers)
        assert buffers.keys() == jbuffers.keys()
        for k, b in buffers.items():
            if k in _FROM_TEXT:
                np.testing.assert_allclose(b.numpy(), jbuffers[k].numpy(),
                                           rtol=0, atol=TEXT_TOL)
            else:
                assert torch.equal(b, jbuffers[k]), k
        record["drawn"] = drawn
        return params, buffers

    monkeypatch.setattr(jmf, "init_hoi_model", jax_init)
    monkeypatch.setattr(tmf, "init_hoi_model", port_init)
    return record


def _capture(monkeypatch, module, name, record, key):
    """Wrap ``module.name`` (an evaluation that takes the (outputs, batch)
    stream first) so that the stream is kept in ``record[key]``."""
    fn = getattr(module, name)

    def wrapped(runs, *args, **kw):
        record[key] = list(runs)
        return fn(iter(record[key]), *args, **kw)
    monkeypatch.setattr(module, name, wrapped)


def test_main_cache_and_eval_match_jax(files, tmp_path, monkeypatch):
    """``--cache`` writes the JAX CLI's 80 .mat files (indices equal,
    boxes and scores within 2e-4 of their scale), then, on ground truth
    rewritten from those detections, ``--eval`` gives the JAX CLI's AP
    vector and mAP within 1e-6."""
    monkeypatch.chdir(tmp_path)
    _patch_port(monkeypatch)
    monkeypatch.setattr(jmf, "make_model_config", _jax_tiny_model_config)
    monkeypatch.setattr(jmf, "DataFactory", functools.partial(
        jfactory.DataFactory, clip_resolution=32,
        transform_kwargs=TRANSFORM))
    monkeypatch.setattr(jfactory, "DEFAULT_BUCKETS", BUCKETS)
    record = _hand_over(monkeypatch)
    for module, name in ((jmf, "cache_hico"), (tmf, "cache_hico"),
                         (jmf, "evaluate_hico"), (tmf, "evaluate_hico")):
        _capture(monkeypatch, module, name, record,
                 f"{module.__name__.split('.')[0]}.{name}")

    jout, tout = str(tmp_path / "jax_cache"), str(tmp_path / "port_cache")
    assert jmf.main(JRunConfig(**_common(files, jout, cache=True))) is None
    assert tmf.main(TRunConfig(**_common(files, tout, cache=True)),
                    device="cpu") is None
    mats = sorted(f for f in os.listdir(jout) if f.endswith(".mat"))
    assert len(mats) == 80
    assert sorted(f for f in os.listdir(tout) if f.endswith(".mat")) == mats
    n_rows = 0
    for name in mats:
        got = sio.loadmat(os.path.join(tout, name))["all_boxes"]
        want = sio.loadmat(os.path.join(jout, name))["all_boxes"]
        assert got.shape == want.shape
        for g, w in zip(got.ravel(), want.ravel()):
            assert g.shape == w.shape, name
            if w.size:
                scale = max(1.0, float(np.abs(w).max()))
                np.testing.assert_allclose(g, w, rtol=0, atol=2e-4 * scale)
                n_rows += len(w)
    assert n_rows > 0

    # the detections as the ground truth, so that the AP is not zero
    data, _ = files
    assert annotate_from_detections(data, record["hoigen_tpu_torch."
                                                 "cache_hico"],
                                    _port_tiny_model_config(
                                        TRunConfig()).upt.proposals)
    want = jmf.main(JRunConfig(**_common(files, jout, eval=True)))
    got = tmf.main(TRunConfig(**_common(files, tout, eval=True)),
                   device="cpu")
    jruns, truns = record["hoigen_tpu.evaluate_hico"], \
        record["hoigen_tpu_torch.evaluate_hico"]
    assert len(jruns) == len(truns) == 3
    for (jo, jb), (to, tb) in zip(jruns, truns):
        np.testing.assert_array_equal(tb.indices, jb.indices)
        for k in ("pair_valid", "objects", "detection_verbs"):
            np.testing.assert_array_equal(to[k], jo[k], k)
    np.testing.assert_allclose(got["ap"], want["ap"], rtol=0, atol=1e-6)
    for k in ("mAP", "mAP_rare", "mAP_non_rare"):
        assert abs(got[k] - want[k]) <= 1e-6, k
    assert got["ap"].max() > 0.5


def test_main_train_resume_eval_round_trip(files, tmp_path, monkeypatch):
    """The port's own loop: train an epoch (2 steps, the tail dropped),
    resume to a second, evaluate from the checkpoint (tail padded), and
    take the branches --sanity, --frozen-classifier and
    --training-set-ratio."""
    monkeypatch.chdir(tmp_path)
    _patch_port(monkeypatch)
    out = str(tmp_path / "run")
    common = _common(files, out, num_classes=117)
    trainer = tmf.main(TRunConfig(**common), device="cpu")
    assert trainer.epoch == 1 and trainer.iteration == 2
    ckpt = os.path.join(out, "ckpt_00000002.pt")
    assert os.path.isfile(ckpt)
    trained = trainer.params["upt"]["adapter_H_w"].detach().clone()

    trainer2 = tmf.main(TRunConfig(**{**common, "epochs": 2,
                                      "resume": out}), device="cpu")
    assert trainer2.epoch == 2 and trainer2.iteration == 4
    assert not torch.equal(trainer2.params["upt"]["adapter_H_w"], trained)

    seen = {}
    step = tmf.make_eval_step

    def recording_eval_step(cfg, device=None):
        inner = step(cfg, device)

        def run(params, buffers, batch):
            seen["adapter_H_w"] = params["upt"]["adapter_H_w"]
            return inner(params, buffers, batch)
        return run
    monkeypatch.setattr(tmf, "make_eval_step", recording_eval_step)
    result = tmf.main(TRunConfig(**{**common, "eval": True, "resume": ckpt}),
                      device="cpu")
    assert result["ap"].shape == (600,) and np.isfinite(result["mAP"])
    assert torch.equal(seen["adapter_H_w"], trained)

    metrics = tmf.main(TRunConfig(**{**common, "sanity": True}),
                       device="cpu")
    assert np.isfinite(float(metrics["loss"]))
    frozen = tmf.main(TRunConfig(**{
        **common, "output_dir": str(tmp_path / "frozen"),
        "frozen_classifier": "U+T", "training_set_ratio": 0.8,
        "num_workers": 0}), device="cpu")
    assert not frozen.params["upt"]["adapter_U_w"].requires_grad
    assert not frozen.params["upt"]["text_w"].requires_grad
    assert frozen.params["upt"]["adapter_H_w"].requires_grad
    assert frozen.iteration == 2         # 4 of 5 images, batch 2


def test_main_resumes_a_reference_checkpoint(files, tmp_path, monkeypatch):
    """--resume of a reference ``.pt``: the head's tensors in it reach the
    evaluated model (the rest keeps the converted files' weights)."""
    monkeypatch.chdir(tmp_path)
    _patch_port(monkeypatch)
    text_w = torch.randn(117, 512, generator=torch.Generator().manual_seed(1))
    path = tmp_path / "reference.pt"
    torch.save({"model_state_dict": {"module.adapter_union_weight": text_w,
                                     "logit_scale_text": torch.tensor(2.5)}},
               path)
    seen = {}
    step = tmf.make_eval_step

    def recording_eval_step(cfg, device=None):
        inner = step(cfg, device)

        def run(params, buffers, batch):
            seen.update(text_w=params["upt"]["text_w"],
                        scale=params["upt"]["logit_scale_T"])
            return inner(params, buffers, batch)
        return run
    monkeypatch.setattr(tmf, "make_eval_step", recording_eval_step)
    cfg = TRunConfig(**_common(files, str(tmp_path / "out"), num_classes=117,
                               eval=True, resume=str(path)))
    tmf.main(cfg, device="cpu")
    assert torch.equal(seen["text_w"], text_w)
    assert float(seen["scale"].detach()) == 2.5
    assert seen["text_w"].requires_grad
    assert cfg.resume == ""


def test_main_vcoco_eval_and_cache(tmp_path, monkeypatch):
    """V-COCO from disk (``tools/make_vcoco.py``, the JAX fixture's files
    byte for byte): --eval gives the role-AP report (above zero on ground
    truth rewritten from the detections), --cache the pickle."""
    root = make_vcoco.build_vcoco(str(tmp_path / "vcoco"), n_images=5,
                                  seed=2)
    ref = make_fixture.build_vcoco(str(tmp_path / "ref"), n_images=5, seed=2)
    for part in ("trainval", "test"):
        assert filecmp.cmp(f"{root}/instances_vcoco_{part}.json",
                           f"{ref}/instances_vcoco_{part}.json",
                           shallow=False)
    assert filecmp.cmp(f"{root}/images/val2014/COCO_val2014_000000000004.jpg",
                       f"{ref}/images/val2014/COCO_val2014_000000000004.jpg",
                       shallow=False)
    monkeypatch.chdir(tmp_path)
    _patch_port(monkeypatch)
    # a COCO detector: 92 logits, the person in slot 1; its box head
    # spread by 6 (by more, its boxes at 64 x 48 pixels have no area)
    model = _port_tiny_model_config(TRunConfig(dataset="vcoco"))
    paths = make_checkpoints.write_checkpoints(
        str(tmp_path / "ckpt"), model.clip, model.detr, seed=1, dino=False,
        spread=6.0, human=1)
    common = dict(dataset="vcoco", data_root=root, num_classes=24,
                  batch_size=2, num_workers=0, dino=False,
                  generate_feature=False, max_gt_pairs=4, seed=3,
                  output_dir=str(tmp_path / "out"),
                  clip_model_path=paths["clip"],
                  pretrained_detr=paths["detr"])
    record = {}
    _capture(monkeypatch, tmf, "evaluate_vcoco", record, "runs")
    report = tmf.main(TRunConfig(**common, eval=True), device="cpu")
    for k in ("role_ap_scenario_1", "role_ap_scenario_2", "agent_ap"):
        assert np.isfinite(report[k]["mean"])
    # the detections as the ground truth: the APs are no longer zero
    assert make_vcoco.annotate_vcoco_from_detections(
        root, record["runs"], model.upt.proposals)
    report = tmf.main(TRunConfig(**common, eval=True), device="cpu")
    assert report["agent_ap"]["mean"] > 0.3
    assert report["role_ap_scenario_1"]["mean"] > 0.3
    tmf.main(TRunConfig(**common, cache=True), device="cpu")
    assert os.path.isfile(tmp_path / "out" / "cache.pkl")


def test_main_refuses_what_it_cannot_run(monkeypatch, tmp_path):
    """No card and no device="cpu": it raises rather than run on the CPU;
    --devices 2 where one card is visible raises before it starts a
    process."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmf.main(TRunConfig(output_dir=str(tmp_path / "o")))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="need 2 CUDA devices; 1 are"):
        tmf.main(TRunConfig(devices=2, output_dir=str(tmp_path / "o")))
    assert not os.path.exists(tmp_path / "o")


def test_main_fills_unseen_cache_rows(files, tmp_path, monkeypatch):
    """--fill-zs-verb-type 1 under zero-shot: the unseen classes' cache
    rows are blended from the seen ones (``refresh_unseen_cache``), the
    seen rows stay."""
    monkeypatch.chdir(tmp_path)
    _patch_port(monkeypatch)
    seen_caches = []
    init = tmf.init_hoi_model

    def recording_init(gen, model_cfg, caches, **kw):
        seen_caches.append(caches.cache_h.copy())
        return init(gen, model_cfg, caches, **kw)
    monkeypatch.setattr(tmf, "init_hoi_model", recording_init)
    for fill in (0, 1):
        tmf.main(TRunConfig(**_common(
            files, str(tmp_path / f"fill{fill}"), eval=True, zs=True,
            fill_zs_verb_type=fill)), device="cpu")
    plain, filled = (c.reshape(600, 2, -1) for c in seen_caches)
    unseen = np.zeros(600, bool)
    unseen[JHICO.unseen_index["rare_first"]] = True
    np.testing.assert_array_equal(filled[~unseen], plain[~unseen])
    assert not np.array_equal(filled[unseen], plain[unseen])
    np.testing.assert_array_equal(filled[unseen][:, 0], filled[unseen][:, 1])
