"""A HICO-DET evaluation from a dataset on disk to its mAP, in the port and
in the JAX package, on the CPU, from the same weights.

JAX: ``batches_from_factory`` -> the jitted ``make_eval_step`` (its
outputs sliced to the batch's real rows, as the JAX ``main`` does) ->
``evaluate_hico``. The port: ``eval_batches`` (``batches_from_factory``
and ``make_eval_step(device="cpu")`` inside) -> ``evaluate_hico``. The
model is the tiny eval configuration of ``torch_port_common`` at 600
classes; the transforms resize to a min side of 48 (max 80) and pad into
the buckets (56, 80), (80, 56) and (80, 80).
"""
import dataclasses

import jax
import numpy as np
import pytest

import tools.make_fixture as make_fixture
from hoigen_tpu.cli import main_finetune as jcli
from hoigen_tpu.data import factory as jfactory
from hoigen_tpu.engine import eval as jeval
from hoigen_tpu.engine import hoi_model as jhm
from hoigen_tpu.labels import HICO as JHICO
from hoigen_tpu.models.cache import random_caches
from hoigen_tpu.utils.config import RunConfig as JRunConfig

from hoigen_tpu_torch.cli.main_finetune import eval_batches
from hoigen_tpu_torch.data import factory as tfactory
from hoigen_tpu_torch.engine import eval as teval
from hoigen_tpu_torch.engine import hoi_model as thm
from hoigen_tpu_torch.labels import HICO as THICO
from hoigen_tpu_torch.tools.make_hicodet import \
    annotate_from_detections, write_hicodet
from hoigen_tpu_torch.utils.config import RunConfig as TRunConfig

from torch_port_common import eval_configs, eval_models

TINY = dict(eval_min_side=48, max_side=80)
BUCKETS = ((56, 80), (80, 56), (80, 80))


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = eval_configs(num_classes=600)
    return (jcfg, tcfg) + eval_models(
        jcfg, random_caches(600, 2, num_objects=80))


def _evaluate(models, root, batch_size, monkeypatch):
    """((JAX outputs, port outputs) per batch, (JAX result, port result),
    the batches' image shapes)."""
    jcfg, tcfg, jax_model, port_model = models
    for m in (jfactory, tfactory):
        monkeypatch.setattr(m, "DEFAULT_BUCKETS", BUCKETS)
    kw = dict(training=False, clip_resolution=32, transform_kwargs=TINY,
              host_clip_stream=False)
    run = dict(batch_size=batch_size, num_classes=600, num_workers=2)
    runs, results = [], []

    # JAX: the eval loop of its main, without a mesh
    test = jfactory.DataFactory("hicodet", "test2015", root, **kw)
    train = jfactory.DataFactory("hicodet", "train2015", root, **kw)
    step = jax.jit(jhm.make_eval_step(jcfg))
    shapes, jruns = [], []
    for d, batch in jcli.batches_from_factory(test, batch_size,
                                              JRunConfig(**run),
                                              shuffle=False, pad_tail=True):
        out = step(*jax_model, d)
        shapes.append(d["images"].shape)
        jruns.append(({k: np.asarray(v)[:batch.n_real]
                       for k, v in out.items()},
                      jfactory.slice_batch(batch, batch.n_real)))
    runs.append(jruns)
    results.append(jeval.evaluate_hico(
        iter(jruns), test.dataset, 600, jcfg.upt.proposals,
        JHICO.object_n_verb_to_interaction,
        train_anno_interaction=train.dataset.anno_interaction))

    # the port
    test = tfactory.DataFactory("hicodet", "test2015", root, **kw)
    train = tfactory.DataFactory("hicodet", "train2015", root, **kw)
    truns = list(eval_batches(thm.make_eval_step(tcfg, device="cpu"),
                              *port_model, test, TRunConfig(**run)))
    runs.append(truns)
    results.append(teval.evaluate_hico(
        iter(truns), test.dataset, 600, tcfg.upt.proposals,
        THICO.object_n_verb_to_interaction,
        train_anno_interaction=train.dataset.anno_interaction))
    return runs, results, shapes


def _check(runs, results, n_images):
    (jruns, truns), (want, got) = runs, results
    assert len(truns) == len(jruns)
    assert sum(len(b.indices) for _, b in truns) == n_images
    for (jo, jb), (to, tb) in zip(jruns, truns):
        assert set(to) == set(jo)
        for k in jb.__dataclass_fields__:
            np.testing.assert_array_equal(getattr(tb, k), getattr(jb, k), k)
        # indices, masks and LUT gathers are exact
        for k in ("pair_valid", "objects", "detection_verbs"):
            np.testing.assert_array_equal(to[k], jo[k], k)
        # f32 on both sides: 2e-4 of the scale, the transformer tolerance
        # of the JAX package's full-dims suite
        for k in ("boxes", "detection_scores"):
            scale = max(1.0, float(np.abs(jo[k]).max()))
            np.testing.assert_allclose(to[k], jo[k], rtol=0,
                                       atol=2e-4 * scale, err_msg=k)
        assert (to["detection_scores"] > 0).any()
    assert set(got) == set(want)
    np.testing.assert_allclose(got["ap"], want["ap"], rtol=0, atol=1e-6)
    for k in ("mAP", "mAP_rare", "mAP_non_rare"):
        assert abs(got[k] - want[k]) <= 1e-6, k
    assert got["ap"].shape == (600,)


def test_evaluation_from_disk_matches_jax(models, tmp_path, monkeypatch):
    """Six images of both orientations, batch 4: one batch mixes the two
    (the (80, 80) bucket), the last is padded from 2 real rows to 4."""
    root = write_hicodet(str(tmp_path), [(64, 48), (48, 64), (64, 48),
                                         (64, 48), (48, 64), (48, 64)],
                         seed=9)
    runs, _, _ = _evaluate(models, root, 4, monkeypatch)
    # the random model's own detections as the ground truth, so that the
    # AP is not zero
    assert annotate_from_detections(root, runs[1], models[1].upt.proposals)
    runs, results, shapes = _evaluate(models, root, 4, monkeypatch)
    assert shapes == [(4, 3, 80, 80), (4, 3, 80, 56)]
    _check(runs, results, 6)
    assert results[1]["ap"].max() > 0.5


def test_evaluation_with_tail_padding_matches_jax(models, tmp_path,
                                                  monkeypatch):
    """The JAX package's own fixture (five 64x48 images), batch 2: the
    third batch holds one real row and one copy of it, which must not
    reach the meter."""
    root = make_fixture.build(str(tmp_path), n_images=5, seed=1)
    runs, results, shapes = _evaluate(models, root, 2, monkeypatch)
    assert shapes == [(2, 3, 56, 80)] * 3
    assert [len(b.indices) for _, b in runs[1]] == [2, 2, 1]
    _check(runs, results, 5)


def test_eval_batches_yields_one_batch_behind(models, tmp_path):
    """Batch N reaches the caller after step N + 1 has run (the JAX loop's
    lookahead), and its outputs are already numpy."""
    _, tcfg, _, port_model = models
    root = write_hicodet(str(tmp_path), [(64, 48)] * 3, seed=2)
    factory = tfactory.DataFactory("hicodet", "test2015", root,
                                   training=False, clip_resolution=32,
                                   transform_kwargs=TINY,
                                   host_clip_stream=False)
    calls = []
    step = thm.make_eval_step(tcfg, device="cpu")

    def counting_step(*args):
        calls.append(len(calls))
        return step(*args)

    seen = []
    cfg = dataclasses.replace(TRunConfig(), batch_size=1, num_classes=600)
    for out, batch in eval_batches(counting_step, *port_model, factory, cfg):
        assert isinstance(out["detection_scores"], np.ndarray)
        seen.append((len(calls), int(batch.indices[0])))
    assert seen == [(2, 0), (3, 1), (3, 2)]
