"""The port's data pipeline (hoigen_tpu_torch/data, utils/config.py,
cli/main_finetune.py::batches_from_factory) against the JAX package's on
the same datasets on disk.

Both decode with PIL and transform with numpy in the same order, from the
same per-sample seeds, so every sample, batch, index stream and written
file must be equal, array for array.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

import tools.make_fixture as make_fixture
from hoigen_tpu.cli import main_finetune as jcli
from hoigen_tpu.data import detections as jdet
from hoigen_tpu.data import factory as jfactory
from hoigen_tpu.data import loader as jloader
from hoigen_tpu.data import samplers as jsamplers
from hoigen_tpu.utils import config as jconfig

from hoigen_tpu_torch.cli import main_finetune as tcli
from hoigen_tpu_torch.data import detections as tdet
from hoigen_tpu_torch.data import factory as tfactory
from hoigen_tpu_torch.data import loader as tloader
from hoigen_tpu_torch.data import samplers as tsamplers
from hoigen_tpu_torch.tools.make_hicodet import write_hicodet
from hoigen_tpu_torch.utils import config as tconfig

# small transforms, so that the CPU run stays quick: eval resizes to a
# min side of 48 (max 80), training draws from small scales and crops
TINY = dict(eval_min_side=48, max_side=80, train_scales=(32, 40, 48),
            crop_resize_choices=(40, 48), crop_range=(24, 40))
SIZES = [(64, 48), (48, 64), (64, 48), (56, 56), (64, 40), (40, 64)]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    return {"hicodet": write_hicodet(str(root / "hico"), SIZES, seed=5),
            "vcoco": make_fixture.build_vcoco(str(root / "vcoco"),
                                              n_images=6, seed=6)}


def _factories(trees, name, training, **kw):
    part = {("hicodet", False): "test2015", ("hicodet", True): "train2015",
            ("vcoco", False): "test", ("vcoco", True): "trainval"}
    return [m.DataFactory(name, part[name, training], trees[name],
                          training=training, transform_kwargs=TINY,
                          clip_resolution=32, max_gt_pairs=4, seed=7, **kw)
            for m in (jfactory, tfactory)]


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{path}[{i}]")
    elif want is None:
        assert got is None, path
    else:
        w, g = np.asarray(want), np.asarray(got)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=path)


@pytest.mark.parametrize("name,training,kw", [
    ("hicodet", False, dict(host_clip_stream=False)),
    ("hicodet", False, dict(host_clip_stream=True)),
    ("hicodet", True, dict(host_clip_stream=False)),
    ("hicodet", True, dict(zero_shot=True, zs_type="rare_first",
                           num_classes=600)),
    ("vcoco", False, dict(host_clip_stream=False)),
    ("vcoco", True, dict(host_clip_stream=True)),
], ids=["hico-eval", "hico-eval-host-clip", "hico-train",
        "hico-train-zero-shot", "vcoco-eval", "vcoco-train"])
def test_factory_samples_batches_and_shapes_match_jax(trees, name, training,
                                                      kw):
    jf, tf = _factories(trees, name, training, **kw)
    assert tf.keep == jf.keep and len(tf) == len(jf) > 0
    if kw.get("zero_shot"):
        assert tf.filtered_hoi_idx == jf.filtered_hoi_idx
    for epoch in (0, 1):
        jf.set_epoch(epoch)
        tf.set_epoch(epoch)
        want = [jf[i] for i in range(len(jf))]
        got = [tf[i] for i in range(len(tf))]
        _assert_tree_equal(got, want)
        for lo in range(0, len(want), 4):
            rows = range(lo, min(lo + 4, len(want)))
            jb = jfactory.collate_batch([want[i] for i in rows], 4)
            tb = tfactory.collate_batch([got[i] for i in rows], 4)
            _assert_tree_equal(dataclasses.asdict(tb), dataclasses.asdict(jb))
            assert tf.padded_hw(rows) == jf.padded_hw(rows)
            _assert_tree_equal(
                dataclasses.asdict(tfactory.slice_batch(tb, 1)),
                dataclasses.asdict(jfactory.slice_batch(jb, 1)))
    assert tfactory.DEFAULT_BUCKETS == jfactory.DEFAULT_BUCKETS
    for hw in ((800, 1200), (1200, 800), (1000, 1000), (2000, 900)):
        assert tfactory.pick_bucket(*hw) == jfactory.pick_bucket(*hw)


@pytest.mark.parametrize("shuffle,pad_tail", [(False, True), (False, False),
                                               (True, False)])
@pytest.mark.parametrize("num_workers", [0, 2])
def test_loader_streams_match_jax(trees, shuffle, pad_tail, num_workers):
    jf, tf = _factories(trees, "hicodet", True)
    order = [m.batch_indices(len(jf), 4, shuffle, seed=3, pad_tail=pad_tail)
             for m in (jloader, tloader)]
    _assert_tree_equal(order[1], order[0])

    def stream(m, f, fac, workers):
        return [(dataclasses.asdict(b), n) for b, n in m.iter_batches(
            f.__getitem__, order[0],
            lambda s: fac.collate_batch(s, 4), num_workers=workers)]

    want = stream(jloader, jf, jfactory, num_workers)
    got = stream(tloader, tf, tfactory, num_workers)
    _assert_tree_equal(got, want)
    # the same stream whatever the worker count
    _assert_tree_equal(got, stream(tloader, tf, tfactory, 0))


def test_loader_surfaces_errors_and_closes_early():
    def fetch(i):
        if i == 5:
            raise KeyError(i)
        return i

    batches = tloader.batch_indices(8, 2, shuffle=False)
    with pytest.raises(KeyError):
        list(tloader.iter_batches(fetch, batches, list, num_workers=2))
    it = tloader.iter_batches(lambda i: i, tloader.batch_indices(100, 2,
                                                                 False),
                              list, num_workers=2)
    assert next(it) == ([0, 1], 2)
    it.close()


@pytest.mark.parametrize("num_workers", [0, 2])
def test_batches_from_factory_matches_jax(trees, num_workers):
    jf, tf = _factories(trees, "hicodet", False, host_clip_stream=False)
    cfgs = [m.RunConfig(num_classes=600, max_gt_pairs=4,
                        num_workers=num_workers) for m in (jconfig, tconfig)]
    want = list(jcli.batches_from_factory(jf, 4, cfgs[0], shuffle=False,
                                          pad_tail=True))
    got = list(tcli.batches_from_factory(tf, 4, cfgs[1], shuffle=False,
                                         pad_tail=True))
    assert [b.n_real for _, b in got] == [b.n_real for _, b in want] == [4, 2]
    _assert_tree_equal([(d, dataclasses.asdict(b)) for d, b in got],
                       [(d, dataclasses.asdict(b)) for d, b in want])


def test_batches_from_factory_refuses_data_parallel(trees, monkeypatch):
    """A data-parallel split that cannot be made: a global batch of 2 over
    3 processes (the process count and index seen by the sampler)."""
    from hoigen_tpu_torch.parallel import distributed
    _, tf = _factories(trees, "hicodet", False)
    monkeypatch.setattr(distributed, "process_count", lambda: 3)
    monkeypatch.setattr(tcli, "process_count", lambda: 3)
    with pytest.raises(ValueError, match="must divide over 3 processes"):
        next(tcli.batches_from_factory(tf, 2, tconfig.RunConfig()))


def test_run_config_matches_jax():
    """The JAX package's fields and defaults, then the port's own
    ``trace_dir`` (off by default) and ``clip_model`` (ViT-B/16, the JAX
    package's one tower, by default)."""
    own = [("trace_dir", None), ("clip_model", "ViT-B/16")]
    assert [(f.name, f.default) for f in dataclasses.fields(
        tconfig.RunConfig) if f.default is not dataclasses.MISSING] == \
        [(f.name, f.default) for f in dataclasses.fields(jconfig.RunConfig)
         if f.default is not dataclasses.MISSING] + own
    argv = ["--num-classes", "600", "--zs", "true", "--zs-type",
            "unseen_verb", "--batch-size", "8", "--devices", "2"]
    assert dataclasses.asdict(tconfig.parse_config(argv)) == dict(
        dataclasses.asdict(jconfig.parse_config(argv)), **dict(own))
    assert tconfig.parse_config(["--trace-dir", "t"]).trace_dir == "t"
    assert tconfig.parse_config(["--clip-model", "ViT-L/14@336px"]) \
        .clip_model == "ViT-L/14@336px"


def test_samplers_match_jax():
    a = [np.array([1, 2, 3, 4, 5, 6, 7]), np.array([8, 9, 10, 11, 12, 13]),
         np.array([14, 15, 16, 17, 18])]

    def online(m):
        s = m.OnlineBatchSampler(np.arange(20), 5, 2, randomize=True, seed=1)
        out = [s.next()]
        s.anchors = out[-1][:2]
        while True:
            try:
                out.append(s.next())
            except StopIteration:
                return out

    def parallel(m):
        s = m.ParallelOnlineBatchSampler(a, 4, 1, shuffle=True, seed=2)
        out = []
        while True:
            try:
                b, ptr = s.next()
            except StopIteration:
                return out
            out.append((b, ptr))
            s.set_anchors(b[-1, None], ptr)

    def stratified(m):
        s = m.StratifiedBatchSampler([np.arange(0, 3), np.arange(3, 7)], 1,
                                     2, 6, np.arange(7, 11), 3, seed=3)
        return list(s), len(s)

    def grouped(m):
        ids = [0, 1, 0, 1, 2, 1, 0, 2, 2]
        s = m.GroupedBatchSampler(m.IndexSequentialSampler(np.arange(9)),
                                  ids, batch_size=2)
        return list(s), len(s)

    def groups(m):
        r = [0.4, 0.9, 1.0, 1.6, 2.5, 0.7]
        return [m.create_aspect_ratio_groups(r, k=k) for k in (0, 1, 2)]

    for fn in (online, parallel, stratified, grouped, groups):
        _assert_tree_equal(fn(tsamplers), fn(jsamplers))


def test_detection_files_and_ap_match_jax(trees, tmp_path):
    _, tf = _factories(trees, "hicodet", False)
    dirs = {}
    for name, m in (("jax", jdet), ("port", tdet)):
        out = tmp_path / name
        m.generate_gt_detections(tf.dataset, str(out / "gt"))

        def runs():
            for lo in (0, 4):
                batch = tfactory.collate_batch(
                    [tf[i] for i in range(lo, min(lo + 4, len(tf)))], 4)
                r = np.random.default_rng(lo)
                n = len(batch.indices)
                boxes = r.random((n, 5, 4)) * 16
                boxes[..., 2:] += boxes[..., :2] + 4
                yield {"boxes": boxes, "labels": r.integers(0, 80, (n, 5)),
                       "scores": r.random((n, 5))}, batch

        m.dump_detections(runs(), tf.dataset, str(out / "dump"),
                          score_thresh=0.3)
        n = m.remap_detections(str(out / "gt"), str(out / "remap"),
                               {str(i): (i + 1) % 80 for i in range(0, 80,
                                                                     2)})
        dirs[name] = (out, n, m.eval_detections(str(out / "gt"), tf.dataset),
                      m.eval_detections(str(out / "dump"), tf.dataset,
                                        algorithm="INT"))
    (jout, jn, jap_gt, jap_dump), (tout, tn, tap_gt, tap_dump) = \
        dirs["jax"], dirs["port"]
    assert tn == jn == len(tf)
    np.testing.assert_array_equal(tap_gt, jap_gt)
    np.testing.assert_array_equal(tap_dump, jap_dump)
    assert jap_gt.max() == 1.0
    for sub in ("gt", "dump", "remap"):
        names = sorted(os.listdir(jout / sub))
        assert sorted(os.listdir(tout / sub)) == names and names
        for n in names:
            assert json.load(open(tout / sub / n)) == \
                json.load(open(jout / sub / n))
