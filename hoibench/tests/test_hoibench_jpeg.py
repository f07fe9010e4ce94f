"""The JPEG mix (kept for a cell that no workload runs yet: PERF.md) on
the CPU at tiny sizes: the batches the port's input path (DataFactory,
loader threads, collation) builds from a written tree equal, element for
element, the reference's own decoding of the same files; set-up's
warm-ups cover every signature of the mix."""

import numpy as np

from hoibench import cells as C, jpeg, model as M
from hoibench.reference import data as RD
from hoibench.tests.conftest import tiny_mix

SMALL = dict(eval_min_side=64, max_side=96, train_scales=(48, 56, 64),
             crop_resize_choices=(48, 64), crop_range=(40, 48))
BUCKETS = ((64, 96), (96, 64), (96, 96))


def test_loader_batches_equal_the_reference(monkeypatch, tmp_path):
    import hoigen_tpu_torch.data.factory as F
    from hoigen_tpu_torch.data.transforms import DualStreamTransform as DT
    from hoibench.reference.transforms import DualStreamTransform as RT

    class SmallDT(DT):
        def __init__(self, *a, **k):
            super().__init__(*a, **{**k, **SMALL})

    class SmallRT(RT):
        def __init__(self, *a, **k):
            super().__init__(*a, **{**k, **SMALL})
    monkeypatch.setattr(F, "DualStreamTransform", SmallDT)
    monkeypatch.setattr(F, "DEFAULT_BUCKETS", BUCKETS)
    monkeypatch.setattr(RD, "DualStreamTransform", SmallRT)
    monkeypatch.setattr(RD, "BUCKETS", BUCKETS)
    run = tiny_mix("hoigen-vitb16-hicodet-rfuc", "train-jpeg")
    run.traffic = dict(run.traffic, images=24)
    run.config = dict(run.config, flags=[
        "2" if f == "32" else f for f in run.config["flags"]])
    rc = M.run_config(run.config, run.traffic)
    got = jpeg.loader_batches(run, rc, n=3)
    root = tmp_path / "tree"
    jpeg.write_tree(str(root), run.seed, run.config, run.traffic)
    sizes = [p.stat().st_size for p in root.rglob("*.jpg")]
    assert len(sizes) == 24
    files = RD.TrainFiles(str(root), jpeg.hico_tables()["unseen"]["rare_first"],
                          rc.seed)
    order = RD.epoch_batches(len(files.keep), rc.batch_size, rc.seed)
    for g, idx in zip(got, order):
        want = RD.collate([files.sample(int(i), 0) for i in idx])
        assert g.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(np.asarray(g[k]), want[k])


def test_warm_ups_cover_every_signature_of_the_mix(small_sizes):
    run = tiny_mix("hoigen-vitb16-hicodet-rfuc", "train-jpeg")
    sigs = jpeg.mix_signatures(run)
    assert len(sigs) > 1
    batch = {"images": np.full((2, 3, 96, 96), 7, np.uint8),
             "image_sizes": np.asarray([[96, 90], [60, 96]], np.int32),
             "labels": np.zeros((2, 4), np.int32)}
    warm = jpeg.jpeg_warm_ups(run, [batch])
    assert {C._hw(b) for b in warm} | {(96, 96)} == set(sigs)
    assert C._hw(warm[-1]) == sigs[0]
    for b in warm:
        hw = C._hw(b)
        assert b["image_sizes"].dtype == np.int32
        assert (b["image_sizes"] <= np.asarray(hw)).all()
        h, w = min(hw[0], 96), min(hw[1], 96)
        assert (b["images"][:, :, :h, :w] == 7).all()
        assert not b["images"][:, :, h:, :].any()
        assert not b["images"][:, :, :, w:].any()
        np.testing.assert_array_equal(b["labels"], batch["labels"])
