"""The port's crop pipeline (``hoigen_tpu_torch/ops/resize.py`` crops,
``data/crops.py``, ``cli/prepare_data.py``) against the JAX package's, on
the CPU.

PIL-emulated resizes and crops within 1.01/255 of JAX's (the bound
``tests/test_resize.py`` holds JAX to against PIL: the port and JAX sum in
another order, so a uint8 rounding may go the other way), the float crops
within 1e-3 of the [0, 255] scale; the crop files, split jsons, the crop
dataset's draws and the producers given one numpy CLIP bit for bit; the
device crop encoder and each ``prepare_data`` task against the JAX CLI's
on a tiny CLIP read from one checkpoint file (features within 2e-4 of
their scale).
"""
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hoigen_tpu.cli import prepare_data as jpd
from hoigen_tpu.data import crops as jcrops
from hoigen_tpu.data.factory import DataFactory as JDataFactory
from hoigen_tpu.models.clip.convert import \
    torch_state_dict_to_params as j_clip_convert
from hoigen_tpu.ops import resize as jresize

from hoigen_tpu_torch.cli import prepare_data as tpd
from hoigen_tpu_torch.data import crops as tcrops
from hoigen_tpu_torch.data.factory import DataFactory as TDataFactory
from hoigen_tpu_torch.models.clip.config import CLIPConfig as TCLIPConfig
from hoigen_tpu_torch.ops import resize as tresize
from hoigen_tpu_torch.tools.make_checkpoints import clip_state_dict
from hoigen_tpu_torch.tools.make_hicodet import write_hicodet

U8_TOL = 1.01            # one uint8 level (and a hair)
FEAT_TOL = 2e-4          # features, relative to their largest magnitude
# a narrow CLIP at the CLIs' 224-pixel crops: 2 blocks of width 64, the
# text tower at CLIP's context of 77
TINY_CLIP = TCLIPConfig(vision_layers=2, vision_width=64,
                        transformer_layers=2, transformer_width=64,
                        use_adapter=False)
# landscape, portrait and square images of a few sizes
SIZES = [(64, 48), (48, 64), (80, 80), (96, 40), (40, 72), (70, 50)]


def _image(rng, h, w):
    return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)


BOXES = np.asarray([
    (10, 20, 110, 60),      # wide: vertical zero pad
    (30, 5, 70, 160),       # tall: horizontal zero pad
    (0, 0, 50, 50),         # square at the origin
    (100, 120, 180, 176),   # near the bottom-right edge
    (150, 40, 230, 80),     # 30 px past the right edge
    (3, 4, 5, 90),          # a sliver
], np.float32)


@pytest.mark.parametrize("pil", [True, False], ids=["pil_u8", "float"])
def test_crop_resize_square_matches_jax(pil):
    """A batch of boxes in one call against JAX's crop of each box."""
    arr = _image(np.random.default_rng(3), 180, 200).transpose(2, 0, 1) \
        .astype(np.float32)
    got = (tresize.crop_resize_square_pil_u8 if pil else
           tresize.crop_resize_square)(torch.as_tensor(arr), BOXES, 48)
    assert got.shape == (len(BOXES), 3, 48, 48)
    fn = jresize.crop_resize_square_pil_u8 if pil else \
        jresize.crop_resize_square
    for i, box in enumerate(BOXES):
        want = np.asarray(fn(jnp.asarray(arr), jnp.asarray(box), 48))
        diff = np.abs(got[i].numpy() - want)
        if pil:
            assert diff.max() <= U8_TOL, (box, diff.max())
            assert (diff > 0.5).mean() < 0.01
        else:
            assert diff.max() <= 1e-3, (box, diff.max())


@pytest.mark.parametrize("hw,out", [((37, 53), (32, 32)),
                                    ((120, 90), (48, 64))])
def test_resize_image_matches_jax(hw, out):
    rng = np.random.default_rng(4)
    buf = np.zeros((3, 128, 128), np.float32)
    buf[:, :hw[0], :hw[1]] = _image(rng, *hw).transpose(2, 0, 1)
    buf[:, hw[0]:, :] = 255.0            # padding must not contribute
    size = np.asarray(hw, np.float32)
    got = tresize.resize_image_pil_u8(torch.as_tensor(buf), size, out)
    want = np.asarray(jresize.resize_image_pil_u8(jnp.asarray(buf), size,
                                                  out))
    assert np.abs(got.numpy() - want).max() <= U8_TOL
    got = tresize.resize_image(torch.as_tensor(buf), size, out)
    want = np.asarray(jresize.resize_image(jnp.asarray(buf), size, out))
    assert np.abs(got.numpy() - want).max() <= 1e-3


def test_host_crop_helpers_equal_jax():
    rng = np.random.default_rng(5)
    boxes = rng.uniform(0, 50, (12, 4)).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2]
    boxes[6:] = boxes[:6] + rng.uniform(-3, 3, (6, 4)).astype(np.float32)
    assert tcrops.dedup_boxes(boxes) == jcrops.dedup_boxes(boxes)
    from PIL import Image
    for w, h in ((30, 50), (50, 30), (40, 40)):
        img = Image.fromarray(_image(rng, h, w))
        np.testing.assert_array_equal(
            np.asarray(tcrops.expand2square(img)),
            np.asarray(jcrops.expand2square(img)))
        np.testing.assert_array_equal(tcrops.clip_preprocess_crop(img, 32),
                                      jcrops.clip_preprocess_crop(img, 32))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("crops")
    data = write_hicodet(str(root / "hico"), SIZES, seed=2)
    path = str(root / "clip.pt")
    torch.save(clip_state_dict(TINY_CLIP, seed=4), path)
    return data, path


def _tree_eq(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _tree_eq(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _tree_eq(x, y, f"{where}/{i}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), where)


@pytest.mark.parametrize("category", ["hoi", "human", "object"])
def test_extract_crops_and_split_equal_jax(tree, tmp_path, category):
    data, _ = tree
    ds = TDataFactory("hicodet", "train2015", data, training=False).dataset
    jds = JDataFactory("hicodet", "train2015", data, training=False).dataset
    got = tcrops.extract_crops(ds, str(tmp_path / "t"), category)
    want = jcrops.extract_crops(jds, str(tmp_path / "j"), category)
    assert got and len(got) == len(want)
    for g, w in zip(got, want):
        assert g["label"] == w["label"]
        assert os.path.relpath(g["impath"], tmp_path / "t") == \
            os.path.relpath(w["impath"], tmp_path / "j")
        with open(g["impath"], "rb") as f1, open(w["impath"], "rb") as f2:
            assert f1.read() == f2.read()
    excluded = sorted({it["label"] for it in got})[:2]
    for ratio in (0.0, 0.3):
        split = tcrops.build_split_json(got, str(tmp_path / "t.json"),
                                        excluded, ratio, seed=7)
        jsplit = jcrops.build_split_json(got, str(tmp_path / "j.json"),
                                         excluded, ratio, seed=7)
        assert split == jsplit
        assert json.load(open(tmp_path / "t.json")) == \
            json.load(open(tmp_path / "j.json"))


@pytest.fixture(scope="module")
def split(tree, tmp_path_factory):
    data, _ = tree
    out = tmp_path_factory.mktemp("split")
    ds = TDataFactory("hicodet", "train2015", data, training=False).dataset
    items = tcrops.extract_crops(ds, str(out / "crops"), "hoi")
    path = str(out / "split.json")
    tcrops.build_split_json(items, path, seed=1)
    return path


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_crop_dataset_equals_jax(split, training):
    """The same crops in the same batches, epoch after epoch: the numpy
    draws come in the same order."""
    t = tcrops.CropDataset(split, "train", 32, training, seed=5)
    j = jcrops.CropDataset(split, "train", 32, training, seed=5)
    assert len(t) == len(j) >= 8
    for _ in range(2):
        got, want = list(t.batches(4)), list(j.batches(4))
        assert len(got) == len(want) == len(t) // 4
        _tree_eq(got, want)
    _tree_eq(t[1], j[1])


def _numpy_clip(images):
    """A stand-in CLIP in numpy: per-channel means projected to 512."""
    proj = np.random.default_rng(1).normal(size=(3, 512)).astype(np.float32)
    return np.asarray(images, np.float32).mean((2, 3)) @ proj


def test_producers_equal_jax_with_numpy_clip(tree, split, tmp_path):
    data, _ = tree
    ds = TDataFactory("hicodet", "train2015", data, training=False).dataset
    jds = JDataFactory("hicodet", "train2015", data, training=False).dataset
    got = tcrops.produce_pair_embeddings(ds, _numpy_clip,
                                         str(tmp_path / "t.p"), batch_size=5,
                                         resolution=32)
    want = jcrops.produce_pair_embeddings(jds, _numpy_clip,
                                          str(tmp_path / "j.p"),
                                          batch_size=5, resolution=32)
    _tree_eq(got, want)
    assert "huamn_features" in next(iter(got.values()))
    _tree_eq(pickle.load(open(tmp_path / "t.p", "rb")),
             pickle.load(open(tmp_path / "j.p", "rb")))
    cds = tcrops.CropDataset(split, "train", 32, training=False)
    jcds = jcrops.CropDataset(split, "train", 32, training=False)
    got = tcrops.produce_gt_features(cds, _numpy_clip, 600,
                                     str(tmp_path / "t.pickle"), 3)
    want = jcrops.produce_gt_features(jcds, _numpy_clip, 600,
                                      str(tmp_path / "j.pickle"), 3)
    _tree_eq(got, want)
    assert sum(len(v) for v in got.values()) > 0


def _close(got, want, tol=FEAT_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max(initial=0.0)
    assert err <= tol * max(np.abs(want).max(initial=0.0), 1.0), err


def test_device_crop_encoder_matches_jax(tree):
    """Crop, resize, normalise and encode on the device (here the CPU) in
    chunks of 4: each crop's feature within 2e-4 of JAX's encoder (which
    pads the image to a /128 bucket) on the same checkpoint."""
    data, path = tree
    sd = dict(torch.load(path))
    jparams, jcfg = j_clip_convert(sd, use_adapter=False)
    tparams, tcfg = tpd.load_clip(path, "cpu")
    jenc = jcrops.make_device_crop_encoder(jparams, jcfg, chunk=4)
    tenc = tcrops.make_device_crop_encoder(tparams, tcfg, chunk=4)
    ds = TDataFactory("hicodet", "train2015", data, training=False).dataset
    for i in range(len(ds)):
        image = np.asarray(ds.load_image(i))
        tgt = ds.target(i)
        boxes = np.concatenate([tgt["boxes_h"], tgt["boxes_o"],
                                [[5, 5, 5.2, 30]]])      # a degenerate box
        _close(tenc(image, boxes), jenc(image, boxes))
    assert tenc(image, np.zeros((0, 4))).shape == (0, 512)


def _run_both(monkeypatch, tmp_path, argv, out="out"):
    """The JAX CLI and the port's (on the CPU) with ``argv``, each in its
    own working directory, its ``--out`` there. -> (port's, JAX's)."""
    outs = {}
    for name, main in (("jax", jpd.main),
                       ("port", lambda a: tpd.main(a, device="cpu"))):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        monkeypatch.chdir(d)
        main(argv + ["--out", str(d / out)])
        outs[name] = d / out
    return outs["port"], outs["jax"]


@pytest.mark.parametrize("category", ["hoi", "object"])
def test_prepare_data_crops_equals_jax(tree, tmp_path, monkeypatch,
                                       category):
    data, _ = tree
    got, want = _run_both(monkeypatch, tmp_path, [
        "crops", "--data-root", data, "--category", category,
        "--out-dir", "crops", "--zs", "true", "--seed", "3"])
    got, want = json.load(open(got)), json.load(open(want))
    assert len(got["train"]) > 0
    assert got == want      # relative paths under each working directory


@pytest.mark.parametrize("host", [False, True], ids=["device", "host"])
def test_prepare_data_pair_embeddings_match_jax(tree, tmp_path, monkeypatch,
                                                host):
    data, path = tree
    argv = ["pair-embeddings", "--data-root", data, "--clip-model", path,
            "--limit", "3"] + (["--host-crops"] if host else [])
    got, want = _run_both(monkeypatch, tmp_path, argv)
    got, want = (pickle.load(open(p, "rb")) for p in (got, want))
    assert got.keys() == want.keys() and len(got) == 3
    for fname in got:
        for k, v in got[fname].items():
            if k.endswith("_features"):
                _close(v, want[fname][k])
            else:
                np.testing.assert_array_equal(v, want[fname][k])


def test_prepare_data_gt_features_match_jax(tree, split, tmp_path,
                                            monkeypatch):
    _, path = tree
    got, want = _run_both(monkeypatch, tmp_path, [
        "gt-features", "--split-json", split, "--clip-model", path])
    got, want = (pickle.load(open(p, "rb")) for p in (got, want))
    assert got.keys() == want.keys()
    for c in got:
        assert len(got[c]) == len(want[c])
        for g, w in zip(got[c], want[c]):
            _close(g, w)


def test_prepare_data_global_caches_match_jax(tree, tmp_path, monkeypatch):
    """CLIP's keys and values against the JAX CLI's file. The JAX CLI's
    DINO encode of the uint8 stream casts its weights to uint8 (its
    features come out zero); the port encodes the stream as floats, held
    here against JAX's ``dino_forward`` of the same floats with the same
    weights, handed over."""
    from hoigen_tpu.models import dino as jdino
    from hoigen_tpu.models.cache import build_global_cache
    from hoigen_tpu_torch.bridge import to_torch
    from hoigen_tpu_torch.models import dino as tdino
    data, path = tree
    jweights = jdino.init_dino_params(jax.random.PRNGKey(1))
    monkeypatch.setattr(tdino, "init_dino_params",
                        lambda gen: to_torch(jax.tree.map(np.asarray,
                                                          jweights)))
    got, want = _run_both(monkeypatch, tmp_path, [
        "global-caches", "--data-root", data, "--clip-model", path,
        "--num-classes", "117", "--num-shot", "2"], out="caches.npz")
    got, want = np.load(got), np.load(want)
    np.testing.assert_array_equal(got["clip_values"], want["clip_values"])
    _close(got["clip_keys"], want["clip_keys"])
    factory = TDataFactory("hicodet", "train2015", data, training=False)
    images, multihots = [], []
    for i in range(len(factory)):
        _, clip_img, tgt, _ = factory[i]
        images.append(clip_img)
        mh = np.zeros(117, np.float32)
        mh[np.asarray(tgt["labels"], int)] = 1
        multihots.append(mh)
    images = np.stack(images)
    assert not np.asarray(jdino.dino_forward(jweights, images)).any()
    feats = np.array(jdino.dino_forward(
        jweights, jnp.asarray(images, jnp.float32)), np.float32)
    feats /= np.maximum(np.linalg.norm(feats, axis=1, keepdims=True), 1e-8)
    keys, values = build_global_cache(feats, np.stack(multihots), 117, 2,
                                      seed=0)
    np.testing.assert_array_equal(got["dino_values"], values)
    _close(got["dino_keys"], keys)
