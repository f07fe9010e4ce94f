"""The generator's training half in the port (``models/generator.py``
``encoder_forward``/``vae_step``/``ship_step``, ``cli/main_vae.py``,
``cli/finetune_ship.py``) against the JAX package's, on the CPU.

Both packages read one small CLIP checkpoint (2 blocks a tower, the image
tower 64 wide, the text tower at its 512 and CLIP's context of 77). The
steps take the normal draws that JAX's steps make from their keys, handed
over as tensors: the loss and every gradient leaf within 2e-4 (the text
tower's tolerance). The CLIs run
three AdamW steps each from the JAX CLI's initial weights and draws,
handed over by wrapping the port's init and draw functions: the written
parameters within 5e-4 of the JAX CLI's (three Adam updates of 1e-3 each,
which normalise the gradients' rounding differences away only where a
gradient is far from 0; 1.4e-4 seen), and over three epochs each epoch's
mean loss within 1e-4. The ``.npz`` files of each package load in the
other's loader.
"""
import itertools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hoigen_tpu.cli import finetune_ship as jship
from hoigen_tpu.cli import main_vae as jvae
from hoigen_tpu.models import generator as JG
from hoigen_tpu.models.clip.convert import \
    torch_state_dict_to_params as j_clip_convert

from hoigen_tpu_torch.bridge import to_torch
from hoigen_tpu_torch.cli import finetune_ship as tship
from hoigen_tpu_torch.cli import main_vae as tvae
from hoigen_tpu_torch.cli import prepare_data as tpd
from hoigen_tpu_torch.data.crops import build_split_json, extract_crops
from hoigen_tpu_torch.data.factory import DataFactory
from hoigen_tpu_torch.models import generator as TG
from hoigen_tpu_torch.models.clip.config import CLIPConfig as TCLIPConfig
from hoigen_tpu_torch.tools.make_checkpoints import clip_state_dict
from hoigen_tpu_torch.tools.make_hicodet import write_hicodet

TEXT_TOL = 2e-4
PARAM_TOL = 5e-4
# the generator's features and context are 512 wide, as the text tower
CLIP_CFG = TCLIPConfig(vision_layers=2, vision_width=64, transformer_layers=2,
                       use_adapter=False)
NAMES = ["ride bicycle", "hold cup", "no interaction person",
         "feed zebra", "sit on chair"]
B = 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol, where=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, where
    err = np.abs(got - want).max(initial=0.0)
    assert err <= tol * max(1.0, np.abs(want).max(initial=0.0)), (where, err)


def _pairs(got, want, path=()):
    """(path, port leaf, JAX leaf) over two trees of one shape."""
    if isinstance(got, dict):
        for k in got:
            yield from _pairs(got[k], want[k], path + (k,))
    elif isinstance(got, (list, tuple)):
        for i, (g, w) in enumerate(zip(got, want)):
            yield from _pairs(g, w, path + (i,))
    else:
        yield path, got, want


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("gen") / "clip.pt")
    torch.save(clip_state_dict(CLIP_CFG, seed=5), path)
    jparams, jcfg = j_clip_convert(dict(torch.load(path)), use_adapter=False)
    tparams, tcfg = tpd.load_clip(path, "cpu")
    return path, (jparams, jcfg), (tparams, tcfg)


def _inputs(clip, n_ctx=4):
    (_, (jp, _), (tp, _)) = clip
    jt = JG.build_prompt_tables(NAMES, jp["text"]["token_embedding"], n_ctx)
    tt = TG.build_prompt_tables(NAMES, tp["text"]["token_embedding"], n_ctx)
    for k in ("token_prefix", "token_suffix", "eot_idx"):
        np.testing.assert_array_equal(getattr(tt, k), getattr(jt, k))
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(B, 512)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    target = rng.integers(0, len(NAMES), B).astype(np.int32)
    return jt, tt, feats, target


def _with_grad(tree):
    return jax.tree.map(lambda t: t.requires_grad_(True), to_torch(tree))


def test_encoder_forward_and_vae_loss_match_jax():
    enc = JG.init_encoder_params(jax.random.PRNGKey(3))
    x = np.random.default_rng(1).normal(size=(B, 512)).astype(np.float32)
    tm, tl = TG.encoder_forward(to_torch(_np(enc)), torch.as_tensor(x))
    jm, jl = JG.encoder_forward(enc, jnp.asarray(x))
    _close(tm, jm, 1e-5)
    _close(tl, jl, 1e-5)
    recon = np.random.default_rng(2).normal(size=(B, 512)).astype(np.float32)
    _close(TG.vae_loss(torch.as_tensor(recon), torch.as_tensor(x), tm, tl),
           JG.vae_loss(jnp.asarray(recon), jnp.asarray(x), jm, jl), 1e-5)


def test_vae_step_loss_and_grads_match_jax(clip):
    _, (jp, jcfg), (tp, tcfg) = clip
    jt, tt, feats, target = _inputs(clip, n_ctx=5)
    params = {"enc": JG.init_encoder_params(jax.random.PRNGKey(0)),
              "gen": JG.init_generator_params(jax.random.PRNGKey(1)),
              "ctx": JG.init_prompt_ctx(jax.random.PRNGKey(2), 5)}
    key = jax.random.PRNGKey(9)
    loss, grads = jax.value_and_grad(lambda p: JG.vae_step(
        p, jt, jp, jcfg, jnp.asarray(feats), jnp.asarray(target), key))(
        params)
    noise = np.asarray(jax.random.normal(key, (B, 512)), np.float32)
    tparams = _with_grad(_np(params))
    tloss = TG.vae_step(tparams, tt, tp, tcfg, torch.as_tensor(feats),
                        torch.as_tensor(target).long(),
                        torch.as_tensor(noise))
    tloss.backward()
    _close(tloss, loss, TEXT_TOL, "loss")
    n = 0
    for path, t, g in _pairs(tparams, _np(grads)):
        _close(t.grad, g, TEXT_TOL, path)
        n += 1
    assert n == 11
    # the frozen tower takes no gradient
    assert all(t.grad is None for _, t, _ in _pairs(tp, tp))


def test_ship_step_loss_and_grads_match_jax(clip):
    _, (jp, jcfg), (tp, tcfg) = clip
    jt, tt, feats, target = _inputs(clip)
    gen = JG.init_generator_params(jax.random.PRNGKey(4))
    ctx = JG.init_prompt_ctx(jax.random.PRNGKey(5), 4)
    mlp = JG.init_ship_mlp_params(jax.random.PRNGKey(6))
    key = jax.random.PRNGKey(10)
    loss, grads = jax.value_and_grad(lambda m: JG.ship_step(
        m, gen, ctx, jt, jp, jcfg, jnp.asarray(feats), jnp.asarray(target),
        key))(mlp)
    z = np.asarray(jax.random.normal(key, (B, 512)), np.float32)
    tmlp = _with_grad(_np(mlp))
    tloss = TG.ship_step(tmlp, to_torch(_np(gen)), to_torch(np.asarray(ctx)),
                         tt, tp, tcfg, torch.as_tensor(feats),
                         torch.as_tensor(target).long(), torch.as_tensor(z))
    tloss.backward()
    _close(tloss, loss, TEXT_TOL, "loss")
    for path, t, g in _pairs(tmlp, _np(grads)):
        _close(t.grad, g, TEXT_TOL, path)


@pytest.mark.parametrize(
    "dataset,data,zs,zs_type",
    list(itertools.product(["hicodet_crop", "vcoco_crop"],
                           ["hoi_data", "human_data", "object_data"],
                           [False, True],
                           ["rare_first", "non_rare_first", "unseen_verb",
                            "unseen_object"])))
def test_family_classnames_equal_jax(dataset, data, zs, zs_type):
    got = tvae.family_classnames(dataset, data, zs, zs_type)
    assert got == jvae.family_classnames(dataset, data, zs, zs_type)
    assert got and all(isinstance(n, str) for n in got)


# --------------------------------------------------------------- the CLIs
@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """A crop split of at least 12 crops: three steps at batch 4."""
    root = tmp_path_factory.mktemp("gen_split")
    data = write_hicodet(str(root / "hico"),
                         [(64, 48), (48, 64), (80, 60), (60, 80), (72, 72),
                          (90, 50), (50, 90), (64, 64)], seed=6)
    ds = DataFactory("hicodet", "train2015", data, training=False).dataset
    items = extract_crops(ds, str(root / "crops"), "hoi")
    assert len(items) >= 3 * B
    path = str(root / "split.json")
    build_split_json(items, path, seed=0)
    return path


def _hand_over_vae(monkeypatch, seed):
    """The port's initial weights and noise draws, from the JAX CLI's
    keys (train_vae: enc seed, gen seed + 1, ctx seed + 2, the noise of
    step i from fold_in(key(seed + 7), i))."""
    monkeypatch.setattr(TG, "init_encoder_params", lambda gen: to_torch(
        _np(JG.init_encoder_params(jax.random.PRNGKey(seed)))))
    monkeypatch.setattr(TG, "init_generator_params", lambda gen: to_torch(
        _np(JG.init_generator_params(jax.random.PRNGKey(seed + 1)))))
    monkeypatch.setattr(TG, "init_prompt_ctx", lambda gen, n: torch.as_tensor(
        np.asarray(JG.init_prompt_ctx(jax.random.PRNGKey(seed + 2), n),
                   np.float32)))
    step = itertools.count()
    rng = jax.random.PRNGKey(seed + 7)
    monkeypatch.setattr(tvae, "normal", lambda gen, shape, dev:
                        torch.as_tensor(np.asarray(jax.random.normal(
                            jax.random.fold_in(rng, next(step)),
                            tuple(shape)), np.float32)))


def test_main_vae_three_steps_match_jax(clip, split, tmp_path, monkeypatch):
    path = clip[0]
    seed = 3
    _hand_over_vae(monkeypatch, seed)
    argv = ["--split-json", split, "--clip-model", path, "--epochs", "1",
            "--batch-size", str(B), "--seed", str(seed), "--dataset",
            "hicodet_crop", "--data", "hoi_data"]
    jvae.main(argv + ["--ckpt-dir", str(tmp_path / "j")])
    out = tvae.main(argv + ["--ckpt-dir", str(tmp_path / "t")], device="cpu")
    assert out.endswith("hicodet/hoi_vae_1.npz")
    got, want = np.load(out), np.load(tmp_path / "j/hicodet/hoi_vae_1.npz")
    assert sorted(got.files) == sorted(want.files) and len(got.files) == 11
    for k in got.files:
        _close(got[k], want[k], PARAM_TOL, k)


def test_train_vae_epoch_losses_match_jax(clip, split, monkeypatch):
    """Three epochs of train_vae: each epoch's mean loss, as logged, within
    1e-4 of the JAX train_vae's."""
    (_, (jp, jcfg), (tp, tcfg)) = clip
    from hoigen_tpu.data.crops import CropDataset as JCropDataset
    from hoigen_tpu_torch.data.crops import CropDataset as TCropDataset
    seed = 4
    _hand_over_vae(monkeypatch, seed)
    names = tvae.family_classnames("hicodet", "hoi_data", False, "")
    jlogs, tlogs = [], []
    jvae.train_vae(jp, jcfg, JCropDataset(split, seed=seed), names, 5,
                   epochs=3, batch_size=B, seed=seed, log=jlogs.append)
    tvae.train_vae(tp, tcfg, TCropDataset(split, seed=seed), names, 5,
                   epochs=3, batch_size=B, seed=seed, log=tlogs.append)
    assert len(jlogs) == len(tlogs) == 3
    for j, t in zip(jlogs, tlogs):
        jl, tl = float(j.split()[-1]), float(t.split()[-1])
        assert abs(jl - tl) <= 1e-4 * max(1.0, abs(jl)) + 5e-5, (j, t)


def test_finetune_ship_three_steps_match_jax(clip, split, tmp_path,
                                             monkeypatch):
    path, (jp, _), _ = clip
    seed = 5
    # one VAE file for both: the JAX CLI's format, written by the port
    vae = {"enc": _np(JG.init_encoder_params(jax.random.PRNGKey(0))),
           "gen": _np(JG.init_generator_params(jax.random.PRNGKey(1))),
           "ctx": np.asarray(JG.init_prompt_ctx(jax.random.PRNGKey(2), 5))}
    vae_path = tvae.save_family(to_torch(vae), str(tmp_path / "vae"), "hoi",
                                1)
    rng = np.random.default_rng(0)
    gt = {c: [rng.normal(size=(3, 512)).astype(np.float32)]
          for c in range(0, 600, 2)}
    gt[2][0][1, 5] = np.nan              # a NaN row is dropped
    gt[4] = []
    gt_path = tmp_path / "gt.pickle"
    pickle.dump(gt, open(gt_path, "wb"))
    monkeypatch.setattr(TG, "init_ship_mlp_params", lambda gen: to_torch(
        _np(JG.init_ship_mlp_params(jax.random.PRNGKey(seed)))))
    step = itertools.count()
    key = jax.random.PRNGKey(seed + 3)
    monkeypatch.setattr(tship, "normal", lambda gen, shape, dev:
                        torch.as_tensor(np.asarray(jax.random.normal(
                            jax.random.fold_in(key, next(step)),
                            tuple(shape)), np.float32)))
    argv = ["--vae-ckpt", vae_path, "--gt-features", str(gt_path),
            "--split-json", split, "--clip-model", path, "--epochs", "1",
            "--batch-size", str(B), "--seed", str(seed)]
    jship.main(argv + ["--ckpt-dir", str(tmp_path / "j")])
    out = tship.main(argv + ["--ckpt-dir", str(tmp_path / "t")],
                     device="cpu")
    got, want = np.load(out), np.load(tmp_path / "j/hicodet/hoi_mlp_1.npz")
    assert sorted(got.files) == sorted(want.files) and len(got.files) == 6
    for k in got.files:
        _close(got[k], want[k], PARAM_TOL, k)
    assert next(step) >= 3


def test_npz_files_load_in_the_other_package(tmp_path):
    rng = np.random.default_rng(7)
    vae = {"enc": _np(JG.init_encoder_params(jax.random.PRNGKey(0))),
           "gen": _np(JG.init_generator_params(jax.random.PRNGKey(1))),
           "ctx": rng.normal(size=(5, 512)).astype(np.float32)}
    mlp = _np(JG.init_ship_mlp_params(jax.random.PRNGKey(2)))
    jv = jvae.save_family(vae, str(tmp_path / "j"), "hoi", 7)
    tv = tvae.save_family(to_torch(vae), str(tmp_path / "t"), "hoi", 7)
    jm = jship.save_mlp(mlp, str(tmp_path / "j"), "hoi", 7)
    tm = tship.save_mlp(to_torch(mlp), str(tmp_path / "t"), "hoi", 7)
    assert jv.endswith("hoi_vae_7.npz") and tv.endswith("hoi_vae_7.npz")
    assert jm.endswith("hoi_mlp_7.npz") and tm.endswith("hoi_mlp_7.npz")
    for got, want in ((tvae.load_family(jv), vae), (jvae.load_family(tv), vae),
                      (tship.load_mlp(jm), mlp), (jship.load_mlp(tm), mlp)):
        n = 0
        for path, g, w in _pairs(got, want):
            g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
            np.testing.assert_array_equal(g, w, str(path))
            n += 1
        assert n in (6, 11)
