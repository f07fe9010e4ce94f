"""The port's checkpoint converters against the JAX package's, on the CPU,
on state dicts of random tensors under the reference's key names
(``hoigen_tpu_torch/tools/make_checkpoints.py``). Every leaf read from the
file must be the JAX converter's bit for bit once the JAX tree has gone
through ``bridge.to_torch`` (floats as float32). An adapter that the file
lacks is drawn by each package from its own generator, so those leaves
are held to their shapes and distributions instead.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from hoigen_tpu.engine import hoi_model as jhm
from hoigen_tpu.models import convert_upt as jconv_upt
from hoigen_tpu.models import dino as jdino
from hoigen_tpu.models import generator as jgen
from hoigen_tpu.models.cache import random_caches as j_random_caches
from hoigen_tpu.models.clip import convert as jconv
from hoigen_tpu.models.clip.config import CLIPConfig as JCLIPConfig
from hoigen_tpu.models.detr import convert as jdconv
from hoigen_tpu.models.detr.config import DETRConfig as JDETRConfig

from hoigen_tpu_torch.bridge import to_torch
from hoigen_tpu_torch.models import convert_upt as tconv_upt
from hoigen_tpu_torch.models import dino as tdino
from hoigen_tpu_torch.models import generator as tgen
from hoigen_tpu_torch.models.clip import convert as tconv
from hoigen_tpu_torch.models.clip.config import CLIPConfig as TCLIPConfig
from hoigen_tpu_torch.models.detr import convert as tdconv
from hoigen_tpu_torch.models.detr.config import DETRConfig as TDETRConfig
from hoigen_tpu_torch.tools import make_checkpoints as mk

from torch_port_common import eval_configs

CLIP_KW = dict(image_resolution=32, vision_layers=2, vision_width=64,
               vision_patch_size=8, adapter_layers=(0, 1),
               transformer_layers=2, transformer_width=64,
               transformer_heads=4, context_length=16, vocab_size=300)
# six encoder and decoder layers, as the converters infer from a file
DETR_KW = dict(hidden_dim=64, nheads=2, dim_feedforward=128, num_queries=12,
               num_classes=81)


def _leaves(tree, prefix=()):
    """{path: leaf} of a nested dict/list tree."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _leaves(sub, prefix + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, sub in enumerate(tree)
                for p, v in _leaves(sub, prefix + (i,)).items()}
    return {prefix: tree}


def _merge(trainable, frozen):
    """The JAX package's two trees of one shape as one (its leaves are
    None where the other tree holds them)."""
    if isinstance(trainable, dict):
        return {k: _merge(trainable[k], frozen[k]) for k in trainable}
    if isinstance(trainable, (list, tuple)):
        return [_merge(a, b) for a, b in zip(trainable, frozen)]
    return frozen if trainable is None else trainable


def _assert_same(got, want, skip=lambda p: False):
    """Every leaf of the port tree ``got`` equals the JAX tree ``want`` bit
    for bit after the bridge, except those ``skip`` names; returns the
    skipped paths."""
    got, want = _leaves(got), _leaves(to_torch(jax.tree.map(np.asarray,
                                                            want)))
    assert set(got) == set(want)
    skipped = []
    for p in got:
        if skip(p):
            assert got[p].shape == want[p].shape, p
            skipped.append(p)
            continue
        assert got[p].dtype == want[p].dtype, p
        assert torch.equal(got[p], want[p]), p
    return skipped


@pytest.fixture(scope="module")
def clip_cfgs():
    return JCLIPConfig(**CLIP_KW), TCLIPConfig(**CLIP_KW)


def test_clip_state_dict_with_adapters_converts_bit_for_bit(clip_cfgs):
    """A reference-model state dict (adapters included): every leaf, and
    the inferred config."""
    jcfg, tcfg = clip_cfgs
    sd = mk.clip_state_dict(tcfg, seed=1, adapters=True)
    want, jinf = jconv.torch_state_dict_to_params(sd)
    got, tinf = tconv.torch_state_dict_to_params(sd)
    assert not _assert_same(got, want)
    assert "self_layer" not in got["visual"]["blocks"][0]["adapter"]
    for f in dataclasses.fields(tinf):
        assert getattr(tinf, f.name) == getattr(jinf, f.name), f.name


def test_clip_missing_adapters_are_drawn(clip_cfgs):
    """OpenAI's checkpoint has no adapters: each package draws them (lora
    init: uniform down projection within +-1/sqrt(width), zero up
    projection and biases, scale 1e-9); every other leaf is the file's."""
    jcfg, tcfg = clip_cfgs
    sd = mk.clip_state_dict(tcfg, seed=2)
    want, _ = jconv.torch_state_dict_to_params(
        sd, cfg=jcfg, rng=jax.random.PRNGKey(4))
    got, _ = tconv.torch_state_dict_to_params(
        sd, cfg=tcfg, gen=torch.Generator().manual_seed(4))
    drawn = _assert_same(got, want, skip=lambda p: "adapter" in p)
    assert len(drawn) == 2 * len(_leaves(got["visual"]["blocks"][0]
                                         ["adapter"]))
    bound = 1.0 / np.sqrt(tcfg.vision_width)
    for blk in got["visual"]["blocks"]:
        ad = blk["adapter"]
        assert ad["down_w"].abs().max() <= bound
        assert ad["down_w"].std() > 0.5 * bound / np.sqrt(3)
        assert not ad["up_w"].any() and not ad["down_b"].any()
        assert torch.equal(ad["scale"], torch.full((64,), 1e-9))
        qkv = ad["layers"][0]["attn"]["w_qkv"]
        assert qkv.abs().max() <= np.sqrt(3.0 / 64) and qkv.std() > 0.05


def test_clip_positional_embedding_is_interpolated(clip_cfgs):
    """A target resolution other than the checkpoint's: the bilinear
    resize of the spatial positions, bit for bit."""
    jcfg, tcfg = clip_cfgs
    sd = mk.clip_state_dict(tcfg, seed=3, adapters=True)
    want, _ = jconv.torch_state_dict_to_params(
        sd, cfg=dataclasses.replace(jcfg, image_resolution=48))
    got, _ = tconv.torch_state_dict_to_params(
        sd, cfg=dataclasses.replace(tcfg, image_resolution=48))
    assert got["visual"]["positional_embedding"].shape == (37, 64)
    assert not _assert_same(got, want)


def test_detr_state_dict_converts_bit_for_bit():
    """The DETR-R50 state dict (BatchNorms folded): every leaf, with the
    config given and inferred."""
    sd = mk.detr_state_dict(TDETRConfig(**DETR_KW), seed=5, spread=30.0)
    want, _ = jdconv.torch_detr_state_dict_to_params(sd,
                                                     JDETRConfig(**DETR_KW))
    got, _ = tdconv.torch_detr_state_dict_to_params(sd,
                                                    TDETRConfig(**DETR_KW))
    assert not _assert_same(got, want)
    _, cfg = tdconv.torch_detr_state_dict_to_params(sd)
    assert (cfg.num_classes, cfg.num_queries, cfg.hidden_dim) == (81, 12, 64)


def test_dino_state_dict_converts_bit_for_bit():
    sd = mk.resnet50_state_dict(torch.Generator().manual_seed(6))
    assert not _assert_same(tdino.torch_dino_state_dict_to_params(sd),
                            jdino.torch_dino_state_dict_to_params(sd))


def test_generator_state_dicts_convert_bit_for_bit():
    g = torch.Generator().manual_seed(7)

    def r(*s):
        return torch.randn(s, generator=g)

    enc = {"net.0.weight": r(2048, 512), "net.0.bias": r(2048),
           "mean.weight": r(512, 2048), "mean.bias": r(512),
           "log_var.weight": r(512, 2048), "log_var.bias": r(512)}
    netg = {"net.0.weight": r(4096, 512), "net.0.bias": r(4096),
            "net.2.weight": r(512, 4096), "net.2.bias": r(512)}
    mlp = {f"net.{i}.{k}": r(512, 512) if k == "weight" else r(512)
           for i in (0, 2, 4) for k in ("weight", "bias")}
    for name, sd in (("encoder", enc), ("generator", netg),
                     ("ship_mlp", mlp)):
        fn = f"torch_{name}_state_to_params"
        assert not _assert_same(getattr(tgen, fn)(sd),
                                getattr(jgen, fn)(sd)), name
    ctx = {"ctx": r(5, 512)}
    assert torch.equal(tgen.torch_prompt_ctx_to_params(ctx),
                       to_torch(np.asarray(jgen.torch_prompt_ctx_to_params(
                           ctx))))


def test_pad_ragged_rows_matches_jax():
    rng = np.random.default_rng(0)
    counts = np.asarray([2, 0, 1, 2])
    ref = rng.normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_array_equal(tconv_upt.pad_ragged_rows(ref, counts, 2),
                                  jconv_upt.pad_ragged_rows(ref, counts, 2))
    np.testing.assert_array_equal(
        tconv_upt.pad_ragged_rows(ref[:, 0], counts, 2),
        jconv_upt.pad_ragged_rows(ref[:, 0], counts, 2))
    with pytest.raises(AssertionError):
        tconv_upt.pad_ragged_rows(ref[:4], counts, 2)


def _reference_checkpoint(tcfg, head_shapes, counts, seed):
    """A reference engine checkpoint: DETR under ``detector.``, the
    CustomCLIP under ``clip_head.`` (image encoder with adapters, text
    encoder, no token embedding), DINO under ``dino_model.``, and the
    head's tensors, the gen-cache adapters ragged by ``counts``."""
    g = torch.Generator().manual_seed(seed)
    clip_sd = mk.clip_state_dict(tcfg, seed, adapters=True)
    sd = {"detector." + k: v for k, v in mk.detr_state_dict(
        TDETRConfig(**DETR_KW), seed + 1).items()}
    sd.update({"module.dino_model." + k: v
               for k, v in mk.resnet50_state_dict(g).items()})
    for k, v in clip_sd.items():
        if k.startswith("visual."):
            sd["clip_head.image_encoder." + k[len("visual."):]] = v
        elif k == "logit_scale":
            sd["clip_head.logit_scale"] = v
        elif k != "token_embedding.weight":
            sd["clip_head.text_encoder." + k] = v
    sd["clip_head.prompt_learner.ctx"] = torch.randn(4, 64, generator=g)
    n = int(counts.sum())
    for f in "HOU":
        sd[f"gen_adapter_{f}_weight"] = torch.randn(n, 512, generator=g)
        sd[f"gen_adapter_{f}_bias"] = torch.randn(n, generator=g)
        sd[f"gen_logit_scale_{f}"] = torch.randn((), generator=g)
        sd[f"gen_label_{f}"] = (torch.rand(n, head_shapes["C"],
                                           generator=g) > 0.7).float()
    for i in range(3):
        w, b = head_shapes[f"priors_downproj.{i}"]
        sd[f"priors_downproj.layers.{i}.weight"] = torch.randn(w, generator=g)
        sd[f"priors_downproj.layers.{i}.bias"] = torch.randn(b, generator=g)
    sd["adapter_union_weight"] = torch.randn(head_shapes["text_w"],
                                             generator=g)
    sd["logit_scale_text"] = torch.randn((), generator=g)
    sd["global_cache"] = torch.randn(512, n, generator=g)
    sd["global_cache_bias"] = torch.randn(n, generator=g)
    sd["clip_cache_logit"] = torch.randn((), generator=g)
    return {"model_state_dict": sd, "epoch": 3}, clip_sd


def test_load_reference_checkpoint_matches_jax(tmp_path):
    """``load_reference_checkpoint`` on a written ``.pt`` (the text
    stack's token embedding from the base CLIP state dict): the head's
    tensors padded to the per-class layout, the label buffers, the towers
    and the CLIP tree, each the JAX import's bit for bit."""
    jcfg, tcfg = eval_configs(use_dino=False)
    jclip = JCLIPConfig(**CLIP_KW)
    jcfg = dataclasses.replace(jcfg, clip=jclip)
    caches = j_random_caches(24, 2, num_objects=10)
    trainable, frozen, buffers = jhm.init_hoi_model(
        jax.random.PRNGKey(0), jcfg, caches)
    jparams = jax.tree.map(np.asarray, _merge(trainable, frozen["upt"]))
    jbuffers = jax.tree.map(np.asarray, buffers)
    counts = np.random.default_rng(1).integers(0, 3, 24)
    shapes = {"C": 24, "text_w": jparams["text_w"].shape}
    for i, lp in enumerate(jparams["priors_downproj"]):
        shapes[f"priors_downproj.{i}"] = (lp["w"].shape, lp["b"].shape)
    ckpt, clip_sd = _reference_checkpoint(TCLIPConfig(**CLIP_KW), shapes,
                                          counts, seed=9)
    path = tmp_path / "reference.pt"
    torch.save(ckpt, path)

    want = jconv_upt.load_reference_checkpoint(
        str(path), dict(jparams), dict(jbuffers), counts, 2, "gen_feat",
        clip_base_sd=clip_sd)
    tparams, tbuffers = to_torch(jparams), to_torch(jbuffers)
    got = tconv_upt.load_reference_checkpoint(
        str(path), dict(tparams), dict(tbuffers), counts, 2, "gen_feat",
        clip_base_sd=clip_sd)
    for g, w in zip(got, want):
        assert not _assert_same(g, w)
    params, bufs, detr, dino = got
    assert params["adapter_H_w"].shape == (48, 512)
    assert torch.equal(params["adapter_H_w"][2 * 2:2 * 2 + counts[2]],
                       ckpt["model_state_dict"]["gen_adapter_H_weight"][
                           counts[:2].sum():counts[:3].sum()])
    assert detr is not None and dino is not None
    assert torch.equal(bufs["one_hots_U"],
                       torch.as_tensor(tconv_upt.pad_ragged_rows(
                           ckpt["model_state_dict"]["gen_label_U"].numpy(),
                           counts, 2)))
    with pytest.raises(ValueError, match="token_embedding"):
        tconv_upt.load_reference_checkpoint(
            str(path), dict(tparams), dict(tbuffers), counts, 2, "gen_feat")
