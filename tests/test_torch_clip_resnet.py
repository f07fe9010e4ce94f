"""The port's CLIP ModifiedResNet tower (``hoigen_tpu_torch/models/clip/
resnet.py`` and the RN branch of ``convert.py``) against the JAX
package's, on the CPU.

A small RN-CLIP state dict under OpenAI's key names (one block a stage,
width 8, 64 pixels, non-identity BatchNorm statistics, one bn3 weight of
zero) from ``hoigen_tpu_torch/tools/make_checkpoints.py`` goes through
both converters: the configs agree and every leaf is equal bit for bit.
The forward from those weights agrees within 2e-4 (f32 on both sides,
convolutions and sums in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hoigen_tpu.models.clip import convert as jconvert
from hoigen_tpu.models.clip import model as jmodel
from hoigen_tpu.models.clip import resnet as jresnet

from hoigen_tpu_torch.models.clip import convert as tconvert
from hoigen_tpu_torch.models.clip import model as tmodel
from hoigen_tpu_torch.models.clip import resnet as tresnet
from hoigen_tpu_torch.models.clip.config import CLIPConfig
from hoigen_tpu_torch.tools.make_checkpoints import RN50, clip_state_dict

TOL = 2e-4
SMALL = CLIPConfig(embed_dim=32, image_resolution=64, vision_layers=4,
                   vision_width=8, vision_patch_size=32,
                   rn_layers=(1, 1, 1, 1), transformer_width=64,
                   transformer_layers=1, context_length=16, vocab_size=100,
                   use_adapter=False, adapter_layers=())


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, np.asarray(tree)


@pytest.fixture(scope="module")
def state_dict():
    sd = clip_state_dict(SMALL, seed=5)
    sd["visual.layer2.0.bn3.weight"].zero_()
    return sd


@pytest.fixture(scope="module")
def converted(state_dict):
    tp, tcfg = tconvert.torch_state_dict_to_params(dict(state_dict))
    jp, jcfg = jconvert.torch_state_dict_to_params(dict(state_dict))
    return tp, tcfg, jp, jcfg


def test_rn_converters_agree_bit_for_bit(converted):
    """Both converters infer the same RN config from the state dict and
    give equal parameters bit for bit (BatchNorms folded in numpy
    float32); a zero bn3 weight folds to a scale of 0."""
    tp, tcfg, jp, jcfg = converted
    assert tcfg.is_resnet and tcfg.rn_layers == jcfg.rn_layers == (1,) * 4
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.vision_heads == jcfg.vision_heads == 4
    want = dict(_leaves(jp))
    got = dict(_leaves({k: jax.tree.map(lambda t: t.numpy(), v,
                                        is_leaf=torch.is_tensor)
                        for k, v in tp.items()}))
    assert got.keys() == want.keys() and len(got) > 40
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    np.testing.assert_array_equal(
        got[("visual", "layers", 1, 0, "conv3", "scale")], 0.0)


@pytest.mark.parametrize("hw", [(64, 64), (32, 64)])
def test_modified_resnet_forward_matches_jax(converted, hw):
    """encode_image of the RN config: the global feature and the local map
    (channels last) within 2e-4 of the JAX tower's, from the same
    weights; a smaller image slices the attention pool's positional grid
    (32 x 64 pixels: a 1 x 2 map)."""
    tp, tcfg, jp, jcfg = converted
    images = np.random.default_rng(6).normal(
        size=(2, 3) + hw).astype(np.float32)
    g_want, l_want = jmodel.encode_image(jp, jnp.asarray(images), jcfg)
    g, local = tmodel.encode_image(tp, torch.as_tensor(images), tcfg)
    assert local.shape == l_want.shape == (2, hw[0] // 32, hw[1] // 32, 32)
    for got, want in ((g, g_want), (local, l_want)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL * float(np.abs(want).max()))


def test_encode_image_rejects_priors(converted):
    tp, tcfg, _, _ = converted
    with pytest.raises(ValueError, match="no instance adapters"):
        tmodel.encode_image(tp, torch.zeros(1, 3, 64, 64), tcfg,
                            prior=torch.zeros(1, 2, 64))


def test_init_modified_resnet_params_matches_jax_layout():
    """Random init: the JAX tree's paths and shapes, bn3 folded to a scale
    of 0, and the forward finite; ``init_clip_params`` of an RN config
    draws this tower (RN50's shapes)."""
    want = dict(_leaves(jresnet.init_modified_resnet_params(
        jax.random.PRNGKey(0), (1, 2, 1, 1), 8, 32, 2)))
    tp = tresnet.init_modified_resnet_params(
        torch.Generator().manual_seed(0), (1, 2, 1, 1), 8, 32, 2)
    got = {k: v for k, v in _leaves(jax.tree.map(
        lambda t: t.numpy(), tp, is_leaf=torch.is_tensor))}
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    for k, v in got.items():
        if k[-2:] == ("conv3", "scale"):
            np.testing.assert_array_equal(v, 0.0)
    g, local = tresnet.modified_resnet_forward(
        tp, torch.randn(2, 3, 64, 64, generator=torch.Generator()
                        .manual_seed(1)), 4)
    assert g.shape == (2, 32) and local.shape == (2, 2, 2, 32)
    assert torch.isfinite(g).all() and torch.isfinite(local).all()
    rn50 = tmodel.init_clip_params(torch.Generator().manual_seed(0), RN50)
    pool = rn50["visual"]["attnpool"]
    assert pool["pos"].shape == (50, 2048) and pool["c_w"].shape == (1024,
                                                                    2048)
    assert [len(b) for b in rn50["visual"]["layers"]] == [3, 4, 6, 3]
    assert RN50.vision_heads == 32 and RN50.grid_size == 7


def test_rn50_state_dict_infers_rn50(tmp_path):
    """The RN50 file that ``make_checkpoints`` writes is read back as
    RN50 by both packages' config inference."""
    sd = clip_state_dict(RN50, seed=0)
    got = tconvert.infer_config(sd, use_adapter=False)
    want = jconvert.infer_config(sd, use_adapter=False)
    assert got == RN50
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_rn_tower_reaches_the_generator_encodes(converted):
    """The RN config through ``prepare_data``'s CLIP encode and the device
    crop encoder (the paths that take an RN CLIP file): the features of
    encode_image, at the tower's embed width."""
    from hoigen_tpu_torch.cli.prepare_data import clip_apply_fn
    from hoigen_tpu_torch.data.crops import make_device_crop_encoder
    tp, tcfg, _, _ = converted
    images = np.random.default_rng(7).normal(
        size=(3, 3, 64, 64)).astype(np.float32)
    got = clip_apply_fn(tp, tcfg)(images)
    want = tmodel.encode_image(tp, torch.as_tensor(images), tcfg)[0]
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-6, atol=1e-6)
    image = np.random.default_rng(8).integers(0, 256, (40, 50, 3),
                                              dtype=np.uint8)
    feats = make_device_crop_encoder(tp, tcfg, resolution=64, chunk=4)(
        image, np.asarray([[2.0, 3.0, 30.0, 35.0]], np.float32))
    assert feats.shape == (1, 32) and np.isfinite(feats).all()
