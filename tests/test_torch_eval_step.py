"""The port's eval step (hoigen_tpu_torch) against the JAX eval step
(hoigen_tpu) on a tiny configuration, on the CPU, from the same weights.

The configuration is the main path's (gen_feat cache model, DINO on, the
fused-cache flag on, the uint8 production feed with the on-device CLIP
stream) at narrow widths and in float32. On the CPU both packages take the
plain math at every kernel call site, so the two steps compute the same
function; the JAX parameters are cast to float32 (the tests run
JAX with x64 enabled) and handed to the port through the bridge.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hoigen_tpu.engine import hoi_model as jhm
from hoigen_tpu.models.cache import random_caches as j_random_caches
from hoigen_tpu.models.clip.config import CLIPConfig as JCLIPConfig
from hoigen_tpu.models.detr import DETRConfig as JDETRConfig
from hoigen_tpu.models.proposals import ProposalConfig as JProposalConfig
from hoigen_tpu.models.upt import UPTConfig as JUPTConfig

from hoigen_tpu_torch import bridge
from hoigen_tpu_torch.engine import hoi_model as thm
from hoigen_tpu_torch.models.cache import random_caches as t_random_caches
from hoigen_tpu_torch.models.clip.config import CLIPConfig as TCLIPConfig
from hoigen_tpu_torch.models.detr.config import DETRConfig as TDETRConfig
from hoigen_tpu_torch.models.proposals import ProposalConfig as \
    TProposalConfig
from hoigen_tpu_torch.models.upt import UPTConfig as TUPTConfig

CLIP_KW = dict(image_resolution=32, vision_layers=2, vision_width=64,
               vision_patch_size=8, adapter_layers=(0, 1))
# the JAX config also sizes a text tower, which the eval step does not run
TEXT_KW = dict(transformer_layers=2, transformer_width=64, context_length=16)
# 1 real detector class + no-object, as the JAX package's tiny dryrun: a
# random DETR gives every query the same label, and with one class that
# label is 'human', so human-human pairs form (the object slot group is
# covered by the proposal tests of test_torch_modules.py)
DETR_KW = dict(hidden_dim=64, nheads=2, enc_layers=2, dec_layers=2,
               dim_feedforward=128, num_queries=12, num_classes=2)
UPT_KW = dict(num_classes=24, num_shot=2, clip_resolution=32,
              use_dino=True, cache_model="gen_feat", use_pallas_cache=True)
DETR_HW = (64, 96)


def _configs():
    jcfg = jhm.HOIModelConfig(
        clip=JCLIPConfig(**CLIP_KW, **TEXT_KW), detr=JDETRConfig(**DETR_KW),
        upt=JUPTConfig(proposals=JProposalConfig(max_instances=4), **UPT_KW),
        dtype="float32")
    tcfg = thm.HOIModelConfig(
        clip=TCLIPConfig(**CLIP_KW), detr=TDETRConfig(**DETR_KW),
        upt=TUPTConfig(proposals=TProposalConfig(max_instances=4), **UPT_KW),
        dtype="float32")
    return jcfg, tcfg


def _f32(tree):
    return jax.tree.map(
        lambda a: a.astype(jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def _spread_bbox_head(frozen):
    # random-init DETR emits near-identical boxes for every query, so NMS
    # keeps one and no pairs form; spread the box head as the JAX package's
    # tiny dryrun does
    last = frozen["detr"]["bbox_embed"][-1]
    frozen["detr"]["bbox_embed"][-1] = {
        "w": last["w"] * 6.0,
        "b": last["b"] + jnp.asarray(
            np.random.default_rng(0).normal(0, 1.0, last["b"].shape),
            last["b"].dtype)}
    return frozen


def test_caches_and_batch_match_the_jax_package():
    """The port's numpy copies give the JAX package's arrays."""
    jc, tc = j_random_caches(24, 2, num_objects=10), \
        t_random_caches(24, 2, num_objects=10)
    for f in ("cache_h", "cache_o", "cache_u", "one_hots", "sample_lens",
              "clip_global_keys", "dino_keys", "object_class_multihot",
              "object_embedding", "origin_text_embeddings"):
        np.testing.assert_array_equal(getattr(jc, f), getattr(tc, f))
    jcfg, tcfg = _configs()
    jb = jhm.make_example_batch(jcfg, batch_size=2, detr_hw=DETR_HW,
                                device_clip_stream=True)
    tb = thm.make_example_batch(tcfg, batch_size=2, detr_hw=DETR_HW,
                                device_clip_stream=True)
    assert jb.keys() == tb.keys()
    for k in jb:
        np.testing.assert_array_equal(jb[k], tb[k])


def test_eval_step_matches_jax():
    jcfg, tcfg = _configs()
    caches = j_random_caches(24, 2, num_objects=10)
    trainable, frozen, buffers = jhm.init_hoi_model(
        jax.random.PRNGKey(0), jcfg, caches)
    trainable, frozen, buffers = (_f32(trainable),
                                  _spread_bbox_head(_f32(frozen)),
                                  _f32(buffers))
    batch = jhm.make_example_batch(jcfg, batch_size=2, detr_hw=DETR_HW,
                                   device_clip_stream=True)
    want = jax.jit(jhm.make_eval_step(jcfg))(trainable, frozen, buffers,
                                             batch)
    want = {k: np.asarray(v) for k, v in want.items()}

    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    params, tbuf = bridge.params_from_jax(as_np(trainable), as_np(frozen),
                                          as_np(buffers), device="cpu")
    got = thm.make_eval_step(tcfg, device="cpu")(params, tbuf, batch)
    got = {k: v.numpy() for k, v in got.items()}

    # the path must be non-trivial: pairs formed, scores nonzero
    assert want["pair_valid"].any()
    assert (want["detection_scores"] > 0).any()
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
    # indices, LUT gathers and masks are exact
    np.testing.assert_array_equal(got["pair_valid"], want["pair_valid"])
    np.testing.assert_array_equal(got["objects"], want["objects"])
    np.testing.assert_array_equal(got["detection_verbs"],
                                  want["detection_verbs"])
    # boxes: absolute coordinates at the 32-pixel CLIP frame after the
    # f32 DETR tower, 2 encoder + 2 decoder layers: 2e-4 relative, the
    # transformer tolerance of the JAX package's full-dims suite
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=2e-4,
                               atol=2e-4)
    # scores: sigmoid(logits) * prior^2.8 in [0, 1], after the CLIP tower
    # and six summed branches; f32 sums in another order on each side
    np.testing.assert_allclose(got["detection_scores"],
                               want["detection_scores"], rtol=2e-4,
                               atol=2e-5)


def test_entry_points_refuse_a_missing_card(monkeypatch):
    """device=None means CUDA; with no card the entry points raise rather
    than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _configs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        thm.make_eval_step(tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        thm.init_hoi_model(torch.Generator().manual_seed(0), tcfg,
                           t_random_caches(24, 2, num_objects=10))


def test_detr_reserve_indices_match_the_jax_tables():
    from hoigen_tpu.labels.vcoco import VCOCO_LABELS

    from hoigen_tpu_torch.labels.vcoco import detr_reserve_indices
    assert detr_reserve_indices() == VCOCO_LABELS.detr_reserve_indices
    assert len(detr_reserve_indices()) == 81


def test_eval_step_with_a_92_logit_detector_matches_jax():
    """A COCO-pretrained V-COCO detector (91 classes + no-object = 92
    logits): the 92->81 logit gather before the postprocess, on both
    sides, then the whole eval step as above. The person logit (COCO slot
    1) is favoured so that the random detector forms human pairs."""
    jcfg, tcfg = _configs()
    detr91 = dict(DETR_KW, num_classes=92)
    # DINO off: the gather is all this test adds to the one above
    jcfg = jhm.HOIModelConfig(
        clip=jcfg.clip, detr=JDETRConfig(**detr91),
        upt=dataclasses.replace(jcfg.upt, use_dino=False), dtype="float32")
    tcfg = thm.HOIModelConfig(
        clip=tcfg.clip, detr=TDETRConfig(**detr91),
        upt=dataclasses.replace(tcfg.upt, use_dino=False), dtype="float32")
    caches = j_random_caches(24, 2, num_objects=81)
    # the detector's random weights drawn by the port, in the layout both
    # packages share (the JAX package's random ResNet-50 init is slow on
    # the CPU)
    from hoigen_tpu_torch.models.detr.model import init_detr_params
    detr = jax.tree.map(jnp.asarray, bridge.to_numpy(init_detr_params(
        torch.Generator().manual_seed(1), tcfg.detr)))
    trainable, frozen, buffers = jhm.init_hoi_model(
        jax.random.PRNGKey(1), jcfg, caches, detr_params=detr)
    frozen = _spread_bbox_head(_f32(frozen))
    ce = frozen["detr"]["class_embed"]
    assert ce["b"].shape == (92,)
    frozen["detr"]["class_embed"] = {"w": ce["w"],
                                     "b": ce["b"].at[1].add(10.0)}
    trainable, buffers = _f32(trainable), _f32(buffers)
    batch = jhm.make_example_batch(jcfg, batch_size=2, detr_hw=DETR_HW,
                                   device_clip_stream=True)
    want = jax.jit(jhm.make_eval_step(jcfg))(trainable, frozen, buffers,
                                             batch)
    want = {k: np.asarray(v) for k, v in want.items()}

    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    params, tbuf = bridge.params_from_jax(as_np(trainable), as_np(frozen),
                                          as_np(buffers), device="cpu")
    got = thm.make_eval_step(tcfg, device="cpu")(params, tbuf, batch)
    got = {k: v.numpy() for k, v in got.items()}

    assert want["pair_valid"].any() and (want["detection_scores"] > 0).any()
    for k in ("pair_valid", "objects", "detection_verbs"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # tolerances as in test_eval_step_matches_jax
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(got["detection_scores"],
                               want["detection_scores"], rtol=2e-4,
                               atol=2e-5)
