"""Each ported module of hoigen_tpu_torch against its JAX counterpart in
hoigen_tpu, on the CPU, from the same weights (handed over through
hoigen_tpu_torch.bridge) and the same numpy inputs. The JAX side's float64
parameters (the tests enable x64) are cast to float32 first, so
both sides compute in float32. Index outputs (NMS, proposals, pairs,
labels) must match exactly; each float tolerance is stated with its
reason.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hoigen_tpu.models import dino as j_dino
from hoigen_tpu.models import proposals as j_prop
from hoigen_tpu.models import upt as j_upt
from hoigen_tpu.models.cache import random_caches
from hoigen_tpu.models.clip import model as j_clip
from hoigen_tpu.models.clip.config import CLIPConfig as JCLIPConfig
from hoigen_tpu.models.detr import model as j_detr
from hoigen_tpu.models.detr import resnet as j_resnet
from hoigen_tpu.models.detr.config import DETRConfig as JDETRConfig
from hoigen_tpu.ops import nms as j_nms
from hoigen_tpu.ops import pixels as j_pixels
from hoigen_tpu.ops import resize as j_resize

# the package's __init__ re-exports the function under the module's name
j_roi = importlib.import_module("hoigen_tpu.ops.roi_align")

from hoigen_tpu_torch.bridge import to_torch
from hoigen_tpu_torch.models import dino as t_dino
from hoigen_tpu_torch.models import proposals as t_prop
from hoigen_tpu_torch.models import upt as t_upt
from hoigen_tpu_torch.models.clip import model as t_clip
from hoigen_tpu_torch.models.clip.config import CLIPConfig as TCLIPConfig
from hoigen_tpu_torch.models.detr import model as t_detr
from hoigen_tpu_torch.models.detr import resnet as t_resnet
from hoigen_tpu_torch.models.detr.config import DETRConfig as TDETRConfig
from hoigen_tpu_torch.ops import nms as t_nms
from hoigen_tpu_torch.ops import pixels as t_pixels
from hoigen_tpu_torch.ops import resize as t_resize
from hoigen_tpu_torch.ops import roi_align as t_roi

CLIP_KW = dict(image_resolution=32, vision_layers=2, vision_width=64,
               vision_patch_size=8, adapter_layers=(0, 1))
# the JAX config also sizes a text tower, which the port does not have
TEXT_KW = dict(transformer_layers=2, transformer_width=64, context_length=16)
DETR_KW = dict(hidden_dim=64, nheads=2, enc_layers=2, dec_layers=2,
               dim_feedforward=128, num_queries=12, num_classes=4)


def _np32(tree):
    """JAX tree -> numpy tree with floats as float32."""
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating)
        else np.asarray(a), tree)


def _rel_close(got, want, tol):
    """|got - want| <= tol * max|want|: a tolerance relative to the scale
    of the output, for deep towers whose activations grow."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.fixture(scope="module")
def r50():
    return _np32(j_resnet.init_resnet50_params(jax.random.PRNGKey(3)))


# ----------------------------------------------------------- pixels/resize
def test_pixels_match():
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (2, 3, 20, 28)).astype(np.uint8)
    sizes = np.asarray([[20, 25], [14, 28]], np.float32)
    want_mask = np.asarray(j_pixels.pad_mask_from_sizes(sizes, 20, 28))
    got_mask = t_pixels.pad_mask_from_sizes(torch.as_tensor(sizes), 20, 28)
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    want = np.asarray(j_pixels.device_normalize(images, jnp.float32,
                                                pad_mask=want_mask))
    got = t_pixels.device_normalize(torch.as_tensor(images), torch.float32,
                                    pad_mask=got_mask)
    # elementwise f32 arithmetic in the same order: bit-exact
    np.testing.assert_array_equal(got.numpy(), want)


def test_resize_matches_on_u8_levels():
    """PIL-exact bicubic as dense matmuls: the weights agree to f32
    rounding, and the CLIP stream lands on the same uint8 levels (the
    pass-wise u8 rounding is the point of the emulation)."""
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, (2, 3, 40, 56)).astype(np.uint8)
    sizes = np.asarray([[40, 49], [33, 56]], np.float32)
    for i in range(2):
        jw = np.asarray(j_resize.resize_weights(56, 24, sizes[i, 1]))
        tw = t_resize.resize_weights(56, 24, float(sizes[i, 1]))
        np.testing.assert_allclose(tw.numpy(), jw, atol=1e-6)
    want = np.asarray(j_resize.batch_resize_normalize(images, sizes, 24))
    got = t_resize.batch_resize_normalize(torch.as_tensor(images),
                                          torch.as_tensor(sizes), 24).numpy()
    mean = j_pixels.IMAGENET_MEAN.reshape(1, 3, 1, 1)
    std = j_pixels.IMAGENET_STD.reshape(1, 3, 1, 1)

    def levels(x):
        return np.round((x * std + mean) * 255.0).astype(np.int64)

    np.testing.assert_array_equal(levels(got), levels(want))
    np.testing.assert_allclose(got, want, atol=1e-5)


# ------------------------------------------------------------------ resnet
def test_resnet_nhwc_matches(r50):
    """The NHWC ResNet-50 (unfused: the fused tail is CUDA-only), f32.
    1e-4 of the output scale: 53 convs of reordered f32 sums."""
    x = np.random.default_rng(2).normal(size=(1, 64, 64, 3)) \
        .astype(np.float32)
    want = np.asarray(j_resnet.resnet50_forward_nhwc(
        jax.tree.map(jnp.asarray, r50), jnp.asarray(x)))
    got = t_resnet.resnet50_forward_nhwc(to_torch(r50), torch.as_tensor(x))
    assert got.shape == (1, 2, 2, 2048)
    _rel_close(got.numpy(), want, 1e-4)


def test_dino_matches(r50):
    """DINO: the same tower plus a global mean, on a 32x32 CLIP stream."""
    x = np.random.default_rng(3).normal(size=(2, 3, 32, 32)) \
        .astype(np.float32)
    want = np.asarray(j_dino.dino_forward(jax.tree.map(jnp.asarray, r50),
                                          jnp.asarray(x)))
    got = t_dino.dino_forward(to_torch(r50), torch.as_tensor(x))
    _rel_close(got.numpy(), want, 1e-4)


def test_fold_bn_matches():
    rng = np.random.default_rng(4)
    w = rng.normal(size=(8, 4, 3, 3)).astype(np.float32)
    bn = [rng.normal(size=8).astype(np.float32) for _ in range(3)] + \
        [rng.random(8).astype(np.float32) + 0.5]
    want = j_resnet.fold_bn(w, *bn)
    got = t_resnet.fold_bn(w, *bn)
    for k in ("w", "scale", "bias"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6)


# -------------------------------------------------------------------- DETR
def test_detr_forward_and_postprocess_match():
    """Tiny DETR on a padded 64x96 batch, f32. pred_logits/pred_boxes at
    2e-4, the transformer tolerance of the JAX package's full-dims suite;
    postprocess labels exactly."""
    jcfg, tcfg = JDETRConfig(**DETR_KW), TDETRConfig(**DETR_KW)
    params = _np32(j_detr.init_detr_params(jax.random.PRNGKey(5), jcfg))
    rng = np.random.default_rng(5)
    images = rng.normal(size=(2, 3, 64, 96)).astype(np.float32)
    mask = np.zeros((2, 64, 96), bool)
    mask[0, :, 80:] = True
    mask[1, 40:, :] = True
    sizes = np.asarray([[224, 187], [140, 224]], np.float32)
    jp = jax.tree.map(jnp.asarray, params)
    want = j_detr.detr_forward(jp, jnp.asarray(images), jnp.asarray(mask),
                               jcfg)
    got = t_detr.detr_forward(to_torch(params), torch.as_tensor(images),
                              torch.as_tensor(mask), tcfg)
    for k in ("pred_logits", "pred_boxes", "memory"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=2e-4, atol=2e-4)
    jpost = j_detr.postprocess(want["pred_logits"], want["pred_boxes"],
                               jnp.asarray(sizes))
    tpost = t_detr.postprocess(torch.as_tensor(np.asarray(
        want["pred_logits"])), torch.as_tensor(np.asarray(
            want["pred_boxes"])), torch.as_tensor(sizes))
    np.testing.assert_array_equal(tpost["labels"].numpy(),
                                  np.asarray(jpost["labels"]))
    for k in ("scores", "boxes"):
        np.testing.assert_allclose(tpost[k].numpy(), np.asarray(jpost[k]),
                                   rtol=1e-6, atol=1e-5)


def test_detr_position_and_mask_helpers_match():
    mask = np.zeros((2, 50, 70), bool)
    mask[0, :, 61:] = True
    mask[1, 33:, :] = True
    want = np.asarray(j_detr.downsample_mask(jnp.asarray(mask), 2, 3))
    got = t_detr.downsample_mask(torch.as_tensor(mask), 2, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    small = mask[:, ::10, ::10]
    want = np.asarray(j_detr.sine_position_embedding(jnp.asarray(small), 16))
    got = t_detr.sine_position_embedding(torch.as_tensor(small), 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# -------------------------------------------------------------------- CLIP
def test_clip_encode_image_with_priors_matches():
    """Adapter-CLIP ViT with detection priors (some padded), f32, at the
    adapter tolerance 1e-4. The adapters' zero-init up-projection is
    replaced by random weights so that the prior cross-attention shows."""
    jcfg, tcfg = JCLIPConfig(**CLIP_KW, **TEXT_KW), TCLIPConfig(**CLIP_KW)
    params = _np32(j_clip.init_clip_params(jax.random.PRNGKey(6), jcfg))
    rng = np.random.default_rng(6)
    for blk in params["visual"]["blocks"]:
        ad = blk["adapter"]
        ad["up_w"] = rng.normal(size=ad["up_w"].shape).astype(np.float32) \
            * 0.2
        ad["scale"] = np.ones_like(ad["scale"])
    images = rng.normal(size=(2, 3, 32, 32)).astype(np.float32)
    prior = rng.normal(size=(2, 8, 64)).astype(np.float32)
    prior_mask = np.zeros((2, 8), bool)
    prior_mask[0, 5:] = True
    prior_mask[1, 2:] = True
    jg, jl = j_clip.encode_image(jax.tree.map(jnp.asarray, params),
                                 jnp.asarray(images), jcfg,
                                 prior=jnp.asarray(prior),
                                 prior_mask=jnp.asarray(prior_mask))
    tg, tl = t_clip.encode_image(to_torch(params), torch.as_tensor(images),
                                 tcfg, prior=torch.as_tensor(prior),
                                 prior_mask=torch.as_tensor(prior_mask))
    assert tl.shape == (2, 4, 4, 512)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)


# ------------------------------------------------------- NMS and proposals
def _detections(seed, n):
    rng = np.random.default_rng(seed)
    # scores on a coarse grid, so many tie (some at 0 and below threshold)
    scores = (rng.integers(0, 6, (2, n)) / 5.0).astype(np.float32)
    labels = rng.choice(3, size=(2, n), p=[0.5, 0.3, 0.2]).astype(np.int64)
    xy = rng.random((2, n, 2)).astype(np.float32) * 150
    wh = rng.random((2, n, 2)).astype(np.float32) * 60 + 10
    boxes = np.concatenate([xy, xy + wh], -1)
    # near-duplicates of earlier boxes, so NMS suppresses
    boxes[:, n // 2:] = boxes[:, :n - n // 2] + 2.0
    return scores, labels, boxes


@pytest.mark.parametrize("n,max_instances", [(24, 4), (16, 15)],
                         ids=["more-than-max", "fewer-than-max"])
def test_nms_and_proposals_match_exactly(n, max_instances):
    """Tied scores, overlapping boxes, and (second case) fewer candidates
    in each group than max_instances (top_k needs n >= max_instances, but
    about half the detections are human and NMS drops some), so -inf
    padding entries are ranked too: the kept set, the slot order and the
    pairs equal the JAX package's."""
    scores, labels, boxes = _detections(7 + n, n)
    jcfg = j_prop.ProposalConfig(max_instances=max_instances)
    tcfg = t_prop.ProposalConfig(max_instances=max_instances)
    want_keep = np.stack([np.asarray(j_nms.batched_nms_mask(
        jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
        jnp.asarray(labels[i]), 0.5)) for i in range(2)])
    got_keep = t_nms.batched_nms_mask(torch.as_tensor(boxes),
                                      torch.as_tensor(scores),
                                      torch.as_tensor(labels), 0.5)
    np.testing.assert_array_equal(got_keep.numpy(), want_keep)
    assert not want_keep.all()

    want = jax.vmap(lambda s, l, b: j_prop.select_region_proposals(
        s, l, b, jcfg))(jnp.asarray(scores), jnp.asarray(labels),
                        jnp.asarray(boxes))
    got = t_prop.select_region_proposals(
        torch.as_tensor(scores), torch.as_tensor(labels),
        torch.as_tensor(boxes), tcfg)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    jpairs = j_prop.make_pairs(want[0], want[3], jcfg)
    tpairs = t_prop.make_pairs(got[0], got[3], tcfg)
    for w, g in zip(jpairs, tpairs):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for w, g in zip(j_prop.pair_indices(jcfg), t_prop.pair_indices(tcfg)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --------------------------------------------------------------- roi align
def test_roi_align_matches():
    """ROI-Align (aligned, adaptive sampling) on a 14x14 map at the CLIP
    stream's scale, pooled-mean and full; same f32 contractions: 1e-5."""
    rng = np.random.default_rng(8)
    feats = rng.normal(size=(2, 16, 14, 14)).astype(np.float32)
    xy = rng.random((2, 6, 2)).astype(np.float32) * 150
    rois = np.concatenate([xy, xy + rng.random((2, 6, 2)) * 70 + 2], -1) \
        .astype(np.float32)
    want = np.asarray(j_roi.roi_align_mean(jnp.asarray(feats),
                                           jnp.asarray(rois), (7, 7),
                                           14 / 224))
    got = t_roi.roi_align_mean(torch.as_tensor(feats), torch.as_tensor(rois),
                               (7, 7), 14 / 224)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    want = np.asarray(j_roi.roi_align(jnp.asarray(feats), jnp.asarray(rois),
                                      (7, 7), 14 / 224))
    got = t_roi.roi_align(torch.as_tensor(feats), torch.as_tensor(rois),
                          (7, 7), 14 / 224)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


# ---------------------------------------------------------------- UPT head
@pytest.mark.parametrize("cache_model", ["gen_feat", "cache_feat"])
def test_upt_logits_and_priors_match(cache_model):
    """compute_priors, compute_logits (the cache branches, text, and with
    gen_feat the CLIP-global and DINO terms) and compute_prior_scores on
    the same buffers; plain f32 products: 1e-4."""
    kw = dict(num_classes=24, num_shot=2, clip_resolution=32,
              cache_model=cache_model, use_pallas_cache=True)
    jcfg = j_upt.UPTConfig(proposals=j_prop.ProposalConfig(max_instances=4),
                           **kw)
    tcfg = t_upt.UPTConfig(proposals=t_prop.ProposalConfig(max_instances=4),
                           **kw)
    caches = random_caches(24, 2, num_objects=10)
    clip_params = j_clip.init_clip_params(jax.random.PRNGKey(9),
                                          JCLIPConfig(**CLIP_KW, **TEXT_KW))
    jparams, jbuf = j_upt.init_upt_params(jax.random.PRNGKey(9), jcfg,
                                          caches, clip_params)
    params, buffers = _np32(jparams), _np32(jbuf)
    tparams, tbuf = to_torch(params), to_torch(buffers)
    jparams = jax.tree.map(jnp.asarray, params)
    jbuf = jax.tree.map(jnp.asarray, buffers)

    rng = np.random.default_rng(9)
    b, s, p = 2, 8, 32

    def unit(*shape):
        x = rng.normal(size=shape).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    hum, obj, uni = unit(b, p, 512), unit(b, p, 512), unit(b, p, 512)
    glob, dino = unit(b, 512), unit(b, 2048)
    want = np.asarray(j_upt.compute_logits(
        jparams, jbuf, *map(jnp.asarray, (hum, obj, uni, glob, dino)), jcfg))
    got = t_upt.compute_logits(tparams, tbuf,
                               *map(torch.as_tensor,
                                    (hum, obj, uni, glob, dino)), tcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)

    boxes = (rng.random((b, s, 4)) * 20).astype(np.float32)
    boxes[..., 2:] += boxes[..., :2]
    scores = rng.random((b, s)).astype(np.float32)
    labels = rng.integers(0, 10, (b, s)).astype(np.int64)
    valid = rng.random((b, s)) < 0.7
    sizes = np.full((b, 2), 32.0, np.float32)
    jt, jm = j_upt.compute_priors(
        jparams, *map(jnp.asarray, (boxes, scores, labels, valid, sizes)),
        jbuf["object_embedding"], jcfg)
    tt, tm = t_upt.compute_priors(
        tparams, *map(torch.as_tensor, (boxes, scores, labels, valid,
                                        sizes)),
        tbuf["object_embedding"], tcfg)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-4,
                               atol=1e-4)
    jx, jy = j_prop.pair_indices(jcfg.proposals)
    tx, ty = t_prop.pair_indices(tcfg.proposals)
    pv = valid[:, np.asarray(jx)] & valid[:, np.asarray(jy)]
    want = np.asarray(j_upt.compute_prior_scores(
        jnp.asarray(scores), jnp.asarray(labels), jnp.asarray(pv),
        jbuf["object_class_multihot"], jx, jy, False, jcfg))
    got = t_upt.compute_prior_scores(
        torch.as_tensor(scores), torch.as_tensor(labels), torch.as_tensor(pv),
        tbuf["object_class_multihot"], tx, ty, False, tcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    for k in ("verb_lut", "verb_lut_valid", "sample_lens_H",
              "global_sample_len"):
        np.testing.assert_array_equal(tbuf[k].numpy(), np.asarray(jbuf[k]))
