"""The port's legacy interaction head (``hoigen_tpu_torch/models/
interaction_head.py``), its spatial encodings (``ops/spatial.py``) and the
box masks (``ops/masks.py``) against the JAX package's, on the CPU.

The head runs from the JAX head's weights carried across, on two images
at once where the JAX head is vmapped over them: logits within 2e-4 of
their scale (float32 on both sides, sums in another order), the priors
within 1e-6 and ``pair_valid`` equal. The masks are products and clips
of exact values, so they are held bit for bit against JAX and the JAX
package's C++ cross-check.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hoigen_tpu.models import interaction_head as jih
from hoigen_tpu.models.proposals import ProposalConfig as JProposalConfig
from hoigen_tpu.native import generate_masks_native
from hoigen_tpu.ops import masks as jmasks
from hoigen_tpu.ops import spatial as jspatial

from hoigen_tpu_torch.models import interaction_head as tih
from hoigen_tpu_torch.models.proposals import ProposalConfig as \
    TProposalConfig
from hoigen_tpu_torch.ops import masks as tmasks
from hoigen_tpu_torch.ops import spatial as tspatial

TOL = 2e-4


def _boxes(rng, n, lim):
    xy = rng.uniform(0, lim * 0.7, (n, 2))
    wh = rng.uniform(0.5, lim * 0.5, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.as_tensor(np.array(a, np.float32)),
                        tree)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor))


def test_spatial_encodings_match_jax():
    """36 features of 64 box pairs (one a repeat, so an IoU of 1) within
    2e-4 of JAX's, the log features too."""
    rng = np.random.default_rng(0)
    b1, b2 = _boxes(rng, 64, 100.0), _boxes(rng, 64, 100.0)
    b2[5] = b1[5]
    shape = np.asarray([90.0, 120.0], np.float32)
    want = np.asarray(jspatial.compute_spatial_encodings(
        jnp.asarray(b1), jnp.asarray(b2), jnp.asarray(shape)))
    got = tspatial.compute_spatial_encodings(
        torch.as_tensor(b1), torch.as_tensor(b2), torch.as_tensor(shape))
    assert got.shape == want.shape == (64, 36)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert float(got[5, 13]) == pytest.approx(1.0)


@pytest.fixture(scope="module")
def head():
    cfg_kw = dict(num_classes=11, num_channels=64)
    jcfg = jih.InteractionHeadConfig(
        proposals=JProposalConfig(max_instances=3), **cfg_kw)
    tcfg = tih.InteractionHeadConfig(
        proposals=TProposalConfig(max_instances=3), **cfg_kw)
    # float32 on both sides (the tests run JAX with x64 on)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                           jih.init_interaction_head(jax.random.PRNGKey(0),
                                                     jcfg))
    return jcfg, tcfg, jparams


def test_init_interaction_head_matches_jax_layout(head):
    jcfg, tcfg, jparams = head
    tparams = tih.init_interaction_head(torch.Generator().manual_seed(0),
                                        tcfg)
    want = {jax.tree_util.keystr(p): np.shape(x)
            for p, x in jax.tree_util.tree_leaves_with_path(jparams)}
    got = {jax.tree_util.keystr(p): tuple(x.shape)
           for p, x in _leaves(tparams)}
    assert got == want and len(got) > 100


@pytest.mark.parametrize("training", [True, False])
def test_interaction_head_matches_jax(head, training):
    """Two images, each with padded slots (one image's fourth slot, the
    other's second and sixth), against the JAX head vmapped over them."""
    jcfg, tcfg, jparams = head
    rng = np.random.default_rng(5)
    b, s = 2, jcfg.proposals.n_slots
    gf = rng.normal(size=(b, 64)).astype(np.float32)
    hs = rng.normal(size=(b, s, 256)).astype(np.float32)
    boxes = np.stack([_boxes(rng, s, 100.0) for _ in range(b)])
    scores = rng.random((b, s)).astype(np.float32)
    labels = rng.integers(0, 5, (b, s))
    valid = np.ones((b, s), bool)
    valid[0, 3] = valid[1, 1] = valid[1, 5] = False
    multihot = (rng.random((5, 11)) < 0.4).astype(np.float32)
    size = np.asarray([[100.0, 100.0], [80.0, 120.0]], np.float32)

    def one(g, h, bx, sc, lb, v, sz):
        return jih.interaction_head_forward(
            jparams, g, h, bx, sc, lb, v, sz, jnp.asarray(multihot), jcfg,
            training=training)
    jl, jp, jv = jax.jit(jax.vmap(one))(*(jnp.asarray(a) for a in (
        gf, hs, boxes, scores, labels, valid, size)))
    jp = jnp.moveaxis(jp, 1, 0)
    tl, tp, tv = tih.interaction_head_forward(
        _to_torch(jparams), *(torch.as_tensor(a) for a in (
            gf, hs, boxes, scores, labels, valid, size)),
        torch.as_tensor(multihot), tcfg, training=training)
    assert tl.shape == (b, jcfg.proposals.n_pairs, 11)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-6)
    scale = float(np.abs(np.asarray(jl)).max())
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=0,
                               atol=TOL * scale)


def test_generate_masks_match_jax_and_native():
    """30 boxes (fractional edges, boxes within one row or column, boxes
    past the canvas) at 24 x 40: equal bit for bit to JAX's
    generate_masks and to the C++ cross-check."""
    rng = np.random.default_rng(5)
    boxes = _boxes(rng, 30, 30.0)
    boxes[0] = [2.25, 3.5, 2.75, 3.9]
    boxes[1] = [-3.0, -2.5, 50.0, 10.25]
    h, w = 24, 40
    got = tmasks.generate_masks(torch.as_tensor(boxes), h, w).numpy()
    want = np.asarray(jmasks.generate_masks(jnp.asarray(boxes), h, w))
    assert got.shape == (30, h, w) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, generate_masks_native(boxes, h, w))


def test_generate_masks_area():
    """Inside the canvas, a mask's total coverage is its box's area."""
    boxes = torch.tensor([[1.25, 2.5, 7.75, 9.0], [3.0, 3.0, 3.4, 3.2]])
    m = tmasks.generate_masks(boxes, 16, 16)
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    np.testing.assert_allclose(m.sum((1, 2)).numpy(), areas.numpy(),
                               rtol=1e-5)
