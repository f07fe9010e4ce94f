"""The port's training step (hoigen_tpu_torch) against the JAX training step
(hoigen_tpu) on a tiny configuration, on the CPU, from the same weights.

The configuration is the training path's (gen_feat caches with one
generated pair per image, DINO on, the fused-cache flag and CLIP's fused
attention on, the uint8 feed) at narrow widths and in float32. On the CPU
both packages take the plain math at every kernel call site: the JAX
package its XLA fallbacks, the port the plain versions inside its
``autograd.Function``s, so the CPU run exercises the backward that K4
replaces on the card. Dropout is off on both sides (JAX's rng=None); the
port's dropout is tested on its own, since the two frameworks draw
different random streams.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hoigen_tpu.engine import hoi_model as jhm
from hoigen_tpu.models.cache import random_caches as j_random_caches
from hoigen_tpu.models.clip import model as j_clip
from hoigen_tpu.models.clip.config import CLIPConfig as JCLIPConfig
from hoigen_tpu.models.detr import DETRConfig as JDETRConfig
from hoigen_tpu.models.proposals import ProposalConfig as JProposalConfig
from hoigen_tpu.models.upt import UPTConfig as JUPTConfig
from hoigen_tpu.ops import focal as jfocal

from hoigen_tpu_torch import bridge
from hoigen_tpu_torch.engine import hoi_model as thm
from hoigen_tpu_torch.engine import partition
from hoigen_tpu_torch.engine.checkpoint import latest_checkpoint, \
    restore_checkpoint, save_checkpoint
from hoigen_tpu_torch.engine.train import Trainer
from hoigen_tpu_torch.models.cache import random_caches as t_random_caches
from hoigen_tpu_torch.models.clip import model as t_clip
from hoigen_tpu_torch.models.clip.config import CLIPConfig as TCLIPConfig
from hoigen_tpu_torch.models.clip.model import apply_dropout
from hoigen_tpu_torch.models.detr.config import DETRConfig as TDETRConfig
from hoigen_tpu_torch.models.detr.model import init_detr_params as \
    t_init_detr_params
from hoigen_tpu_torch.models.dino import init_dino_params as \
    t_init_dino_params
from hoigen_tpu_torch.models.proposals import ProposalConfig as \
    TProposalConfig
from hoigen_tpu_torch.models.upt import UPTConfig as TUPTConfig, \
    associate_with_ground_truth, language_aware_loss
from hoigen_tpu_torch.ops import _weights
from hoigen_tpu_torch.ops import focal as tfocal

from torch_port_common import CLIP_KW, DETR_HW, DETR_KW, TEXT_KW, \
    UPT_KW, f32 as _f32, spread_bbox_head as _spread_bbox_head

TRAIN_UPT_KW = dict(UPT_KW, generate_feature=True)


def _configs(dtype="float32"):
    jcfg = jhm.HOIModelConfig(
        clip=JCLIPConfig(**CLIP_KW, **TEXT_KW), detr=JDETRConfig(**DETR_KW),
        upt=JUPTConfig(proposals=JProposalConfig(max_instances=4),
                       **TRAIN_UPT_KW),
        dtype=dtype)
    tcfg = thm.HOIModelConfig(
        clip=TCLIPConfig(**CLIP_KW), detr=TDETRConfig(**DETR_KW),
        upt=TUPTConfig(proposals=TProposalConfig(max_instances=4),
                       **TRAIN_UPT_KW),
        dtype=dtype)
    return jcfg, tcfg


def _as_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_model():
    jcfg, tcfg = _configs()
    caches = j_random_caches(24, 2, num_objects=10)
    # the frozen towers' random weights (two ResNet-50s) drawn by the port,
    # in the layout both packages share: the JAX package's random init of
    # them is slow on the CPU (about 20 s)
    gen = torch.Generator().manual_seed(0)
    detr, dino = (jax.tree.map(jnp.asarray, bridge.to_numpy(t))
                  for t in (t_init_detr_params(gen, tcfg.detr),
                            t_init_dino_params(gen)))
    trainable, frozen, buffers = jhm.init_hoi_model(
        jax.random.PRNGKey(0), jcfg, caches, detr_params=detr,
        dino_params=dino)
    trainable, frozen, buffers = (_f32(trainable),
                                  _spread_bbox_head(_f32(frozen)),
                                  _f32(buffers))
    batch = jhm.make_example_batch(
        jcfg, batch_size=2, detr_hw=DETR_HW, device_clip_stream=True,
        object_class_multihot=np.asarray(buffers["object_class_multihot"]))
    return jcfg, tcfg, trainable, frozen, buffers, batch


def _port_model(jax_model):
    _, tcfg, trainable, frozen, buffers, batch = jax_model
    params, tbuf = bridge.params_from_jax(_as_np(trainable), _as_np(frozen),
                                          _as_np(buffers), device="cpu")
    return tcfg, params, tbuf, batch


def _walk(want, got, path=()):
    """(path, want leaf, got leaf) over two trees of one shape."""
    if isinstance(want, dict):
        assert set(want) == set(got), path
        for k in want:
            yield from _walk(want[k], got[k], path + (k,))
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), path
        for i, (a, b) in enumerate(zip(want, got)):
            yield from _walk(a, b, path + (i,))
    else:
        yield path, want, got


# ------------------------------------------------------------------- focal
def test_focal_functions_match_jax():
    """_bce_with_logits, binary_focal_loss_with_logits (every reduction,
    with and without weights) and prior_modulated_logits on the same
    inputs. f32 elementwise math on both sides: 1e-6 relative."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(6, 7)) * 4).astype(np.float32)
    y = (rng.random((6, 7)) < 0.3).astype(np.float32)
    w = (rng.random((6, 7)) < 0.7).astype(np.float32)
    prior = rng.random((6, 7)).astype(np.float32)
    tx, ty, tw, tp = (torch.as_tensor(a) for a in (x, y, w, prior))
    np.testing.assert_allclose(tfocal._bce_with_logits(tx, ty).numpy(),
                               np.asarray(jfocal._bce_with_logits(x, y)),
                               rtol=1e-6, atol=1e-7)
    for red in ("mean", "sum", "none"):
        for weights in (None, w):
            kw = dict(alpha=0.5, gamma=0.2, reduction=red)
            want = jfocal.binary_focal_loss_with_logits(
                x, y, weights=weights, **kw)
            got = tfocal.binary_focal_loss_with_logits(
                tx, ty, weights=None if weights is None else tw, **kw)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        tfocal.prior_modulated_logits(tx, tp).numpy(),
        np.asarray(jfocal.prior_modulated_logits(x, prior)), rtol=1e-6,
        atol=1e-6)
    with pytest.raises(ValueError):
        tfocal.binary_focal_loss_with_logits(tx, ty, reduction="max")


def test_ground_truth_association_keeps_jax_one_hot():
    """A padded GT slot with an id outside [0, C) gives a zero row, as
    jax.nn.one_hot does (F.one_hot would raise); a matched pair takes its
    GT's class."""
    cfg = TUPTConfig(num_classes=5)
    box = torch.tensor([[[10.0, 10.0, 30.0, 30.0]]])          # (1, 1, 4)
    gt = torch.tensor([[[0.2, 0.2, 0.2, 0.2], [0.2, 0.2, 0.2, 0.2]]])
    size = torch.tensor([[100.0, 100.0]])
    labels = associate_with_ground_truth(
        box, box, gt, gt, torch.tensor([[3, -1]]),
        torch.tensor([[True, True]]), size, cfg)
    np.testing.assert_array_equal(labels.numpy(), [[[0, 0, 0, 1, 0]]])
    labels = associate_with_ground_truth(
        box, box, gt, gt, torch.tensor([[7, 2]]),
        torch.tensor([[True, False]]), size, cfg)
    np.testing.assert_array_equal(labels.numpy(), [[[0, 0, 0, 0, 0]]])


def test_language_aware_loss_matches_jax():
    from hoigen_tpu.models.upt import language_aware_loss as j_la
    rng = np.random.default_rng(1)
    w = rng.normal(size=(6, 16)).astype(np.float32)
    text = rng.normal(size=(6, 16)).astype(np.float32)
    want = j_la({"text_w": jnp.asarray(w)}, jnp.asarray(text), 0.6)
    got = language_aware_loss({"text_w": torch.as_tensor(w)},
                              torch.as_tensor(text), 0.6)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


# ----------------------------------------------------------------- dropout
@pytest.mark.parametrize("rate", [0.1, 0.2], ids=["adapter", "roi"])
def test_dropout_keep_rate_and_scale(rate):
    """The adapters' (0.1) and the ROI features' (0.2) dropout: each element
    kept with probability 1 - rate (within 5 standard deviations over 200k
    draws) and scaled by exactly 1 / (1 - rate); the same generator seed
    draws the same mask. Without a generator it is the identity."""
    x = torch.ones(200_000)
    y = apply_dropout(x, rate, torch.Generator().manual_seed(3))
    kept = y != 0
    keep = 1.0 - rate
    sd = (keep * rate / x.numel()) ** 0.5
    assert abs(kept.float().mean().item() - keep) < 5 * sd
    np.testing.assert_array_equal(y[kept].numpy(),
                                  np.full(int(kept.sum()), 1.0 / keep,
                                          np.float32))
    np.testing.assert_array_equal(
        apply_dropout(x, rate, torch.Generator().manual_seed(3)).numpy(),
        y.numpy())
    assert apply_dropout(x, rate, None) is x


# --------------------------------------------------------------- CLIP block
def test_clip_fused_self_attention_matches_mha_and_jax():
    """One CLIP block's self-attention through ``_mhsa_fused`` (the fused
    attention on (B, H, L, D) views of the projections, whose output comes
    back as such a view) against the port's plain ``mha`` and the JAX
    package's ``_mhsa_fused``, f32, on the CPU: the output and the
    gradients of the input and the four weights for one output gradient.
    2e-5 of each result's scale: f32 on every side, the softmax and the
    products summed in other orders."""
    rng = np.random.default_rng(21)
    b, l, e, heads = 2, 17, 64, 4
    x = rng.normal(size=(b, l, e)).astype(np.float32)
    g = rng.normal(size=(b, l, e)).astype(np.float32)
    p = {"w_qkv": rng.normal(size=(3 * e, e)) * 0.1,
         "b_qkv": rng.normal(size=3 * e) * 0.1,
         "w_out": rng.normal(size=(e, e)) * 0.1,
         "b_out": rng.normal(size=e) * 0.1}
    p = {n: a.astype(np.float32) for n, a in p.items()}

    def jloss(p_, x_):
        return jnp.sum(j_clip._mhsa_fused(p_, x_, heads) * g)

    jp = {n: jnp.asarray(a) for n, a in p.items()}
    want_y = np.asarray(j_clip._mhsa_fused(jp, jnp.asarray(x), heads))
    want_gp, want_gx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))

    for fn in (t_clip._mhsa_fused,
               lambda p_, x_, n: t_clip.mha(p_, x_, x_, n)):
        tp = {n: torch.as_tensor(a).requires_grad_() for n, a in p.items()}
        tx = torch.as_tensor(x).requires_grad_()
        y = fn(tp, tx, heads)
        y.backward(torch.as_tensor(g))
        pairs = [(y.detach(), want_y), (tx.grad, want_gx)] + \
            [(tp[n].grad, want_gp[n]) for n in p]
        for got, want in pairs:
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=2e-5 * np.abs(want).max())


# ---------------------------------------------------- partition and bridge
def test_trainable_mask_matches_the_jax_split(jax_model):
    """The bridge marks requires_grad exactly where the JAX package puts a
    leaf in ``trainable``, and the port's own predicate over its merged
    paths (and its init) agrees; LR groups split CLIP from the head."""
    tcfg, params, _, _ = _port_model(jax_model)
    marked = {p: t.requires_grad for p, t in partition.named_leaves(params)}
    assert not any(v for p, v in marked.items() if p[0] != "upt")
    assert marked == {p: partition.trainable_predicate(p) for p in marked}
    assert marked[("upt", "clip", "visual", "positional_embedding")]
    assert not marked[("upt", "clip", "visual", "conv1_w")]
    assert marked[("upt", "adapter_H_w")]
    own, _ = thm.init_hoi_model(torch.Generator().manual_seed(0), tcfg,
                                t_random_caches(24, 2, num_objects=10),
                                device="cpu")
    own = {p: t.requires_grad for p, t in partition.named_leaves(own)}
    assert own == {p: v for p, v in marked.items() if p in own}
    # the JAX tree also holds the (frozen) text tower, which the port's
    # image-only CLIP has not
    extra = set(marked) - set(own)
    assert extra and all(p[:3] == ("upt", "clip", "text") and not marked[p]
                         for p in extra)
    groups = {partition.lr_group(p) for p, _ in
              partition.trainable_leaves(params)}
    assert groups == {"vit", "head"}
    assert partition.lr_group(("upt", "clip", "visual", "proj")) == "vit"
    assert partition.lr_group(("upt", "text_w")) == "head"


# ------------------------------------------------- the training step itself
def test_train_step_loss_and_grads_match_jax(jax_model):
    """Loss and gradients of one training step against jax.value_and_grad
    of the JAX ``_forward(training=True, rng=None)``, on the same weights
    through the bridge. Loss at 1e-5 relative; each gradient leaf at 1e-4
    of that leaf's largest magnitude (the adapters' scale of 1e-9 makes
    their inner gradients about 1e-9, so no absolute tolerance would do).
    f32 on both sides, sums in another order."""
    jcfg, _, trainable, frozen, buffers, batch = jax_model

    def jloss(tr):
        _, aux = jhm._forward(tr, frozen, buffers, batch, jcfg,
                              training=True, rng=None)
        return aux["loss_sum"] / jnp.maximum(aux["n_p"], 1.0), aux["n_p"]

    (want_loss, want_np), want_grads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(trainable)

    tcfg, params, tbuf, batch_np = _port_model(jax_model)
    tb = {k: torch.as_tensor(np.asarray(v)) for k, v in batch_np.items()}
    loss, aux = thm.train_loss(params, tbuf, tb, tcfg)
    loss.backward()
    assert float(want_np) > 0 and aux["n_p"].item() == float(want_np)
    assert float(want_loss) > 1e-3
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)

    got_grads = bridge.grads_to_numpy(params["upt"])
    n = 0
    for path, want, got in _walk(_as_np(want_grads), got_grads):
        if want is None:
            assert got is None, path
            continue
        assert got is not None and got.shape == want.shape, path
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale,
                                   err_msg=str(path))
        n += 1
    assert n > 50


def test_optimizer_matches_optax():
    """GroupedAdamW against the JAX package's make_optimizer (optax) from
    identical numpy gradients, 4 steps with lr_drop_step=2, both groups,
    one group above the clip norm and one below it, and a leaf that gets
    no gradient (optax updates and decays it from a zero gradient). The
    optimizer alone, because Adam turns tiny gradient noise into updates
    of +-lr. 1e-6: f32 Adam formula in another rounding order."""
    rng = np.random.default_rng(5)
    shapes = {"clip": {"visual": {"proj": (8, 4), "adapter": (5,)}},
              "text_w": (3, 4), "adapter_H_b": (6,)}

    def tree(fn):
        return jax.tree.map(fn, shapes, is_leaf=lambda s: isinstance(s,
                                                                     tuple))

    init = tree(lambda s: rng.normal(size=s).astype(np.float32))
    grads = [tree(lambda s: (rng.normal(size=s) * 0.3).astype(np.float32))
             for _ in range(4)]
    for g in grads:                 # the head group under the clip norm
        g["text_w"] *= 1e-3
        g["adapter_H_b"] *= 1e-3
        g["clip"]["visual"]["adapter"] *= 0.0

    jtr = jax.tree.map(jnp.asarray, init)
    opt = jhm.make_optimizer(lr_drop_step=2)(jtr)
    state = opt.init(jtr)
    for g in grads:
        upd, state = opt.update(jax.tree.map(jnp.asarray, g), state, jtr)
        jtr = optax.apply_updates(jtr, upd)

    params = {"upt": bridge.to_torch(init)}
    for _, t in partition.named_leaves(params):
        t.requires_grad_(True)
    topt = thm.make_optimizer(lr_drop_step=2)(params)
    leaves = dict(partition.named_leaves(params))
    for g in grads:
        topt.zero_grad()
        for path, t in leaves.items():
            a = g
            for k in path[1:]:
                a = a[k]
            if path[-1] != "adapter":     # no gradient at all
                t.grad = torch.as_tensor(a)
        topt.step()
    for path, want, got in _walk(_as_np(jtr), bridge.to_numpy(
            params["upt"])):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                   err_msg=str(path))
    assert topt.count == 4


def test_optimizer_state_round_trips_and_reads_the_torch_optim_layout(
        tmp_path):
    """GroupedAdamW's state through a checkpoint file: its own layout
    (moments in the groups' leaf order, the count), and the layout of
    checkpoints written while it ran ``torch.optim.AdamW`` (``{"adamw":
    AdamW.state_dict(), "count": int}``, per-leaf state numbered in the
    same order, none for a leaf that never had a gradient): every moment
    and the count are read exactly, a stateless leaf's as zeros."""
    rng = np.random.default_rng(3)
    params = {"upt": {"clip": {"visual": {
        "proj": torch.as_tensor(rng.normal(size=(4, 3)), dtype=torch.float32),
        "adapter": torch.as_tensor(rng.normal(size=(5,)),
                                   dtype=torch.float32)}},
        "text_w": torch.as_tensor(rng.normal(size=(2, 3)),
                                  dtype=torch.float32)}}
    for _, t in partition.named_leaves(params):
        t.requires_grad_(True)
    leaves = [t for g in thm.make_optimizer()(params).param_groups
              for t in g["params"]]
    adamw = torch.optim.AdamW(
        [{"params": leaves[:2], "lr": 1e-3}, {"params": leaves[2:]}],
        betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    for _ in range(2):
        for t in leaves:
            t.grad = None if t.shape == (5,) else torch.as_tensor(
                rng.normal(size=t.shape), dtype=torch.float32)
        adamw.step()
    old = restore_checkpoint(save_checkpoint(
        tmp_path / "old", 2, {"adamw": adamw.state_dict(), "count": 2}))
    opt = thm.make_optimizer()(params)
    opt.load_state_dict(old)
    assert opt.count == 2
    mus = [t for g in opt.param_groups for t in g["mu"]]
    nus = [t for g in opt.param_groups for t in g["nu"]]
    for i, t in enumerate(leaves):
        if t.shape == (5,):
            assert not mus[i].any() and not nus[i].any()
            continue
        assert torch.equal(mus[i], adamw.state[t]["exp_avg"]), i
        assert torch.equal(nus[i], adamw.state[t]["exp_avg_sq"]), i

    opt.step()
    again = thm.make_optimizer()(params)
    again.load_state_dict(restore_checkpoint(save_checkpoint(
        tmp_path / "new", 3, opt.state_dict())))
    assert again.count == 3
    for a, b in zip(again.state_dict()["mu"] + again.state_dict()["nu"],
                    opt.state_dict()["mu"] + opt.state_dict()["nu"]):
        assert torch.equal(a, b) and a is not b


# ---------------------------------------------------- trainer and resume
def test_trainer_resume_is_bit_identical(jax_model, tmp_path):
    """Two epochs with a checkpoint each, then a third: a fresh Trainer
    restored from the second checkpoint runs the third bit for bit as the
    uninterrupted one (parameters, optimizer moments and update count,
    iteration and epoch survive the round trip), with dropout on from a
    seed. Checkpoints are listed and partial restores select a subtree."""
    tcfg, params0, tbuf, batch = _port_model(jax_model)
    tb = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}

    def fresh():
        params = jax.tree.map(lambda t: t.detach().clone().requires_grad_(
            t.requires_grad), params0,
            is_leaf=lambda t: isinstance(t, torch.Tensor))
        opt = thm.make_optimizer(lr_drop_step=3)(params)
        return params, opt, thm.make_train_step(tcfg, opt, device="cpu")

    out = str(tmp_path / "ckpts")
    p1, o1, s1 = fresh()
    t1 = Trainer(s1, o1, p1, tbuf, output_dir=out)
    for e in range(2):
        loss = t1.run_epoch([tb, tb], seed=e)
        assert np.isfinite(loss) and loss > 1e-3
    ckpt = latest_checkpoint(out)
    assert ckpt.endswith("ckpt_00000004.pt")
    t1.checkpoint_every_epoch = False
    t1.run_epoch([tb, tb], seed=2)

    p2, o2, s2 = fresh()
    t2 = Trainer(s2, o2, p2, tbuf)
    t2.restore(ckpt)
    assert (t2.epoch, t2.iteration, o2.count) == (2, 4, 4)
    t2.run_epoch([tb, tb], seed=2)
    n = 0
    for path, a in partition.trainable_leaves(p1):
        b = dict(partition.trainable_leaves(p2))[path]
        np.testing.assert_array_equal(a.detach().numpy(),
                                      b.detach().numpy(), err_msg=str(path))
        n += 1
    assert n > 50 and (t2.epoch, t2.iteration) == (3, 6)

    like = {"iteration": 0, "trainable": {
        "upt/text_w": p1["upt"]["text_w"].detach()}}
    part = restore_checkpoint(ckpt, like, partial=True)
    assert part["iteration"] == 4 and set(part["trainable"]) == {"upt/text_w"}
    with pytest.raises(KeyError):
        restore_checkpoint(ckpt, like)
    path = save_checkpoint(tmp_path / "other", 7, {"x": torch.ones(2)})
    assert latest_checkpoint(tmp_path / "other") == path


def test_trainer_stops_on_a_non_finite_loss(jax_model):
    tcfg, params, tbuf, batch = _port_model(jax_model)

    def step(params, buffers, batch, generator):
        return {"loss": torch.tensor(float("nan"))}

    t = Trainer(step, None, params, tbuf)
    with pytest.raises(ValueError, match="not finite at iteration 0"):
        t.run_epoch([batch])


# ----------------------------------------------- weight copies and autograd
def test_weight_copies_never_reach_a_training_graph():
    """A source that requires grad gets a fresh, connected conversion while
    grad mode is on (uncached, so its gradient flows); under no grad it is
    cached as before. A copy made under inference_mode is not served
    outside it."""
    w = torch.arange(6, dtype=torch.float32).reshape(2, 3).requires_grad_()
    a = _weights.cast(w, torch.bfloat16)
    assert a.grad_fn is not None and _weights.cast(w, torch.bfloat16) is not a
    a.float().sum().backward()
    np.testing.assert_array_equal(w.grad.numpy(), np.ones((2, 3)))
    with torch.no_grad():
        b = _weights.cast(w, torch.bfloat16)
        assert b.grad_fn is None and _weights.cast(w, torch.bfloat16) is b
    f = torch.ones(4)
    with torch.inference_mode():
        c = _weights.cast(f, torch.bfloat16)
        assert c.is_inference() and _weights.cast(f, torch.bfloat16) is c
    d = _weights.cast(f, torch.bfloat16)
    assert not d.is_inference()
    with torch.inference_mode():
        assert _weights.cast(f, torch.bfloat16) is d


def test_two_train_steps_after_an_eval_step(jax_model):
    """The bf16-tower configuration, whose DETR casts its weights to bf16
    through the weight-copy cache: an eval step (inference mode) and then
    two training steps give the same losses and parameters as two training
    steps alone, with no inference-mode copy left in the cache."""
    _, tcfg32, trainable, frozen, buffers, batch = jax_model
    _, tcfg = _configs("bfloat16")

    def run(with_eval):
        params, tbuf = bridge.params_from_jax(
            _as_np(trainable), _as_np(frozen), _as_np(buffers), device="cpu")
        if with_eval:
            thm.make_eval_step(tcfg, device="cpu")(params, tbuf, batch)
            w = params["detr"]["input_proj"]["w"]
            assert _weights._copies[w][("cast", torch.bfloat16)][1]
        opt = thm.make_optimizer()(params)
        step = thm.make_train_step(tcfg, opt, device="cpu")
        losses = [step(params, tbuf, batch)["loss"].item() for _ in range(2)]
        if with_eval:
            w = params["detr"]["input_proj"]["w"]
            assert not _weights._copies[w][("cast", torch.bfloat16)][1]
        return losses, params

    (l1, p1), (l2, p2) = run(True), run(False)
    assert l1 == l2 and l1[1] != l1[0]
    for path, a in partition.trainable_leaves(p1):
        np.testing.assert_array_equal(
            a.detach().numpy(),
            dict(partition.trainable_leaves(p2))[path].detach().numpy())


def test_steps_run_in_full_f32_and_restore_the_flags(monkeypatch):
    """The eval and training steps run with TF32 off for matmuls and for
    cuDNN (the f32 towers' convolutions would otherwise run in TF32 on the
    card), and leave the caller's settings as they found them."""
    seen = []

    def flags():
        return (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32,
                torch.get_float32_matmul_precision())

    def forward(*args, **kwargs):
        seen.append(flags())
        return {k: torch.zeros(1) for k in (
            "detection_scores_cmp", "detection_verbs", "boxes", "objects",
            "pair_valid")}

    def loss(*args, **kwargs):
        seen.append(flags())
        w = torch.ones(1, requires_grad=True)
        return w.sum(), {"n_p": torch.ones(())}

    class Optimizer:
        def zero_grad(self):
            seen.append(flags())

        def step(self):
            seen.append(flags())

    monkeypatch.setattr(thm, "_forward", forward)
    monkeypatch.setattr(thm, "train_loss", loss)
    cudnn = torch.backends.cudnn.allow_tf32
    precision = torch.get_float32_matmul_precision()
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        before = flags()
        assert before[:2] == (True, True)
        cfg = thm.HOIModelConfig()
        thm.make_eval_step(cfg, device="cpu")({}, {}, {})
        assert flags() == before
        thm.make_train_step(cfg, Optimizer(), device="cpu")({}, {}, {})
        assert flags() == before
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.set_float32_matmul_precision(precision)
    assert len(seen) == 4
    assert all(f == (False, False, "highest") for f in seen)
