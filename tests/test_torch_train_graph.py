"""The port's training step as a CUDA graph (``engine/cuda_graph.py::
GraphedTrainStep``, applied inside ``engine/train.py::Trainer``), on the
CPU.

The step is run once (as the wrapper's warm-up does) and then again under
the recorder of ops a graph cannot hold, with dropout from a generator and
the language-aware term on. The wrapper's logic then runs with the
``torch.cuda`` calls replaced by stand-ins whose "graph" records the aten
ops of its capture and runs them again at each replay, moving no version
counter, as a CUDA graph does: replays against eager steps from identical
copies, bit for bit (losses, every trainable leaf, the moments and the
count, across the learning-rate drop, dropout on); the launch counters;
the versions bumped after a replay and a cached copy of a trained leaf
made anew; one new capture after an in-place write, a restore and a
replaced params tree. Without the stand-ins the wrapper is the eager step.
"""
import numpy as np
import pytest
import torch

from hoigen_tpu_torch.engine import cuda_graph as cg
from hoigen_tpu_torch.engine import hoi_model as thm
from hoigen_tpu_torch.engine.checkpoint import save_checkpoint
from hoigen_tpu_torch.engine.partition import trainable_leaves
from hoigen_tpu_torch.engine.train import Trainer
from hoigen_tpu_torch.models.cache import random_caches
from hoigen_tpu_torch.ops import _weights
from hoigen_tpu_torch.ops.pallas_cache import fused_cache_logits

from torch_graph_tools import TapedCapture, TapedGraph, UnsafeOps, \
    stand_in_cuda
from torch_port_common import DETR_HW, eval_configs

LR_DROP = 3


def _config(LA=True):
    return eval_configs(generate_feature=True, LA=LA)[1]


def _model(tcfg, seed=0):
    """The tiny training model on the CPU, the same for a seed, with its
    optimizer and its (host) batch."""
    caches = random_caches(tcfg.upt.num_classes, 2, num_objects=10)
    params, buffers = thm.init_hoi_model(
        torch.Generator().manual_seed(seed), tcfg, caches, device="cpu")
    # a random DETR gives near-identical boxes: spread its box head so
    # that pairs form and the focal loss has positives
    last = params["detr"]["bbox_embed"][-1]
    with torch.no_grad():
        last["w"].mul_(6.0)
        last["b"].add_(torch.randn(
            last["b"].shape, generator=torch.Generator().manual_seed(1)))
    opt = thm.make_optimizer(lr_drop_step=LR_DROP)(params)
    batch = thm.make_example_batch(
        tcfg, batch_size=2, detr_hw=DETR_HW, device_clip_stream=True,
        object_class_multihot=caches.object_class_multihot)
    return params, buffers, opt, batch


def _state(params, opt):
    """Every trainable leaf, moment and the count, as numpy."""
    return ([t.detach().numpy().copy() for _, t in trainable_leaves(params)]
            + [t.numpy().copy() for g in opt.param_groups
               for t in g["mu"] + g["nu"]] + [opt.count])


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("LA", [True, False])
def test_train_step_is_capture_safe(LA):
    """After a warm-up, a training step (dropout from a generator, CLIP's
    fused attention, the fused cache, one generated pair an image) makes
    no op that a captured graph could not hold: no tensor from host data,
    no host read, no value-dependent shape."""
    tcfg = _config(LA)
    params, buffers, opt, batch = _model(tcfg)
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    step = thm.make_train_step(tcfg, opt, device="cpu")
    gen = torch.Generator().manual_seed(0)
    step(params, buffers, batch, gen)             # the warm-up
    with UnsafeOps() as mode:
        step(params, buffers, batch, gen)
    assert mode.found == []


def test_graphed_training_on_the_cpu_is_the_eager_step():
    tcfg = _config()
    runs = []
    for graphed in (False, True):
        params, buffers, opt, batch = _model(tcfg)
        step = thm.make_train_step(tcfg, opt, device="cpu")
        gstep = cg.GraphedTrainStep(step, opt) if graphed else step
        losses = [float(gstep(params, buffers, batch,
                              torch.Generator().manual_seed(i))["loss"])
                  for i in range(2)]
        runs.append((losses, _state(params, opt)))
    assert runs[0][0] == runs[1][0] and runs[0][0][0] != runs[0][0][1]
    _same(runs[0][1], runs[1][1])
    assert gstep.graphs == {} and gstep.checks == 0


class _Runs:
    """The same model twice: through a Trainer whose step is graphed on
    the stand-ins, and eagerly, fed the same batches and seeds."""

    def __init__(self, tcfg, monkeypatch):
        self.params, self.buffers, self.opt, self.batch = _model(tcfg)
        self.eparams, self.ebuffers, self.eopt, _ = _model(tcfg)
        self.capture = TapedCapture(
            lambda: cg.tensor_leaves((self.params, self.buffers))
            + cg.tensor_leaves(self.opt.state_tensors()),
            counted=(fused_cache_logits,), launches=6)
        stand_in_cuda(monkeypatch, self.capture, TapedGraph)
        self.trainer = Trainer(
            thm.make_train_step(tcfg, self.opt, device="cpu"), self.opt,
            self.params, self.buffers, checkpoint_every_epoch=False)
        self.eager = thm.make_train_step(tcfg, self.eopt, device="cpu")
        self.gstep = self.trainer.step_fn
        self.iteration = 0

    def step(self, seed=0):
        """One epoch of one step on each side: -> (graphed, eager) loss."""
        got = self.trainer.run_epoch([self.batch], seed=seed)
        gen = None
        if seed is not None:
            gen = torch.Generator().manual_seed(seed * 1_000_003
                                                + self.iteration)
        want = float(self.eager(self.eparams, self.ebuffers, self.batch,
                                gen)["loss"])
        self.iteration += 1
        return got, want

    def check(self, seed=0):
        got, want = self.step(seed)
        assert got == want
        _same(_state(self.params, self.opt), _state(self.eparams,
                                                    self.eopt))
        return got

    def graph(self, dropout=True):
        key = (cg.signature(self.batch), dropout)
        return self.gstep.graphs[key]


def test_replays_are_the_eager_steps(monkeypatch):
    """2 + 2 steps across the learning-rate drop (at update 3), dropout
    on from a new generator each epoch: the first call warms up (a real
    step) and captures (no step), every later one replays; losses, every
    trainable leaf, the moments and the count equal the eager steps' bit
    for bit, and so do two steps from one generator not seeded again. The
    capture's launches are taken back and each replay adds them. A step
    without dropout is another graph."""
    monkeypatch.setattr(fused_cache_logits, "launches", 0)
    runs = _Runs(_config(), monkeypatch)
    assert isinstance(runs.gstep, cg.GraphedTrainStep)
    losses = [runs.check(seed=s) for s in (7, 8)]
    g = runs.graph()
    assert (runs.capture.captured, g.captures, g.replays) == (1, 1, 1)
    assert fused_cache_logits.launches == 6 and g.deltas == [0, 0, 0, 6]
    assert len(g.generator.get_state()) and len(g.graph.generators) == 1
    for s in range(9, 11):
        losses.append(runs.check(seed=s))
    assert runs.opt.count == 4 > LR_DROP
    assert (g.captures, g.replays, fused_cache_logits.launches) == (1, 3, 18)
    assert len(set(losses)) == len(losses) and all(x > 1e-3 for x in losses)
    # a generator not seeded again between steps moves on as the eager
    # step moves it
    gen, egen = (torch.Generator().manual_seed(5) for _ in range(2))
    for _ in range(2):
        got = runs.gstep(runs.params, runs.buffers, runs.batch, gen)
        want = runs.eager(runs.eparams, runs.ebuffers, runs.batch, egen)
        assert torch.equal(got["loss"], want["loss"])
        assert torch.equal(got["n_p"], want["n_p"]) and want["n_p"] > 0
    assert torch.equal(gen.get_state(), egen.get_state())
    assert g.replays == 5
    _same(_state(runs.params, runs.opt), _state(runs.eparams, runs.eopt))

    runs.check(seed=None)                         # no dropout: its own graph
    runs.check(seed=None)
    g0 = runs.graph(dropout=False)
    assert (g0.captures, g0.replays, len(runs.gstep.graphs)) == (1, 1, 2)
    assert runs.gstep.checks == 8
    text = cg.signature_text(cg.signature(runs.batch))
    assert set(runs.gstep.records()) == {text, text + ", dropout"}


def test_a_replay_bumps_versions_and_cached_copies_follow(monkeypatch):
    """A replay writes the leaves, gradients, moments and count without
    moving their versions; the wrapper bumps each, so that a cached copy
    of a trained leaf (``ops/_weights.py``) is made anew; the new versions
    are the graph's own, so the next call replays."""
    runs = _Runs(_config(), monkeypatch)
    runs.check()
    runs.check()
    g = runs.graph()
    leaf = runs.params["upt"]["adapter_H_w"]
    with torch.no_grad():
        stale = _weights.cast(leaf, torch.bfloat16)
    written = cg.tensor_leaves(runs.opt.state_tensors())
    before = [t._version for t in written]
    runs.check()
    assert g.replays == 2 and g.captures == 1
    assert all(t._version == v + 1 for t, v in zip(written, before))
    with torch.no_grad():
        fresh = _weights.cast(leaf, torch.bfloat16)
    assert fresh is not stale and not torch.equal(fresh, stale)
    assert torch.equal(fresh, leaf.detach().to(torch.bfloat16))


def test_changes_between_replays_capture_once_more(monkeypatch, tmp_path):
    """An in-place write to a trainable leaf, a ``Trainer.restore`` from a
    checkpoint (the parameters and the optimizer's state written in
    place) and a params tree with a replaced frozen tensor: each makes
    exactly one new capture, and the replay after it equals the eager
    step on the same change."""
    runs = _Runs(_config(), monkeypatch)
    runs.check()
    runs.check()
    g = runs.graph()

    def after(change):
        captures = g.captures
        change()
        runs.check()
        runs.check()
        assert (g.captures - captures, g.graph is not None) == (1, True)

    def write():
        with torch.no_grad():
            for p in (runs.params, runs.eparams):
                p["upt"]["adapter_H_w"].mul_(1.25)

    after(write)
    path = save_checkpoint(tmp_path, 4, runs.trainer.state())
    runs.check()

    def restore():
        runs.trainer.restore(path)
        eager = Trainer(runs.eager, runs.eopt, runs.eparams, runs.ebuffers)
        eager.restore(path)
        runs.iteration = 4
        assert runs.opt.count == runs.eopt.count == 4

    after(restore)

    def replace():
        for p in (runs.params, runs.eparams):
            visual = p["upt"]["clip"]["visual"]
            p["upt"] = dict(p["upt"], clip=dict(p["upt"]["clip"], visual=dict(
                visual, conv1_w=visual["conv1_w"].clone())))

    after(replace)
    assert g.leaves[0] is cg.tensor_leaves(
        (runs.params, runs.buffers))[0]


def test_mesh_check_runs_are_held_bit_for_bit():
    """``tools/mesh_graph_check.py``'s runs on the CPU: two from one model
    and seed, through ``Trainer``, are 0 apart in every kind of its
    ``gap``, which is what ``mesh_run`` and ``chip_smoke.py`` phase 6c
    hold them to; one ulp in a loss, a trainable leaf or a moment, a
    count off by one or a NaN is not."""
    from hoigen_tpu_torch.tools import mesh_graph_check as mgc
    tcfg = _config()
    params, buffers, _, batch = _model(tcfg)
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    runs = [mgc.new_run(tcfg, (params, buffers), "cpu") for _ in range(2)]
    for r in runs:
        for _ in range(2):
            mgc.step_once(r, batch)
    a, b = (mgc.state(r) for r in runs)
    assert a["count"] == 2 and np.isfinite(a["metrics"]).all()
    assert mgc.gap(a, b) == dict.fromkeys(
        ("loss", "n_p", "leaves", "moments", "count"), 0)

    def ulp(t):
        return torch.nextafter(t, torch.full_like(t, np.inf))
    for key, change in (
            ("loss", lambda s: s["metrics"].__setitem__(
                (1, 0), np.nextafter(s["metrics"][1, 0], np.inf))),
            ("leaves", lambda s: s["leaves"][-1].copy_(ulp(s["leaves"][-1]))),
            ("moments", lambda s: s["moments"][0].copy_(
                ulp(s["moments"][0]))),
            ("count", lambda s: s.__setitem__("count", 3)),
            ("leaves", lambda s: s["leaves"][0].view(-1)[0].fill_(np.nan))):
        got = mgc.state(runs[0])
        change(got)
        assert not mgc.gap(got, b)[key] <= 0, key
