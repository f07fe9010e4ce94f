"""The port's eval step can be captured as a CUDA graph, and the graph
wrapper's own logic (``hoigen_tpu_torch/engine/cuda_graph.py``), on the CPU.

A captured graph replays device work only: a tensor built from host data
(a synchronous host-to-card copy), a read of a device value on the host,
or an op whose output shape depends on values has no place in it. The
step is run once (as the wrapper's warm-up does) and then again under a
``TorchDispatchMode`` that records every such op with the port's frame
that issued it, for the tiny HICO-DET configuration and for a 92-logit
DETR head (the V-COCO gather).

The wrapper's logic that needs no card: the signature key, the weight
check, the CPU path (the eager step, bit for bit), and, with the CUDA
calls replaced by stand-ins that run the step eagerly at "capture", the
capture, replay, recapture and launch-count bookkeeping, and the staging
of host inputs (the pipeline's chunks, the bytes, its counter, the wait
for the previous copy, loads from many threads at once).
"""
import contextlib
import dataclasses
import os
import sys
import threading

import numpy as np
import pytest
import torch

from hoigen_tpu_torch.engine import cuda_graph as cg
from hoigen_tpu_torch.engine import hoi_model as thm
from hoigen_tpu_torch.models.cache import random_caches
from hoigen_tpu_torch.models.detr.config import DETRConfig
from hoigen_tpu_torch.ops import _weights
from hoigen_tpu_torch.ops.pallas_cache import fused_cache_logits
from hoigen_tpu_torch.ops.pixels import IMAGENET_MEAN, IMAGENET_STD

from torch_graph_tools import UnsafeOps, stand_in_cuda, tracer, tracing
from torch_port_common import DETR_HW, DETR_KW, eval_configs


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread while a test here runs: its steps are tiny, and
    beside the other test workers more threads only contend (about 95 s
    against 1.5 s for the bookkeeping test under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(tcfg, num_objects=10, seed=0):
    params, buffers = thm.init_hoi_model(
        torch.Generator().manual_seed(seed), tcfg,
        random_caches(tcfg.upt.num_classes, 2, num_objects=num_objects),
        device="cpu")
    batch = thm.make_example_batch(tcfg, batch_size=2, detr_hw=DETR_HW,
                                   device_clip_stream=True)
    return params, buffers, {k: torch.as_tensor(v) for k, v in batch.items()}


def _vcoco_config():
    _, tcfg = eval_configs()
    return thm.HOIModelConfig(
        clip=tcfg.clip, detr=DETRConfig(**dict(DETR_KW, num_classes=92)),
        upt=dataclasses.replace(tcfg.upt, use_dino=False), dtype="float32")


@pytest.mark.parametrize("which", ["hicodet", "detr_92_logits"])
def test_eval_step_is_capture_safe(which):
    tcfg = eval_configs()[1] if which == "hicodet" else _vcoco_config()
    params, buffers, batch = _model(
        tcfg, num_objects=10 if which == "hicodet" else 81)
    step = thm.make_eval_step(tcfg, device="cpu")
    step(params, buffers, batch)          # the warm-up
    with UnsafeOps() as mode:
        step(params, buffers, batch)
    assert mode.found == []


def test_constants_are_made_once_and_equal_the_host_tables():
    for table in (IMAGENET_MEAN, IMAGENET_STD):
        t = _weights.constant(tuple(table.tolist()), "cpu")
        assert t is _weights.constant(tuple(table.tolist()), "cpu")
        assert not t.is_inference()
        assert torch.equal(t, torch.as_tensor(table))
    idx = _weights.constant((0, 5, 91), "cpu", torch.long)
    assert idx.dtype == torch.long and idx.tolist() == [0, 5, 91]


def test_signature_keys_shapes_and_dtypes():
    a = {"images": np.zeros((2, 3, 8, 8), np.uint8),
         "image_sizes": np.zeros((2, 2), np.float32)}
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    assert cg.signature(a) == cg.signature(t)
    assert cg.signature(a) == cg.signature(dict(reversed(a.items())))
    for other in (dict(a, images=np.zeros((2, 3, 8, 16), np.uint8)),
                  dict(a, image_sizes=np.zeros((2, 2), np.int32)),
                  dict(a, gt_valid=np.zeros((2, 4), bool))):
        assert cg.signature(other) != cg.signature(a)


def test_weight_check_sees_writes_and_replaced_leaves():
    params = {"a": {"w": torch.ones(3), "b": [torch.zeros(2)]},
              "none": None}
    buffers = {"lut": torch.arange(4)}
    leaves = cg.tensor_leaves((params, buffers))
    assert [t.shape[0] for t in leaves] == [3, 2, 4]
    versions = [t._version for t in leaves]
    assert cg.unchanged(cg.tensor_leaves((params, buffers)), leaves,
                        versions)
    with torch.no_grad():
        params["a"]["b"][0].add_(1.0)
    assert not cg.unchanged(cg.tensor_leaves((params, buffers)), leaves,
                            versions)
    versions = [t._version for t in leaves]
    replaced = dict(params, a=dict(params["a"], w=params["a"]["w"] * 2))
    assert not cg.unchanged(cg.tensor_leaves((replaced, buffers)), leaves,
                            versions)
    fewer = {"a": {"w": params["a"]["w"]}}
    assert not cg.unchanged(cg.tensor_leaves((fewer, buffers)), leaves,
                            versions)


def test_graphed_on_the_cpu_is_the_eager_step():
    _, tcfg = eval_configs()
    params, buffers, batch = _model(tcfg)
    step = thm.make_eval_step(tcfg, device="cpu")
    want = step(params, buffers, batch)
    gstep = cg.graphed(step)
    with tracing() as tracer:
        for feed in (batch, {k: v.numpy() for k, v in batch.items()}):
            got = gstep(params, buffers, feed)
            assert got.keys() == want.keys()
            for k in want:
                assert torch.equal(got[k], want[k]), k
        spans = tracer.snapshot()["spans"]
    # the leaf walk finds the CPU: nothing staged, captured or replayed
    assert gstep.graphs == {} and set(spans) == {"graph.check"}


class _Launches:
    """Stand-in for the capture: K3's counter moves as three launches
    would, and the step runs eagerly into the static outputs."""

    def __init__(self):
        self.captured = 0

    @contextlib.contextmanager
    def graph(self, g, pool=None, capture_error_mode=None):
        self.captured += 1
        fused_cache_logits.launches += 3
        yield


class _Graph:
    def replay(self):
        pass


def test_capture_replay_and_recapture_bookkeeping(monkeypatch, tracer):
    fake = _Launches()
    stand_in_cuda(monkeypatch, fake.graph, _Graph)
    monkeypatch.setattr(fused_cache_logits, "launches", 0)

    _, tcfg = eval_configs()
    params, buffers, batch = _model(tcfg)
    step = thm.make_eval_step(tcfg, device="cpu")
    gstep = cg.graphed(step)
    host = {k: v.numpy() for k, v in batch.items()}
    first = gstep(params, buffers, host)          # warm-up and capture
    g = gstep.graphs[cg.signature(batch)]
    assert (fake.captured, g.captures, g.replays) == (1, 1, 0)
    assert fused_cache_logits.launches == 0       # the capture's taken back
    assert g.deltas == [0, 0, 0, 3, 0]
    second = gstep(params, buffers, batch)        # a replay
    assert (g.captures, g.replays, fused_cache_logits.launches) == (1, 1, 3)
    want = step(params, buffers, batch)
    for k in want:
        assert torch.equal(first[k], want[k]) and \
            torch.equal(second[k], want[k]), k
        assert second[k] is not g.static_out[k]   # each call owns its copy
    # the staging copied the numpy feed into the static inputs
    for k, v in batch.items():
        assert torch.equal(g.static_in[k], v), k

    # a leaf written in place, then a replaced one: captured again
    with torch.no_grad():
        params["upt"]["adapter_H_w"].mul_(1.5)
    gstep(params, buffers, batch)
    assert g.captures == 2
    replaced = dict(params, upt=dict(
        params["upt"], logit_scale_U=params["upt"]["logit_scale_U"] * 2))
    gstep(replaced, buffers, batch)
    gstep(replaced, buffers, batch)
    assert (g.captures, g.replays, fused_cache_logits.launches) == (3, 2, 6)
    assert g.leaves[0] is cg.tensor_leaves((replaced, buffers))[0]
    spans = tracer.snapshot()["spans"]
    assert spans["graph.check"]["count"] == spans["graph.stage"]["count"] \
        == 5
    assert spans["graph.capture"]["count"] == 3 and \
        spans["graph.replay"]["count"] == 2


# ---------------------------------------------------------------- staging
@pytest.mark.parametrize("rows", [1, 7, 32])
@pytest.mark.parametrize("nbytes", [cg.PIPE_BYTES - 1, cg.PIPE_BYTES,
                                    173 << 20])
def test_chunk_plan_covers_every_row_once(rows, nbytes):
    plan = cg.chunk_plan(rows, nbytes)
    assert [a for a, _ in plan] == [0] + [b for _, b in plan[:-1]]
    assert plan[-1][1] == rows and all(a < b for a, b in plan)
    # whole rows of about CHUNK_BYTES: one row, or no more than the chunk
    row = nbytes / rows
    assert all(b - a == 1 or (b - a) * row <= cg.CHUNK_BYTES
               for a, b in plan)
    assert len(plan) == 1 or (plan[0][1] + 1) * row > cg.CHUNK_BYTES
    if rows >= 2 and nbytes >= cg.PIPE_BYTES:
        assert len(plan) >= 2


def _staged_feed(kind):
    """A host batch of one kind, and whether its large input is piped
    (with ``PIPE_BYTES`` at 4 KiB and ``CHUNK_BYTES`` at 1 KiB)."""
    gen = np.random.default_rng(3)
    small = {"image_sizes": gen.random((7, 2), dtype=np.float32),
             "gt_count": gen.integers(1, 9, (7,), dtype=np.int32)}
    big = {"uint8": gen.integers(0, 256, (7, 3, 16, 24), dtype=np.uint8),
           "float32": gen.standard_normal((7, 3, 16, 24), np.float32),
           "cpu_tensor": torch.from_numpy(
               gen.standard_normal((7, 3, 16, 24), np.float32)),
           "strided": gen.integers(0, 256, (7, 3, 16, 48),
                                   dtype=np.uint8)[..., ::2],
           "small": None}[kind]
    feed = dict(small) if big is None else dict(small, images=big)
    return feed, kind not in ("strided", "small")


def _bytes(x):
    return torch.as_tensor(np.ascontiguousarray(x)).view(torch.uint8)


@pytest.mark.parametrize("kind", ["uint8", "float32", "cpu_tensor",
                                  "strided", "small"])
def test_staging_copies_the_source_bit_for_bit(monkeypatch, kind):
    stand_in_cuda(monkeypatch, None, None)
    monkeypatch.setattr(cg, "PIPE_BYTES", 4096)
    monkeypatch.setattr(cg, "CHUNK_BYTES", 1024)
    feed, pipes = _staged_feed(kind)
    g = cg._Graph(feed, "cpu")
    for step in range(2):
        g.load(feed)
        for k, v in feed.items():
            assert torch.equal(g.static_in[k].view(torch.uint8),
                               _bytes(v)), (k, step)
        for v in feed.values():
            v += 1                  # in place: a strided view stays one
    assert cg.piped(feed.get("images", feed["image_sizes"])) == pipes
    # a row is over 1 KiB: one row a chunk
    assert g.record()["loads"] == 2
    assert g.record()["piped_loads"] == (2 if pipes else 0)
    assert g.record()["chunks_per_piped_load"] == (7 if pipes else 0)


class _Copied:
    """Stand-in for the staging's event, which keeps what was asked of
    it, in order."""

    def __init__(self, calls):
        self.calls = calls

    def record(self, stream=None):
        self.calls.append("record")

    def synchronize(self):
        self.calls.append("synchronize")


def test_a_second_load_waits_for_the_first_copy(monkeypatch):
    stand_in_cuda(monkeypatch, None, None)
    monkeypatch.setattr(cg, "PIPE_BYTES", 4096)
    monkeypatch.setattr(cg, "CHUNK_BYTES", 1024)
    feed, _ = _staged_feed("uint8")
    g = cg._Graph(feed, "cpu")
    calls = []
    g.copied = _Copied(calls)
    g.load(feed)
    g.load(feed)
    # each load waits for the staging's copy before it writes the pinned
    # buffers, and marks its own copies after the last one's enqueue
    assert calls == ["synchronize", "record"] * 2
    assert g.record()["piped_loads"] == 2


def test_loads_from_many_threads_share_one_pool(monkeypatch):
    stand_in_cuda(monkeypatch, None, None)
    monkeypatch.setattr(cg, "PIPE_BYTES", 4096)
    monkeypatch.setattr(cg, "CHUNK_BYTES", 1024)
    monkeypatch.setattr(cg, "_pool", None)
    feeds = [_staged_feed(kind)[0] for kind in ("uint8", "float32")]
    n = 16
    graphs = [cg._Graph(feeds[i % 2], "cpu") for i in range(n)]
    pools, errors = [None] * n, []

    def work(i):
        try:
            for step in range(5):
                feed = {k: v + step for k, v in feeds[i % 2].items()}
                graphs[i].load(feed)
                for k, v in feed.items():
                    assert torch.equal(graphs[i].static_in[k]
                                       .view(torch.uint8), _bytes(v))
            pools[i] = cg.staging_pool()
        except Exception as e:     # noqa: BLE001 (read on the main thread)
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    try:
        assert not any(t.is_alive() for t in threads) and errors == []
        assert all(p is pools[0] for p in pools) and pools[0] is not None
        assert pools[0]._max_workers == min(
            cg.POOL_CAP, len(os.sched_getaffinity(0)))
        assert all(g.record()["piped_loads"] == 5 for g in graphs)
    finally:
        cg._pool.shutdown()
