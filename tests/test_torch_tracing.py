"""The port's tracer (``hoigen_tpu_torch/engine/profiling.py``) on the
CPU: spans and their nesting, self times and sums; the off path; reset;
the idle gaps between steps and the span each is put down to; the Chrome
trace; and device ranges through the graph wrapper
(``engine/cuda_graph.py``) with the ``torch.cuda`` calls replaced by
stand-ins whose events stamp the host clock and whose graph records them
at every replay."""
import itertools
import json
import types

import pytest
import torch

from hoigen_tpu_torch.cli.main_finetune import traced
from hoigen_tpu_torch.engine import cuda_graph as cg
from hoigen_tpu_torch.engine import profiling
from hoigen_tpu_torch.engine.train import Trainer
from hoigen_tpu_torch.utils.config import RunConfig

from torch_graph_tools import TapedCapture, TapedGraph, stand_in_cuda, \
    tracing


@pytest.fixture
def clock(monkeypatch):
    """The tracer's host clock made a counter: each read is 1 ms after
    the last."""
    ticks = itertools.count(start=10 ** 6, step=10 ** 6)
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(
        perf_counter_ns=lambda: next(ticks)))


def test_spans_nest_with_parent_and_self_time(clock):
    t = profiling.Tracer()
    t.enable()
    with t.span("outer") as outer:                 # reads 1 and 8
        with t.span("inner") as inner:             # 2 and 5
            with t.span("leaf") as leaf:           # 3 and 4
                pass
        with t.span("inner"):                      # 6 and 7
            pass
    assert outer.parent is None and inner.parent is outer and \
        leaf.parent is inner
    got = t.snapshot()["spans"]
    assert got["outer"]["total_ms"] == 7 and got["outer"]["self_ms"] == 3
    assert got["inner"]["total_ms"] == 4 and got["inner"]["self_ms"] == 3
    assert got["leaf"]["self_ms"] == got["leaf"]["total_ms"] == 1


def test_snapshot_counts_means_and_steps(clock):
    t = profiling.Tracer()
    t.enable()
    for _ in range(3):
        t.next_step()
        for _ in range(2):
            with t.span("check"):
                pass
    with t.span("open"):
        got = t.snapshot()["spans"]
    assert got["check"] == {"count": 6, "steps": 3, "total_ms": 6.0,
                            "mean_ms": 1.0, "per_step_ms": 2.0,
                            "self_ms": 6.0}
    assert "open" not in got                       # still open


def test_off_records_nothing_and_allocates_nothing(monkeypatch):
    t = profiling.Tracer()
    monkeypatch.setattr(profiling, "time", None)   # no clock is read
    assert t.span("a") is t.span("b") is t.device_range("c") is \
        profiling.NULL
    with t.span("a"), t.device_range("c"):
        t.next_step()
    got = t.snapshot()
    assert got["spans"] == {} and got["ranges"] == {} and \
        got["counters"] == {"steps": 0, "waits": 0}
    t.enable("cpu")                                # on the CPU: spans only
    assert t.device_range("c") is profiling.NULL
    assert t.span("a") is not profiling.NULL


def test_reset_keeps_the_state(clock):
    t = profiling.Tracer()
    t.enable()
    with t.span("a"):
        with t.span("dropped"):
            t.reset()
    assert t.on and t.snapshot()["spans"] == {}
    with t.span("b"):
        pass
    assert set(t.snapshot()["spans"]) == {"b"}
    t.disable()
    t.reset()
    assert not t.on and t.span("c") is profiling.NULL


def _span(name, start, end, parent=None):
    return types.SimpleNamespace(name=name, start=start, end=end,
                                 parent=parent, step=0)


def test_gap_attribution_on_synthetic_intervals():
    """Each gap goes to the innermost span open at its midpoint: a child,
    its parent between children, an open span, or no span at all."""
    call = _span("call", 10, 50)
    check = _span("check", 11, 14, call)
    stage = _span("stage", 15, 40, call)
    copy = _span("stage_copy", 16, 39, stage)
    sync = _span("sync", 60, 70)
    epoch = _span("epoch", 80, None)
    spans = [sync, copy, call, stage, check, epoch]
    gaps = [(20, 30), (13, 15), (38, 42), (44, 46), (52, 56), (62, 64),
            (90, 100), (0, 4)]
    assert profiling.attribute(gaps, spans) == [
        "stage_copy", "check", "stage", "call", "host:other", "sync",
        "epoch", "host:other"]


def test_gaps_between_steps_and_their_split(clock):
    """Steps' ranges (ns on the host clock): the gap from one step's last
    event to the next one's first, put down to the span around it."""
    t = profiling.Tracer()
    t.enable()
    for name, start, end in (("stage", 100, 200), ("copy", 200, 500),
                             ("sync", 600, 900)):
        t._spans.add(_span(name, start, end))
    for rec in (("a", 0, 60, 1), ("b", 60, 100, 1), ("a", 400, 450, 2),
                ("a", 460, 480, 2), ("a", 950, 990, 3),
                ("a", 985, 1000, 4)):
        t._ranges.add(rec)
    assert profiling.step_bounds(t._ranges) == [
        (0, 100), (400, 480), (950, 990), (985, 1000)]
    gaps = t.snapshot()["gaps"]
    # 100 to 400 (midpoint in "copy"), 480 to 950 (in "sync"), an overlap
    assert gaps["count"] == 3 and gaps["total_ms"] == 770 / 1e6
    assert gaps["by_span"] == {"copy": 300 / 1e6, "sync": 470 / 1e6}
    assert gaps["mean_ms"] == pytest.approx(770 / 3e6)
    # idle inside a step: 450 to 460
    assert gaps["within_ms"] == pytest.approx(10 / 4e6)
    ranges = t.snapshot()["ranges"]
    assert ranges["a"]["count"] == 5 and ranges["a"]["steps"] == 4
    assert ranges["a"]["per_step_ms"] == pytest.approx(185 / 4e6)


def test_write_gives_a_chrome_trace(clock, tmp_path):
    t = profiling.Tracer()
    t.enable()
    t._ranges.add(("detr", 10 ** 6, 3 * 10 ** 6, 1))
    t._ranges.add(("detr", 9 * 10 ** 6, 10 ** 7, 2))
    with t.span("graph.stage"):                    # 1 to 4 ms
        with t.span("graph.stage_copy"):
            pass
    for _ in range(6):
        with t.span("trainer.sync"):               # 5 to 16 ms
            pass
    t.write(tmp_path / "trace.json")
    events = json.loads((tmp_path / "trace.json").read_text())[
        "traceEvents"]
    spans = [e for e in events if e["ph"] == "X"]
    assert {e["name"] for e in events if e["ph"] == "M"} == \
        {"process_name"}
    assert [e["name"] for e in spans if e["pid"] == 0] == \
        ["graph.stage", "graph.stage_copy"] + ["trainer.sync"] * 6
    device = [e for e in spans if e["pid"] == 1]
    assert [(e["name"], e["ts"], e["dur"]) for e in device] == [
        ("detr", 0.0, 2000.0), ("detr", 8000.0, 1000.0),
        ("idle", 2000.0, 6000.0)]
    assert device[2]["args"] == {"span": "trainer.sync"}


def test_spans_go_to_the_profiler(tmp_path):
    t = profiling.Tracer()
    t.enable()
    with torch.profiler.profile() as prof:
        with t.span("graph.replay"):
            torch.ones(4).sum()
    with t.span("unprofiled"):
        pass
    names = {e.name for e in prof.events()}
    assert "hoigen.graph.replay" in names and "hoigen.unprofiled" \
        not in names


def _graphed(monkeypatch):
    """A two-range step (``a`` then ``b``) graphed on the stand-ins."""
    capture = TapedCapture(lambda: [])
    stand_in_cuda(monkeypatch, capture, TapedGraph)

    def step(params, buffers, batch):
        with profiling.device_range("a"):
            x = batch["x"] * params["w"]
        with profiling.device_range("b"):
            y = x + 1.0
        return {"y": y}
    return cg.graphed(step), {"w": torch.full((4,), 2.0)}, \
        {"x": torch.arange(4.0).numpy()}


def test_capture_keeps_ranges_read_before_each_replay(monkeypatch):
    """The capture keeps the step's two ranges; the warm-up's are read as
    eager ranges; each replay's are read before the next replay records
    them again (each read a new time), and at the snapshot."""
    gstep, params, batch = _graphed(monkeypatch)
    with tracing("cuda") as tracer:
        gstep(params, {}, batch)                  # warm-up and capture
        g = next(iter(gstep.graphs.values()))
        assert [r.name for r in g.ranges] == ["a", "b"]
        assert all(r.kept for r in g.ranges)
        starts = []
        for _ in range(3):
            out = gstep(params, {}, batch)
            pending = [r for _, r in tracer.TRACER._pending]
            assert pending[-2:] == g.ranges       # this replay's
            assert torch.equal(out["y"], torch.tensor([1.0, 3, 5, 7]))
            starts.append([r[1] for r in tracer.TRACER._ranges
                           if r[0] == "a"])
        got = tracer.snapshot()
    # the warm-up's range, then one more each replay, read in time order
    assert [len(s) for s in starts] == [1, 2, 3]
    assert starts[-1] == sorted(set(starts[-1]))
    assert got["ranges"]["a"]["count"] == got["ranges"]["b"]["count"] == 4
    assert got["ranges"]["a"]["steps"] == 4
    assert got["ranges"]["stage"]["count"] == 4   # one input, each call
    assert got["counters"] == {"steps": 4, "waits": 0}
    assert got["gaps"]["count"] == 3


def test_a_graph_captured_with_tracing_off_holds_no_ranges(monkeypatch):
    gstep, params, batch = _graphed(monkeypatch)
    gstep(params, {}, batch)                      # captured, tracing off
    g = next(iter(gstep.graphs.values()))
    assert g.ranges == []
    with tracing("cuda") as tracer:
        for _ in range(2):
            gstep(params, {}, batch)
        got = tracer.snapshot()
    assert set(got["ranges"]) == {"stage"}
    assert got["spans"]["graph.replay"]["count"] == 2
    assert "graph.capture" not in got["spans"]


def test_graphed_call_spans_and_capture_sums(monkeypatch):
    """A capture's span holds the warm-up and the record; the staging's
    holds its wait and copy; ``warmup_s`` and ``capture_s`` add up over
    every capture."""
    gstep, params, batch = _graphed(monkeypatch)
    ticks = itertools.count()
    monkeypatch.setattr(cg, "time", types.SimpleNamespace(
        perf_counter=lambda: float(next(ticks))))
    with tracing() as tracer:
        gstep(params, {}, batch)
        with torch.no_grad():
            params["w"].mul_(2.0)                 # captured again
        gstep(params, {}, batch)
        gstep(params, {}, batch)
        spans = list(tracer.TRACER._spans)
    g = next(iter(gstep.graphs.values()))
    assert (g.captures, g.replays) == (2, 1)
    assert g.record()["warmup_s"] == g.record()["capture_s"] == 2.0
    parents = {(s.name, s.parent.name if s.parent else None) for s in spans}
    assert parents == {
        ("graph.check", None), ("graph.stage", None),
        ("graph.stage_wait", "graph.stage"),
        ("graph.stage_copy", "graph.stage"), ("graph.capture", None),
        ("graph.warmup", "graph.capture"), ("graph.record", "graph.capture"),
        ("graph.replay", None)}
    assert [s.step for s in spans if s.name == "graph.check"] == [1, 2, 3]


def test_trainer_spans_and_steps():
    """An eager step on the CPU: a ``trainer.batch`` span each ``next()``
    (the last finds none), a ``trainer.sync`` each loss, each call a
    step."""
    def step(params, buffers, batch, generator=None):
        return {"loss": batch["x"].sum()}
    trainer = Trainer(step, None, {"w": torch.ones(2)}, {},
                      checkpoint_every_epoch=False)
    with tracing() as tracer:
        loss = trainer.run_epoch([{"x": torch.ones(2) * i}
                                  for i in range(3)])
        got = tracer.snapshot()["spans"]
    assert loss == 2.0
    assert got["trainer.batch"]["count"] == 4
    assert got["trainer.sync"]["count"] == got["trainer.sync"]["steps"] == 3


def test_cli_trace_dir_writes_both_files(tmp_path):
    cfg = RunConfig(trace_dir=str(tmp_path / "trace"))
    with traced(cfg, torch.device("cpu")):
        assert profiling.TRACER.on
        with profiling.span("graph.check"):
            pass
    assert not profiling.TRACER.on
    summary = json.loads((tmp_path / "trace" /
                          "program_trace_summary.json").read_text())
    assert summary["spans"]["graph.check"]["count"] == 1
    events = json.loads((tmp_path / "trace" /
                         "program_trace.json").read_text())["traceEvents"]
    assert [e["name"] for e in events if e["ph"] == "X"] == ["graph.check"]
    profiling.reset()
    with traced(RunConfig(), torch.device("cpu")):
        assert not profiling.TRACER.on
