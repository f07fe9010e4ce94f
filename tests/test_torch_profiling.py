"""The port's profiling helpers (``hoigen_tpu_torch/engine/profiling.py``)
on the CPU: the step timer as the JAX package's test drives it, a trace
of a few steps written as a Chrome trace, and no memory statistics
without a card."""
import json
import os

import numpy as np
import torch

from hoigen_tpu_torch.engine.profiling import StepTimer, \
    device_memory_stats, trace


def test_step_timer():
    t = StepTimer(window=2)
    for _ in range(3):
        out = t.timed(lambda x: {"y": x * 2, "n": 3}, torch.ones(4),
                      fetch=lambda o: o["y"])
    assert torch.equal(out["y"], torch.full((4,), 2.0))
    assert len(t.times) == 2 and t.mean > 0 and np.isfinite(t.p50)
    assert t.images_per_sec(4) == 4 / t.mean
    assert np.isnan(StepTimer().mean) and np.isnan(StepTimer().p50)
    assert np.isnan(StepTimer().images_per_sec(4))


def test_trace_writes_a_chrome_trace(tmp_path):
    """Three small matmuls under ``trace``: a non-empty Chrome trace
    under the directory, naming the matmul."""
    a = torch.randn(32, 32)
    with trace(str(tmp_path / "tb")) as prof:
        for _ in range(3):
            a = a @ a / 32
    path = tmp_path / "tb" / "trace.json"
    assert os.path.getsize(path) > 0
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert prof.key_averages()


def test_device_memory_stats_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert device_memory_stats() is None
