"""The port's profiler trace (``hoigen_tpu_torch/engine/profiling.py::
trace``) on the CPU: a trace of a few steps written as a Chrome trace.
The tracer's own tests are in ``test_torch_tracing.py``."""
import json
import os

import torch

from hoigen_tpu_torch.engine.profiling import trace


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
