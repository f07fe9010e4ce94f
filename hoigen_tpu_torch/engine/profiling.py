"""Tracing and step timing (port of ``hoigen_tpu/engine/profiling.py``):
a ``torch.profiler`` trace, a step timer whose readings force the step's
completion, and the card's memory statistics.

The reference has none (wall-clock deques only). The trace holds no
named ranges: the JAX package names no scopes either, so the trace says
which kernels ran and when, not which tower they belong to.
"""
import contextlib
import os
import time
from collections import deque
from typing import Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (CPU and, where a card is present, CUDA
    activity) and write a Chrome trace, ``trace.json``, under ``logdir``.
    Yields the profiler."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _to_host(x):
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_host(v) for v in x]
    return x.cpu() if isinstance(x, torch.Tensor) else x


class StepTimer:
    """Rolling per-step wall time. :meth:`timed` forces the step's
    completion by copying ``fetch(out)`` (default: the whole output) to
    the host inside the timed window."""

    def __init__(self, window: int = 100):
        self.times = deque(maxlen=window)

    def timed(self, fn, *args, fetch=None, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _to_host(fetch(out) if fetch is not None else out)
        self.times.append(time.perf_counter() - t0)
        return out

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else float("nan")

    @property
    def p50(self) -> float:
        return float(np.median(self.times)) if self.times else float("nan")

    def images_per_sec(self, batch_size: int) -> float:
        return batch_size / self.mean if self.times else float("nan")


def device_memory_stats() -> Optional[dict]:
    """``torch.cuda.memory_stats`` of the current card (its peak
    allocation under ``allocated_bytes.all.peak``), or None without
    one."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.memory_stats()
