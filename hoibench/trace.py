"""The benchmark's own tracing: host-clock spans around its calls into the
port's layers, and a ``torch.profiler`` window over a few steps after the
measured one, reduced to the device's busy time, its largest operations,
its idle gaps (named by the span or operator the host was in) and the
device time of each kernel by name.

Spans carry the name ``hoibench.<layer>`` into the profiler too (as
``record_function`` ranges), which is how an idle gap learns what the
host was doing.
"""
import collections
import contextlib
import time

import torch

SPAN_PREFIX = "hoibench."


class Spans:
    """Durations (s) by span name, recorded by the host clock."""

    def __init__(self):
        self.seconds = collections.defaultdict(list)

    @contextlib.contextmanager
    def span(self, name):
        with torch.profiler.record_function(SPAN_PREFIX + name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.seconds[name].append(time.perf_counter() - t0)

    def wrap_iter(self, name, it):
        """``it`` with each ``next()`` inside a span."""
        it = iter(it)
        while True:
            with self.span(name):
                try:
                    item = next(it)
                except StopIteration:
                    return
            yield item


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile(run, device):
    """Run ``run()`` under torch.profiler (CPU and CUDA activities) and
    reduce the trace. -> dict with ``busy_s``, ``window_s``, ``kernels``
    ({name: (launches, device seconds)}), ``device_ops`` and
    ``idle_gaps`` (at most ten [name, seconds] each), or None where the
    profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    dev, host = [], []
    for ev in prof.events():
        tr = ev.time_range
        # a range recorded on the host shows on the device's timeline too
        # (a user annotation): it is no device work
        if getattr(ev, "is_user_annotation", False) \
                or ev.name.startswith(SPAN_PREFIX):
            if ev.device_type == DeviceType.CPU:
                host.append((tr.start, tr.end, ev.name))
            continue
        if ev.device_type == DeviceType.CUDA:
            if tr.end > tr.start:
                dev.append((tr.start, tr.end, ev.name))
        elif ev.device_type == DeviceType.CPU:
            host.append((tr.start, tr.end, ev.name))
    if not dev:
        return None
    kernels = collections.defaultdict(lambda: [0, 0.0])
    for s, e, name in dev:
        kernels[name][0] += 1
        kernels[name][1] += (e - s) * 1e-6
    merged = _merge([[s, e] for s, e, _ in dev])
    busy_s = sum(e - s for s, e in merged) * 1e-6
    gaps = [(merged[i][1], merged[i + 1][0])
            for i in range(len(merged) - 1)
            if merged[i + 1][0] > merged[i][1]]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for s, e in gaps[:10]:
        mid = (s + e) / 2
        inside = [h for h in host if h[0] <= mid <= h[1]]
        spans = [h for h in inside if h[2].startswith(SPAN_PREFIX)]
        pick = min(spans or inside, key=lambda h: h[1] - h[0],
                   default=(0, 0, "host"))
        named.append([pick[2], (e - s) * 1e-6])
    ops = sorted(([k, v[1]] for k, v in kernels.items()),
                 key=lambda r: -r[1])[:10]
    return {"busy_s": busy_s, "window_s": window_s,
            "kernels": {k: tuple(v) for k, v in kernels.items()},
            "device_ops": ops, "idle_gaps": named}


def kernel_seconds(trace, match):
    """(launches, device seconds) of the kernels whose name ``match``
    accepts."""
    n, s = 0, 0.0
    for name, (count, secs) in trace["kernels"].items():
        if match(name):
            n += count
            s += secs
    return n, s
