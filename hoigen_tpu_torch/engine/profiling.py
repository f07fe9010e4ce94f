"""Tracing (the counterpart of ``hoigen_tpu/engine/profiling.py``, whose
step timer it replaces): the program's one tracer, of host spans, device
ranges and the idle gaps between steps on one clock, and a
``torch.profiler`` trace.

The tracer is off until :func:`enable`. Off, :func:`span` and
:func:`device_range` return one shared context that does nothing, after
one flag check: no allocation, no clock read, nothing added to a graph.

- A **span** is host time: a name, its start and end on
  ``time.perf_counter_ns()``, the span open around it (its parent) and the
  step it belongs to (:func:`next_step`: the graphed steps and the
  Trainer's eager path count them). Spans are kept in memory and written
  out only at the end. While a ``torch.profiler`` records, each span also
  opens a ``record_function`` range named ``hoigen.<name>``, so that the
  profiler's trace shows the program's spans beside the kernels.
- A **device range** is two timing events recorded on the current stream
  around the device work enqueued inside it; ranges are timed only where
  :func:`enable` was given a CUDA device. Recorded inside a CUDA graph's
  capture (:func:`capturing`) they become event-record nodes that the
  graph keeps, so every replay times every range again. A replay's ranges
  are pending until read: completed ones at the next step, and a graph's
  own before its next replay (which records them again), or at
  :func:`snapshot`. Reading a range that has not completed waits for it
  (``waits`` counts those); in a closed loop, which reads each step's
  result before the next step, none has to wait.
- **One clock.** :func:`enable` on the card waits for the card, records an
  anchor event and takes the host time; every event is placed on the
  host's clock as the anchor plus its elapsed time from the anchor (float
  milliseconds, about 1e-7 of that distance: :func:`reset` takes a new
  anchor). The **idle gap between steps** is the device time from one
  step's last event to the next step's first; each gap is put down to the
  innermost span open at its midpoint, or to ``host:other``.
- The **image tower** of the traced run (:func:`tower`): its name, its
  blocks and the tokens a step gives it, set once where tracing starts.

:func:`snapshot` sums it all up by name, :func:`write` writes a Chrome
trace of spans, ranges and gaps. Spans are kept for the thread that
opens them; the program opens them on its main thread.
"""
import bisect
import contextlib
import json
import os
import time

import torch

PREFIX = "hoigen."
OTHER = "host:other"


class _Null:
    """The context of every span and range while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL = _Null()


class _Span:
    __slots__ = ("tracer", "name", "parent", "step", "start", "end",
                 "annotation")

    def __init__(self, tracer, name):
        self.tracer = tracer
        self.name = name
        self.end = None

    def __enter__(self):
        t = self.tracer
        self.parent = t._open[-1] if t._open else None
        self.step = t.step
        t._open.append(self)
        t._spans.add(self)
        self.annotation = None
        if torch.autograd._profiler_enabled():
            self.annotation = torch.autograd.profiler.record_function(
                PREFIX + self.name)
            self.annotation.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        opened = self.tracer._open
        if opened and opened[-1] is self:
            opened.pop()
        return False


class _Range:
    __slots__ = ("tracer", "name", "begin", "end", "kept")

    def __init__(self, tracer, name):
        self.tracer = tracer
        self.name = name

    def __enter__(self):
        t = self.tracer
        self.kept = t._captured is not None
        self.begin = t._event(self.kept)
        self.begin.record()
        return self

    def __exit__(self, *exc):
        t = self.tracer
        self.end = t._event(self.kept)
        self.end.record()
        if self.kept:
            t._captured.append(self)
        else:
            t._pending.append((t.step, self))
        return False


class _Log:
    """Records in a preallocated list, doubled when full."""
    __slots__ = ("items", "n")

    def __init__(self, capacity=4096):
        self.items = [None] * capacity
        self.n = 0

    def add(self, item):
        if self.n == len(self.items):
            self.items.extend([None] * self.n)
        self.items[self.n] = item
        self.n += 1

    def __iter__(self):
        return iter(self.items[:self.n])


def _stats(durations, steps):
    """{count, steps, total_ms, mean_ms (a record), per_step_ms} of
    durations in ns and the steps they fell in."""
    total = sum(durations) / 1e6
    n, s = len(durations), len(set(steps))
    return {"count": n, "steps": s, "total_ms": total,
            "mean_ms": total / n, "per_step_ms": total / s}


def self_times(spans):
    """Each closed span's duration minus those of its closed children
    (ns), in the order given."""
    children = {}
    for s in spans:
        if s.end is not None and s.parent is not None:
            children[id(s.parent)] = children.get(id(s.parent), 0) + \
                s.end - s.start
    return [s.end - s.start - children.get(id(s), 0) for s in spans]


def step_bounds(ranges):
    """[(first start, last end)] of each step's ranges ((name, start, end,
    step) records), in time order."""
    bounds = {}
    for _, start, end, step in ranges:
        lo, hi = bounds.get(step, (start, end))
        bounds[step] = (min(lo, start), max(hi, end))
    return sorted(bounds.values())


def uncovered(ranges):
    """The device time (ns) inside each step's extent, from its first
    event to its last, that none of its ranges covers, summed over the
    steps."""
    by_step = {}
    for _, start, end, step in ranges:
        by_step.setdefault(step, []).append((start, end))
    total = 0
    for intervals in by_step.values():
        intervals.sort()
        reached = intervals[0][0]
        for start, end in intervals:
            total += max(start - reached, 0)
            reached = max(reached, end)
    return total


def attribute(gaps, spans):
    """The name of the innermost span open at each gap's midpoint, or
    ``host:other``. ``spans`` nest (one thread's); an open span (end None)
    covers every later time."""
    spans = sorted(spans, key=lambda s: s.start)
    starts = [s.start for s in spans]
    names = []
    for lo, hi in gaps:
        mid = (lo + hi) / 2
        i = bisect.bisect_right(starts, mid) - 1
        s = spans[i] if i >= 0 else None
        # the last span begun before the midpoint, or the span around it
        while s is not None and s.end is not None and s.end < mid:
            s = s.parent
        names.append(OTHER if s is None else s.name)
    return names


class Tracer:
    """See the module docstring. ``on``: spans are recorded; ranges are
    timed while an anchor is held (enabled on a CUDA device)."""

    def __init__(self):
        self.on = False
        self.device = None
        self._anchor = None
        self._anchor_ns = 0
        self._captured = None
        self._free = []
        self.reset()

    # ------------------------------------------------------------ state
    def enable(self, device=None):
        """Record spans from now on, and with a CUDA ``device`` time the
        device ranges too (spans only otherwise)."""
        self.on = True
        self.device = torch.device(device) if device is not None else None
        self._anchor = None
        if self.device is not None and self.device.type == "cuda":
            self._take_anchor()

    def disable(self):
        """Record nothing more; what was recorded (pending ranges read
        first) stays for :meth:`snapshot` and :meth:`write`."""
        self._read_all()
        self.on = False
        self._anchor = None

    def reset(self):
        """Clear what was recorded (spans still open are dropped) and keep
        the state: on the card a new anchor is taken."""
        self.step = 0
        self.waits = 0
        self._spans = _Log()
        self._ranges = _Log()
        self._open = []
        self._pending = []
        self._tower = None
        if self._anchor is not None:
            self._take_anchor()

    def tower(self, name, layers, tokens_per_step):
        """Every step of the traced run runs the image tower ``name`` of
        ``layers`` blocks over ``tokens_per_step`` tokens (batch x
        sequence): :meth:`snapshot`'s ``tower``, until :meth:`reset`."""
        self._tower = {"name": name, "layers": layers,
                       "tokens_per_step": tokens_per_step}

    def _take_anchor(self):
        torch.cuda.synchronize(self.device)
        anchor = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter_ns()
        anchor.record(torch.cuda.current_stream(self.device))
        anchor.synchronize()
        self._anchor_ns = (t0 + time.perf_counter_ns()) // 2
        self._anchor = anchor

    # ---------------------------------------------------------- record
    def span(self, name):
        """A host span named ``name`` around the block."""
        if not self.on:
            return NULL
        return _Span(self, name)

    def device_range(self, name):
        """A device range named ``name`` around the device work the block
        enqueues on the current stream."""
        if self._anchor is None:
            return NULL
        return _Range(self, name)

    def next_step(self):
        """A new step begins: later spans and ranges belong to it; the
        ranges that completed are read."""
        self.step += 1
        if self._pending:
            self.resolve()

    def _event(self, kept):
        if kept:
            return torch.cuda.Event(enable_timing=True, external=True)
        return self._free.pop() if self._free else \
            torch.cuda.Event(enable_timing=True)

    @contextlib.contextmanager
    def capturing(self):
        """Around a CUDA graph's capture: yields the list of the device
        ranges recorded inside, which the graph keeps and passes to
        :meth:`replayed` after each replay (empty while ranges are
        off)."""
        kept = []
        if self._anchor is None:
            yield kept
            return
        self._captured = kept
        try:
            yield kept
        finally:
            self._captured = None

    def replayed(self, ranges):
        """A graph holding ``ranges`` was replayed: they are pending."""
        if self._anchor is not None:
            step = self.step
            self._pending.extend((step, r) for r in ranges)

    def resolve(self, force=()):
        """Read the pending ranges that have completed, and those of
        ``force`` (a graph's own, about to be recorded again) whether or
        not they have: those wait for the card."""
        if not self._pending:
            return
        forced = {id(r) for r in force}
        keep = []
        for step, r in self._pending:
            if not r.end.query():
                if id(r) not in forced:
                    keep.append((step, r))
                    continue
                self.waits += 1
                r.end.synchronize()
            start = self._anchor_ns + round(
                self._anchor.elapsed_time(r.begin) * 1e6)
            self._ranges.add((r.name, start, start + round(
                r.begin.elapsed_time(r.end) * 1e6), step))
            if not r.kept:
                self._free += (r.begin, r.end)
        self._pending = keep

    # ------------------------------------------------------------ read
    def _read_all(self):
        if self._pending:
            self.resolve(force=[r for _, r in self._pending])

    def gaps(self):
        """[(start, end, span name)] of the device's idle gaps between
        consecutive steps (ns on the host's clock)."""
        self._read_all()
        bounds = step_bounds(self._ranges)
        gaps = [(a[1], b[0]) for a, b in zip(bounds, bounds[1:])
                if b[0] > a[1]]
        return [(lo, hi, name) for (lo, hi), name in
                zip(gaps, attribute(gaps, list(self._spans)))]

    def snapshot(self):
        """What was recorded, summed up: ``spans`` and ``ranges`` by name
        ({count, steps, total_ms, mean_ms a record, per_step_ms}; a span's
        also ``self_ms``, its total less its children's), ``gaps``
        ({count: consecutive steps, total_ms, mean_ms, by_span: {name:
        ms}, within_ms: a step's device time inside its extent that no
        range covers}), ``tower`` (:meth:`tower`; None if not set) and
        ``counters`` (``steps`` with ranges, ``waits``)."""
        self._read_all()
        spans = [s for s in self._spans if s.end is not None]
        by_span = {}
        for s, own in zip(spans, self_times(spans)):
            d = by_span.setdefault(s.name, ([], [], []))
            d[0].append(s.end - s.start)
            d[1].append(s.step)
            d[2].append(own)
        by_range = {}
        for name, start, end, step in self._ranges:
            d = by_range.setdefault(name, ([], []))
            d[0].append(end - start)
            d[1].append(step)
        out = {"spans": {n: dict(_stats(durs, steps), self_ms=sum(own) / 1e6)
                         for n, (durs, steps, own) in by_span.items()},
               "ranges": {n: _stats(*d) for n, d in by_range.items()}}
        steps = len(step_bounds(self._ranges))
        gaps = self.gaps()
        total = sum(hi - lo for lo, hi, _ in gaps) / 1e6
        by_span = {}
        for lo, hi, name in gaps:
            by_span[name] = by_span.get(name, 0.0) + (hi - lo) / 1e6
        pairs = max(steps - 1, 0)
        out["gaps"] = {"count": pairs, "total_ms": total,
                       "mean_ms": total / pairs if pairs else 0.0,
                       "by_span": by_span,
                       "within_ms": uncovered(self._ranges) / 1e6
                       / max(steps, 1)}
        out["tower"] = self._tower
        out["counters"] = {"steps": steps, "waits": self.waits}
        return out

    def write(self, path):
        """One Chrome trace (JSON) of the spans (process "host"), the
        device ranges and the idle gaps (process "device") on the shared
        clock, in microseconds from the first record."""
        self._read_all()
        spans = [s for s in self._spans if s.end is not None]
        ranges = list(self._ranges)
        gaps = self.gaps()
        t0 = min([s.start for s in spans] + [r[1] for r in ranges] or [0])

        def event(name, pid, tid, start, end, **args):
            return {"name": name, "ph": "X", "pid": pid, "tid": tid,
                    "ts": (start - t0) / 1e3, "dur": (end - start) / 1e3,
                    "args": args}
        events = [{"name": "process_name", "ph": "M", "pid": pid,
                   "args": {"name": name}}
                  for pid, name in ((0, "host"), (1, "device"))]
        events += [event(s.name, 0, 0, s.start, s.end, step=s.step)
                   for s in spans]
        events += [event(n, 1, 0, a, b, step=k) for n, a, b, k in ranges]
        events += [event("idle", 1, 1, a, b, span=n) for a, b, n in gaps]
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


# the program's tracer, and its methods as the module's functions
TRACER = Tracer()
span = TRACER.span
device_range = TRACER.device_range
tower = TRACER.tower
next_step = TRACER.next_step
capturing = TRACER.capturing
replayed = TRACER.replayed
resolve = TRACER.resolve
enable = TRACER.enable
disable = TRACER.disable
reset = TRACER.reset
snapshot = TRACER.snapshot
write = TRACER.write


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (CPU and, where a card is present, CUDA
    activity) and write a Chrome trace, ``trace.json``, under ``logdir``.
    Yields the profiler. Spans of an enabled tracer show in it as
    ``hoigen.<name>`` ranges."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
