"""The CUDA-graph tests' tools, on the CPU: a recorder of the ops a
captured graph could not hold, and stand-ins for the ``torch.cuda`` calls
of ``engine/cuda_graph.py``, among them a graph that records the aten ops
of its capture and runs them again at each replay. It imports the port
and torch only, never JAX, so that the multi-process workers
(``_torch_parallel_worker.py``) use it too.
"""
import contextlib
import time
import traceback

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# ops that read a device value on the host, or whose output shape does
FORBIDDEN = {"aten.lift_fresh.default", "aten._local_scalar_dense.default",
             "aten.nonzero.default", "aten.masked_select.default",
             "aten._unique2.default", "aten.repeat_interleave.Tensor"}


class UnsafeOps(TorchDispatchMode):
    """Records (op, the innermost port frame) of every op a graph could
    not hold."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        bool_index = func.overloadpacket.__name__ in (
            "index", "index_put", "index_put_") and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool
            for i in (args[1] or ()))
        if name in FORBIDDEN or bool_index:
            sites = [f"{f.filename.split('hoigen_tpu_torch')[-1]}:{f.lineno}"
                     for f in traceback.extract_stack()
                     if "hoigen_tpu_torch" in f.filename]
            self.found.append((name, sites[-1] if sites else "?"))
        return func(*args, **(kwargs or {}))


class _Stream:
    def __init__(self, *args):
        pass

    def wait_stream(self, other):
        pass


# the graph being captured by a TapedCapture, whose tape an event
# recorded during the capture joins
_TAPING = []


class _Event:
    """Stand-in for ``torch.cuda.Event``: recording stamps the host clock
    (and, during a taped capture, joins the tape, so that each replay
    stamps it again); every event has completed."""

    def __init__(self, enable_timing=False, blocking=False,
                 interprocess=False, external=False):
        self.ns = None

    def stamp(self):
        self.ns = time.perf_counter_ns()

    def record(self, stream=None):
        self.stamp()
        if _TAPING:
            _TAPING[-1].tape.append((self.stamp, (), {}, None))

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.ns - self.ns) / 1e6


def stand_in_cuda(monkeypatch, graph, cuda_graph):
    """Replace the ``torch.cuda`` calls of ``engine/cuda_graph.py`` by
    stand-ins that run on the CPU: ``graph`` for ``torch.cuda.graph`` and
    ``cuda_graph`` for ``torch.cuda.CUDAGraph``; pinned memory is plain
    memory, and every leaf counts as on the card."""
    from hoigen_tpu_torch.engine import cuda_graph as cg
    empty = torch.empty
    for name, value in (
            ("graph", graph), ("CUDAGraph", cuda_graph),
            ("Stream", _Stream), ("Event", _Event),
            ("stream", lambda s: contextlib.nullcontext()),
            ("current_stream", lambda device=None: _Stream()),
            ("synchronize", lambda device=None: None),
            ("empty_cache", lambda: None),
            ("memory_reserved", lambda device=None: 0),
            ("graph_pool_handle", lambda: ("pool",))):
        monkeypatch.setattr(torch.cuda, name, value)
    monkeypatch.setattr(torch, "empty", lambda *a, pin_memory=False, **k:
                        empty(*a, **k))
    monkeypatch.setattr(cg, "on_card", lambda leaves: True)


class TapedGraph:
    """Stand-in for ``torch.cuda.CUDAGraph`` on the CPU, captured by
    :class:`TapedCapture`: the tape holds every aten op of the capture with
    the tensors it read and wrote, and a replay runs the tape again. An op
    that returns a new tensor writes its result into the tensor that the
    capture returned, as a CUDA graph rewrites its static memory in place;
    an in-place op writes its arguments again. Random ops draw from the
    generator they were captured with, at its state at the replay. A
    collective (a ``c10d`` op, which returns its ``Work``) is waited for
    before the next op reads its tensors, as a captured collective's
    stream is joined back. As on the card, a replay moves no tensor's
    version counter."""

    def __init__(self):
        self.tape = []
        self.generators = []
        self.touched = None

    def register_generator_state(self, generator):
        self.generators.append(generator)

    @torch.inference_mode()
    def replay(self):
        if self.touched is None:
            self.touched = list({id(t): t for op in self.tape
                                 for t in tree_flatten(op[1:])[0]
                                 if isinstance(t, torch.Tensor)}.values())
        touched = self.touched
        versions = [t._version for t in touched]
        for func, args, kwargs, outs in self.tape:
            res = tree_flatten(func(*args, **kwargs))[0]
            for work in res:
                if isinstance(work, torch.ScriptObject):
                    work.wait()
            if outs:
                new = [t for t in res if isinstance(t, torch.Tensor)]
                for o, r in zip(outs, new):
                    if o is not r:
                        o.copy_(r)
        torch._C._autograd._unsafe_set_version_counter(touched, versions)


class _Tape(TorchDispatchMode):
    def __init__(self, graph):
        super().__init__()
        self.graph = graph

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        aliased = any(r.alias_info is not None
                      for r in func._schema.returns)
        self.graph.tape.append((func, args, kwargs, None if aliased else [
            t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]))
        return out


class TapedCapture:
    """Stand-in for ``torch.cuda.graph``: records the ops run inside it
    onto a :class:`TapedGraph`, and then puts back the tensors of
    ``state()`` as they were, since a capture computes nothing. Every
    capture adds ``launches`` to each counter of ``counted``, as the
    kernel wrappers count the launches they record on the card."""

    def __init__(self, state, counted=(), launches=0):
        self.state = state
        self.counted = counted
        self.launches = launches
        self.captured = 0

    @contextlib.contextmanager
    def __call__(self, graph, pool=None, capture_error_mode=None):
        saved = [(t, t.detach().clone()) for t in self.state()]
        self.captured += 1
        for fn in self.counted:
            fn.launches += self.launches
        _TAPING.append(graph)
        try:
            with _Tape(graph):
                yield
        finally:
            _TAPING.pop()
        with torch.no_grad():
            for t, s in saved:
                if not torch.equal(t, s):
                    t.copy_(s)


@contextlib.contextmanager
def tracing(device=None):
    """The program's tracer on (``engine/profiling.py``; device ranges
    with a CUDA ``device``) from a clean state while the block runs, off
    and cleared after. Yields the module."""
    from hoigen_tpu_torch.engine import profiling
    profiling.reset()
    profiling.enable(device)
    try:
        yield profiling
    finally:
        profiling.disable()
        profiling.reset()


@pytest.fixture
def tracer():
    """:func:`tracing` around a test."""
    with tracing() as t:
        yield t
