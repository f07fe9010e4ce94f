"""The eval and training steps as one captured CUDA graph per batch
signature: the port's counterparts of ``jax.jit(make_eval_step(cfg))`` and
of ``jax.jit(train_step, donate_argnums=(0, 1))``. This docstring tells the
eval step's story; :class:`GraphedTrainStep` adds the training step's.

``jax.jit`` compiles the step into one XLA program per batch shape and
launches it with one call. :func:`graphed` does the same on the card: at
the first call of a batch signature (its keys, shapes and dtypes) it runs
the eager step once on a side stream, which does every first-call piece of
work (building the kernels, their one-time attributes, the kernel-ready
weight copies of ``ops/_weights.py``, cuBLAS's handle and workspace), then
captures the step (which runs itself under ``full_f32()`` and inference
mode) into a CUDA graph and returns the eager run's outputs. Every later
call of that signature copies the batch into the graph's static input
buffers and replays the graph: one ``cudaGraphLaunch`` in place of the
step's few thousand launches.

What ``jax.jit`` gives for free, the wrapper keeps by hand:

- Current weights. A jitted step takes the parameters as arguments at
  every call. A graph reads the addresses it was captured with, and the
  kernel-ready copies made at capture. So every call checks the identity
  and version counter of each tensor leaf of ``params`` and ``buffers``
  and captures again where any changed (an in-place write, a replaced
  tensor). The graph holds the leaves and their cached copies, so that no
  memory it reads is handed out again while it lives. A storage swapped
  under a tensor (``t.data = ...``) bumps no version and is not seen, as
  ``ops/_weights.py::prepared`` does not see it; nothing in the package
  does that.
- Fresh outputs. A replay rewrites the graph's static outputs; each call
  returns copies of them, as a jitted step returns new arrays.
- True launch counts. The kernel wrappers count launches in Python, which
  a replay does not run: the counts a capture adds are taken back, and
  added again at every replay.

A capture or a replay that fails raises; nothing falls back to the eager
step on the card. On the CPU (tensor leaves on the CPU, as in the tests)
the wrapper calls the eager step unchanged.

A training step over a mesh of NCCL groups holds its collectives inside
its graph, as the jitted SPMD step holds its psums. A replay then assumes
what every rank of that step does: each rank replays the same graph at
the same call (the same batch signature, the same weight changes), or
its peers wait in their collectives. NCCL's graph mixing
(``NCCL_GRAPH_MIXING_SUPPORT``, on by default) lets one rank's eager
warm-up pair with a peer's replay of the same collective sequence; it
stays on.

Tracing (``engine/profiling.py``): each call is a step, with the host
spans ``graph.check`` (the leaf walk, the signature and the freshness
check, and after a training replay the versions' bump), ``graph.stage``
(its children ``graph.stage_wait`` for the staging's previous copy and
``graph.stage_copy`` for the copies into pinned memory and the
enqueues), ``graph.replay`` (the launch and the outputs' copies) and
``graph.capture`` (``graph.warmup``, ``graph.record``), and the device
range ``stage`` around the inputs' copies to the card. The tracer's state
is read at capture: a graph captured while device ranges are timed keeps
the ranges its step records (``engine/hoi_model.py``, ``models/upt.py``)
as event nodes and times them at every replay; a graph captured with
tracing off holds none, and stays so until it is captured again.
"""
import concurrent.futures
import operator
import os
import threading
import time

import numpy as np
import torch

from ..ops import _weights
from ..ops.attention import attention_bwd, fused_attention
from ..ops.conv_epilogue import conv_epilogue
from ..ops.fused_resnet import fused_bottleneck_chain
from ..ops.pallas_cache import fused_cache_logits
from . import profiling

# the kernel wrappers whose ``launches`` counters a replay keeps true
COUNTED = (fused_attention, attention_bwd, fused_bottleneck_chain,
           fused_cache_logits, conv_epilogue)

# a C-contiguous host input of this many bytes or more (and two rows or
# more) is staged through the pipeline of ``_Graph.load``: a batch of
# images at the training and eval buckets (102 to 173 MB at batch 32, 43 MB
# a rank's batch of 8), not one image (2.7 MB) or the small inputs
PIPE_BYTES = 8 << 20
# the pipeline's chunk: whole rows, about this many bytes (one image row
# of 3.2 or 5.4 MB at the 800 x 1344 and 1344 x 1344 buckets)
CHUNK_BYTES = 4 << 20
# the most threads of the staging pool: on an NVIDIA H100 host of 8 CPUs a
# batch of 32 at 1344 x 1344 lands on the card soonest with 8 (10.3 ms on
# the host, 12.0 until landed, against 22.6 and 25.9 for the whole copy on
# one thread; 12 and 16 threads land later: tools/sweep_staging.py)
POOL_CAP = 8

_pool = None
_pool_lock = threading.Lock()


def staging_pool():
    """The process's pool of staging threads, made at its first use: one a
    CPU the process may run on, at most ``POOL_CAP``. Its copies
    (``np.copyto``) run without the interpreter lock."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = concurrent.futures.ThreadPoolExecutor(
                min(POOL_CAP, len(os.sched_getaffinity(0))),
                thread_name_prefix="hoigen-stage")
        return _pool


def piped(v):
    """Whether the host input ``v`` takes the staging pipeline: a
    C-contiguous numpy array or CPU tensor of two rows or more and
    ``PIPE_BYTES`` or more."""
    if isinstance(v, np.ndarray):
        dense = v.flags.c_contiguous
    elif isinstance(v, torch.Tensor):
        dense = not v.is_cuda and v.is_contiguous()
    else:
        return False
    return dense and v.ndim >= 1 and v.shape[0] >= 2 and \
        v.nbytes >= PIPE_BYTES


def chunk_plan(rows, nbytes):
    """The row ranges ``(start, stop)``, in order, in which the pipeline
    copies an input of ``rows`` rows and ``nbytes`` bytes: whole rows of
    about ``CHUNK_BYTES`` together, one row at least."""
    per = max(1, CHUNK_BYTES * rows // max(nbytes, 1))
    return [(a, min(a + per, rows)) for a in range(0, rows, per)]


def byte_rows(x):
    """A C-contiguous numpy array or CPU tensor as a numpy view of its
    bytes, one row a leading index."""
    if isinstance(x, torch.Tensor):
        return x.detach().reshape(len(x), -1).view(torch.uint8).numpy()
    return x.reshape(len(x), -1).view(np.uint8)


def signature(batch):
    """The key of a batch's graph: its keys with their shapes and dtypes.
    A numpy array and a tensor of one shape and dtype give one key."""
    return tuple(sorted((k, tuple(v.shape),
                         str(v.dtype).removeprefix("torch."))
                        for k, v in batch.items()))


def signature_text(key):
    """A signature as one line of text."""
    return ", ".join(f"{k} {list(s)} {d}" for k, s, d in key)


def tensor_leaves(tree, out=None):
    """The tensors of a nested dict/list/tuple, in a fixed order (run at
    every call: kept to one loop a container)."""
    out = [] if out is None else out
    for v in (tree.values() if isinstance(tree, dict) else tree):
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (dict, list, tuple)):
            tensor_leaves(v, out)
    return out


def unchanged(leaves, captured, versions):
    """Whether ``leaves`` are the ``captured`` tensors, none written in
    place since their version counters read ``versions``."""
    return (len(leaves) == len(captured)
            and all(map(operator.is_, leaves, captured))
            and [t._version for t in leaves] == versions)


def on_card(leaves):
    """Whether the step's weights are on the card (else it runs eagerly)."""
    return bool(leaves) and leaves[0].is_cuda


class _Graph:
    """The graph of one batch signature: its static inputs (with pinned
    staging for the inputs that arrive on the host), its static outputs,
    the leaves it was captured against, the device ranges it times, and
    what its captures cost (``warmup_s``, ``capture_s``: sums over every
    capture)."""

    def __init__(self, batch, device):
        self.device = device
        self.static_in = {k: torch.empty_like(torch.as_tensor(v),
                                              device=device)
                          for k, v in batch.items()}
        self.staging = {}
        self.copied = torch.cuda.Event()
        self.graph = self.static_out = None
        # a training graph's own dropout generator (None: no dropout)
        self.generator = None
        self.leaves, self.versions, self.held = [], [], []
        self.ranges = []
        self.deltas = [0] * len(COUNTED)
        self.captures = self.replays = 0
        self.loads = self.piped_loads = self.piped_chunks = 0
        self.warmup_s = self.capture_s = 0.0
        self.pool_bytes = 0

    def load(self, batch):
        """Copy ``batch`` into the static inputs on the current stream:
        host arrays through pinned staging, without waiting for the card
        beyond the staging's previous copy. A host input that is
        :func:`piped` is copied into its pinned buffer in row chunks
        (:func:`chunk_plan`) by the :func:`staging_pool`, and each chunk's
        copy to the card is enqueued as soon as it lands, in order, so
        that the card copies while the host still does; every other input
        is copied whole on the calling thread meanwhile, and its copy
        enqueued first. The device range ``stage`` spans the copies to
        the card."""
        with profiling.span("graph.stage"):
            with profiling.span("graph.stage_wait"):
                self.copied.synchronize()
            with profiling.span("graph.stage_copy"):
                chunks = []
                try:
                    whole = self._pin(batch, chunks)
                    with profiling.device_range("stage"):
                        for k, src in whole.items():
                            self.static_in[k].copy_(src, non_blocking=True)
                        for k, a, b, landed in chunks:
                            landed.result()
                            self.static_in[k][a:b].copy_(
                                self.staging[k][a:b], non_blocking=True)
                finally:
                    # no pool thread writes a buffer past this call
                    concurrent.futures.wait([c[3] for c in chunks])
                self.loads += 1
                if chunks:
                    self.piped_loads += 1
                    self.piped_chunks += len(chunks)
                self.copied.record()

    def _pin(self, batch, chunks):
        """Start the copies of ``batch``'s host inputs into their pinned
        buffers: a piped input's chunks on the pool, each appended to
        ``chunks`` as ``(key, start, stop, future)``; the others whole,
        here. -> {key: the source of its whole copy to the card}."""
        whole = {}
        for k, v in batch.items():
            if isinstance(v, torch.Tensor) and v.is_cuda:
                whole[k] = v
                continue
            stage = self.staging.get(k)
            if stage is None:
                dst = self.static_in[k]
                stage = self.staging[k] = torch.empty(
                    dst.shape, dtype=dst.dtype, pin_memory=True)
            if piped(v):
                src, pinned = byte_rows(v), byte_rows(stage)
                pool = staging_pool()
                chunks += [(k, a, b, pool.submit(np.copyto, pinned[a:b],
                                                 src[a:b]))
                           for a, b in chunk_plan(len(src), src.nbytes)]
                continue
            if isinstance(v, torch.Tensor):
                stage.copy_(v)
            else:
                np.copyto(stage.numpy(), v)
            whole[k] = stage
        return whole

    def capture(self, warmup, record, pool=None, generator=None):
        """Run ``warmup()`` eagerly on a side stream, then capture
        ``record()`` (into ``pool`` where given, drawing from
        ``generator`` where given). -> the warm-up's outputs."""
        with profiling.span("graph.capture"):
            return self._capture(warmup, record, pool, generator)

    def _capture(self, warmup, record, pool, generator):
        torch.cuda.synchronize(self.device)
        # the previous capture (if any) read leaves that changed since
        self.graph = self.static_out = None
        self.held, self.ranges = [], []
        with profiling.span("graph.warmup"):
            t0 = time.perf_counter()
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                out = warmup()
            torch.cuda.current_stream(self.device).wait_stream(side)
            torch.cuda.synchronize(self.device)
            self.warmup_s += time.perf_counter() - t0

        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        counts = [fn.launches for fn in COUNTED]
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        with profiling.span("graph.record"), \
                profiling.capturing() as ranges:
            t0 = time.perf_counter()
            with torch.cuda.graph(graph, pool=pool,
                                  capture_error_mode="thread_local"):
                static_out = record()
            torch.cuda.synchronize(self.device)
            self.capture_s += time.perf_counter() - t0
        self.ranges = ranges
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        # nothing ran at capture: its counts come back with each replay
        self.deltas = [fn.launches - n for fn, n in zip(COUNTED, counts)]
        for fn, n in zip(COUNTED, counts):
            fn.launches = n
        self.graph, self.static_out = graph, static_out
        self.captures += 1
        return out

    def hold(self, leaves):
        """Keep ``leaves`` (and their cached copies) as the tensors the
        graph was captured against, with their versions now."""
        self.leaves = leaves
        self.versions = [t._version for t in leaves]
        self.held = _weights.copies_of(leaves)

    def replay(self, mode=torch.inference_mode):
        """Replay on the current stream. -> copies of the outputs, made
        under ``mode``. The ranges of its previous replay are read
        first."""
        profiling.resolve(self.ranges)
        with profiling.span("graph.replay"):
            self.graph.replay()
            profiling.replayed(self.ranges)
            for fn, n in zip(COUNTED, self.deltas):
                fn.launches += n
            self.replays += 1
            with mode():
                return {k: v.clone() for k, v in self.static_out.items()}

    def record(self):
        """The graph's counters, always kept: its captures and replays,
        its loads, the loads that piped an input (:meth:`load`) and their
        chunks a load, the warm-ups' and captures' host seconds over every
        capture, the memory its last capture took from the pool and the
        counted kernels' launches a replay."""
        return {"captures": self.captures, "replays": self.replays,
                "loads": self.loads, "piped_loads": self.piped_loads,
                "chunks_per_piped_load":
                    self.piped_chunks / max(self.piped_loads, 1),
                "warmup_s": self.warmup_s, "capture_s": self.capture_s,
                "pool_bytes": self.pool_bytes,
                "launches_per_replay": {
                    fn.__name__: n for fn, n in zip(COUNTED, self.deltas)}}


class GraphedStep:
    """``step(params, buffers, batch)`` captured per batch signature on
    the card, eager on the CPU (see the module docstring). Each call is a
    step of the tracer."""

    def __init__(self, step):
        self.step = step
        self.graphs = {}

    def __call__(self, params, buffers, batch):
        profiling.next_step()
        with profiling.span("graph.check"):
            leaves = tensor_leaves((params, buffers))
            card = on_card(leaves)
            if card:
                key = signature(batch)
                g = self.graphs.get(key)
                fresh = g is not None and g.graph is not None and \
                    unchanged(leaves, g.leaves, g.versions)
        if not card:
            return self.step(params, buffers, batch)
        if g is None:
            g = self.graphs[key] = _Graph(batch, leaves[0].device)
        g.load(batch)
        if not fresh:
            def run():
                return self.step(params, buffers, g.static_in)
            out = g.capture(run, run)
            g.hold(leaves)
            return out
        return g.replay()

    def records(self):
        """{signature as text: that graph's record}."""
        return {signature_text(key): g.record()
                for key, g in self.graphs.items()}


def graphed(step):
    """``step`` (from ``make_eval_step``) captured once per batch
    signature and replayed: see the module docstring."""
    return GraphedStep(step)


class GraphedTrainStep:
    """``step(params, buffers, batch, generator=None)`` (from
    ``make_train_step``, updating through ``optimizer``) captured per
    batch signature and dropout on or off on the card, eager on the CPU:
    the counterpart of ``jax.jit(train_step, donate_argnums=(0, 1))``.

    The first call of a key runs the real step eagerly on a side stream
    (it makes the gradients, the kernels' attributes and the cached weight
    copies) and returns its metrics; the capture that follows records
    ``zero_grad``, the forward, the backward, the clip and the update, and
    changes no tensor. All keys' graphs share one memory pool: they replay
    one at a time, and each call copies its metrics out. Beyond what
    :class:`GraphedStep` keeps by hand:

    - The optimizer's tensors. The moments, the count, the gradients and
      the leaves it updates are checked with the parameters and buffers
      (``GroupedAdamW.load_state_dict`` writes them in place: a new
      capture), and a replay, which writes them on the card without
      moving any version counter, bumps their versions after it, so that
      ``ops/_weights.py::prepared`` and an eval graph see the update.
    - Dropout. Each graph draws from a generator of its own, registered
      with it at capture; before each replay it takes the caller's
      generator's seed and offset, and the caller's generator then moves
      on as the eager step would move it. A step without a generator runs
      no dropout, another program, so it is another key.

    A step over a mesh (``make_train_step(..., mesh=...)``) is captured
    with its collectives inside where they are NCCL (``parallel/
    distributed.py::capturable``; ``engine/train.py::Trainer`` keeps a
    gloo mesh's step eager, and a gloo collective of a CUDA tensor raises
    inside a capture): the warm-up runs every collective of the step,
    which creates each group's NCCL communicator (a subgroup's is made at
    its first collective) before the capture, and the capture records
    them as device work on NCCL's stream (what a replay assumes: the
    module docstring).

    Each call is a step of the tracer; its ``graph.check`` span is the
    weight check before the call and the versions' bump after a
    replay."""

    def __init__(self, step, optimizer):
        self.step = step
        self.optimizer = optimizer
        self.graphs = {}
        self.pool = None

    def _written(self):
        return tensor_leaves(self.optimizer.state_tensors())

    def __call__(self, params, buffers, batch, generator=None):
        profiling.next_step()
        with profiling.span("graph.check"):
            leaves = tensor_leaves((params, buffers))
            card = on_card(leaves)
            if card:
                leaves += self._written()
                key = (signature(batch), generator is not None)
                g = self.graphs.get(key)
                fresh = g is not None and g.graph is not None and \
                    unchanged(leaves, g.leaves, g.versions)
        if not card:
            return self.step(params, buffers, batch, generator)
        if g is None:
            g = self.graphs[key] = _Graph(batch, leaves[0].device)
            if generator is not None:
                g.generator = torch.Generator(device=g.device)
        g.load(batch)
        if not fresh:
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            out = g.capture(
                lambda: self.step(params, buffers, g.static_in, generator),
                lambda: self.step(params, buffers, g.static_in, g.generator),
                pool=self.pool, generator=g.generator)
            # the warm-up made the gradients: the leaves as they are now
            g.hold(tensor_leaves((params, buffers)) + self._written())
            return out
        if generator is not None:
            g.generator.set_state(generator.get_state())
        out = g.replay(torch.no_grad)
        with profiling.span("graph.check"):
            if generator is not None:
                generator.set_state(g.generator.get_state())
            torch.autograd.graph.increment_version(self._written())
            g.versions = [t._version for t in g.leaves]
        return out

    def records(self):
        """{signature as text, with or without dropout: that graph's
        record}."""
        return {signature_text(key) + (", dropout" if drop else ""):
                g.record() for (key, drop), g in self.graphs.items()}

