"""Setup that the port's tests share: the tiny configuration of the eval
step in both packages, and one set of weights for both.

The configuration is the main path's (gen_feat cache model, DINO on, the
fused-cache flag on, the uint8 production feed with the on-device CLIP
stream) at narrow widths and in float32. The JAX parameters are cast to
float32 (the tests run JAX with x64 enabled) and handed to the port
through the bridge.

Also the CUDA-graph tests' tools: a recorder of the ops a captured graph
could not hold, and stand-ins for the ``torch.cuda`` calls of
``engine/cuda_graph.py``, among them a graph that records the aten ops of
its capture and runs them again at each replay.
"""
import contextlib
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from hoigen_tpu.engine import hoi_model as jhm
from hoigen_tpu.models.clip.config import CLIPConfig as JCLIPConfig
from hoigen_tpu.models.detr import DETRConfig as JDETRConfig
from hoigen_tpu.models.proposals import ProposalConfig as JProposalConfig
from hoigen_tpu.models.upt import UPTConfig as JUPTConfig

from hoigen_tpu_torch import bridge
from hoigen_tpu_torch.engine import hoi_model as thm
from hoigen_tpu_torch.models.clip.config import CLIPConfig as TCLIPConfig
from hoigen_tpu_torch.models.detr.config import DETRConfig as TDETRConfig
from hoigen_tpu_torch.models.proposals import ProposalConfig as \
    TProposalConfig
from hoigen_tpu_torch.models.upt import UPTConfig as TUPTConfig

CLIP_KW = dict(image_resolution=32, vision_layers=2, vision_width=64,
               vision_patch_size=8, adapter_layers=(0, 1))
# the JAX config also sizes a text tower, which the eval step does not run
TEXT_KW = dict(transformer_layers=2, transformer_width=64, context_length=16)
# 1 real detector class + no-object, as the JAX package's tiny dryrun: a
# random DETR gives every query the same label, and with one class that
# label is 'human', so human-human pairs form (the object slot group is
# covered by the proposal tests of test_torch_modules.py)
DETR_KW = dict(hidden_dim=64, nheads=2, enc_layers=2, dec_layers=2,
               dim_feedforward=128, num_queries=12, num_classes=2)
UPT_KW = dict(num_classes=24, num_shot=2, clip_resolution=32,
              use_dino=True, cache_model="gen_feat", use_pallas_cache=True)
DETR_HW = (64, 96)


def eval_configs(**upt_kw):
    """(JAX, port) HOIModelConfig of the tiny eval configuration;
    ``upt_kw`` overrides fields of ``UPT_KW``."""
    kw = dict(UPT_KW, **upt_kw)
    jcfg = jhm.HOIModelConfig(
        clip=JCLIPConfig(**CLIP_KW, **TEXT_KW), detr=JDETRConfig(**DETR_KW),
        upt=JUPTConfig(proposals=JProposalConfig(max_instances=4), **kw),
        dtype="float32")
    tcfg = thm.HOIModelConfig(
        clip=TCLIPConfig(**CLIP_KW), detr=TDETRConfig(**DETR_KW),
        upt=TUPTConfig(proposals=TProposalConfig(max_instances=4), **kw),
        dtype="float32")
    return jcfg, tcfg


def f32(tree):
    return jax.tree.map(
        lambda a: a.astype(jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def spread_bbox_head(frozen):
    """A random-init DETR emits near-identical boxes for every query, so
    NMS keeps one and no pairs form; spread the box head as the JAX
    package's tiny dryrun does."""
    last = frozen["detr"]["bbox_embed"][-1]
    frozen["detr"]["bbox_embed"][-1] = {
        "w": last["w"] * 6.0,
        "b": last["b"] + jnp.asarray(
            np.random.default_rng(0).normal(0, 1.0, last["b"].shape),
            last["b"].dtype)}
    return frozen


def as_np(tree):
    return jax.tree.map(np.asarray, tree)


def eval_models(jcfg, caches, key=0):
    """The tiny eval model's random JAX weights (float32, box head spread)
    and the same weights in the port on the CPU: ((trainable, frozen,
    buffers), (params, buffers))."""
    trainable, frozen, buffers = jhm.init_hoi_model(
        jax.random.PRNGKey(key), jcfg, caches)
    jax_model = (f32(trainable), spread_bbox_head(f32(frozen)),
                 f32(buffers))
    port_model = bridge.params_from_jax(*map(as_np, jax_model),
                                        device="cpu")
    return jax_model, port_model


# ------------------------------------------------------ CUDA-graph tools
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


class _Event:
    def record(self):
        pass

    def synchronize(self):
        pass


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
    generator they were captured with, at its state at the replay. As on
    the card, a replay moves no tensor's version counter."""

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
            res = func(*args, **kwargs)
            if outs:
                new = [t for t in tree_flatten(res)[0]
                       if isinstance(t, torch.Tensor)]
                for o, r in zip(outs, new):
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
        with _Tape(graph):
            yield
        with torch.no_grad():
            for t, s in saved:
                if not torch.equal(t, s):
                    t.copy_(s)
