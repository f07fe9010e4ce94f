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
capture, replay, recapture and launch-count bookkeeping.
"""
import contextlib
import dataclasses

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

from torch_graph_tools import UnsafeOps, stand_in_cuda
from torch_port_common import DETR_HW, DETR_KW, eval_configs

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
    for feed in (batch, {k: v.numpy() for k, v in batch.items()}):
        got = gstep(params, buffers, feed)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert gstep.graphs == {} and gstep.checks == 0


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


def test_capture_replay_and_recapture_bookkeeping(monkeypatch):
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
    assert g.deltas == [0, 0, 0, 3]
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
    assert gstep.checks == 5
