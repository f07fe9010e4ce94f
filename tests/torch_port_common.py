"""Setup that the port's tests share: the tiny configuration of the eval
step in both packages, and one set of weights for both.

The configuration is the main path's (gen_feat cache model, DINO on, the
fused-cache flag on, the uint8 production feed with the on-device CLIP
stream) at narrow widths and in float32. The JAX parameters are cast to
float32 (the tests run JAX with x64 enabled) and handed to the port
through the bridge.

The CUDA-graph tests' tools are in ``torch_graph_tools.py``, which
imports no JAX, so that the multi-process workers use them too.
"""
import jax
import jax.numpy as jnp
import numpy as np

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
