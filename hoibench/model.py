"""A configuration's model, built through the port's own path: the CLI's
flags through ``utils/config.py::parse_config`` and
``cli/main_finetune.py::make_model_config``, the weights handed to
``engine/hoi_model.py::init_hoi_model`` as the CLI hands it converted
checkpoints.

The benchmark makes the inputs both sides take: the CLIP, DETR and DINO
weights (drawn on the device from ``--seed`` by the reference's own init
functions, the DETR heads spread so that the random detector scores human
pairs) and the caches (``traffic.make_caches``). The port derives the rest
(the UPT head's leaves and buffers) in ``init_hoi_model``; the reference
derives them again with its own copy.
"""
import dataclasses

import numpy as np
import torch

from .reference.engine import hoi_model as ref_hm
from .reference.models.clip import config as ref_clip_config
from .reference.models.clip.model import init_clip_params
from .reference.models.detr import config as ref_detr_config
from .reference.models.detr.model import init_detr_params
from .reference.models.dino import init_dino_params
from .reference.models import proposals as ref_proposals
from .reference.models import upt as ref_upt
from . import traffic as T

# the streams of --seed: one per kind of input, so that each is the same
# whatever else a run draws
TOWER_STREAM, HEAD_STREAM, DROPOUT_STREAM = 11, 13, 17


def sub_seed(seed, stream):
    """A 63-bit seed of ``stream`` under ``seed`` (any whole number)."""
    return int(np.random.default_rng([seed % (1 << 63), stream])
               .integers(0, 1 << 62))


def run_config(config, traffic):
    """The port's ``RunConfig`` from the configuration's CLI flags, with
    ``--eval true`` for an evaluation mix."""
    from hoigen_tpu_torch.utils.config import parse_config
    flags = list(config["flags"])
    if traffic["mode"] == "eval":
        flags += ["--eval", "true"]
    return parse_config(flags)


def model_config(config, rc, device, shrink=None):
    """The port's ``HOIModelConfig`` (``make_model_config``), its widths
    held to the configuration's (:func:`check_widths`); ``shrink`` then
    maps it to a smaller one (the CPU tests only)."""
    from hoigen_tpu_torch.cli.main_finetune import make_model_config
    cfg = make_model_config(rc, device)
    check_widths(config, cfg)
    return shrink(cfg) if shrink is not None else cfg


class WidthsMismatch(ValueError):
    """A configuration's ``widths`` describe another model than the one
    the port builds from its flags."""


def port_widths(cfg):
    """{``widths`` key: [(where in the port's ``HOIModelConfig``, value)]}
    of the model the port builds. A key with two places is held to both:
    the CLIP tower's resolution and embedding width are read again by the
    UPT head, and the two have to agree with the file. ``dino_backbone``
    has no counterpart: the port builds one DINO, a ResNet-50, and the
    key stays as documentation."""
    clip, detr, upt = cfg.clip, cfg.detr, cfg.upt
    adapters = (len(set(clip.adapter_layers) & set(range(clip.vision_layers)))
                if clip.use_adapter else 0)
    return {
        "clip_vision_width": [("clip.vision_width", clip.vision_width)],
        "clip_vision_layers": [("clip.vision_layers", clip.vision_layers)],
        "clip_patch": [("clip.vision_patch_size", clip.vision_patch_size)],
        "clip_resolution": [("clip.image_resolution", clip.image_resolution),
                            ("upt.clip_resolution", upt.clip_resolution)],
        "clip_embed_dim": [("clip.embed_dim", clip.embed_dim),
                           ("upt.visual_output_dim", upt.visual_output_dim)],
        "adapter_layers": [("clip.adapter_layers (blocks with an adapter)",
                            adapters)],
        "adapter_bottleneck": [("clip.adapter_bottleneck",
                                clip.adapter_bottleneck)],
        "detr_hidden_dim": [("detr.hidden_dim", detr.hidden_dim)],
        "detr_enc_layers": [("detr.enc_layers", detr.enc_layers)],
        "detr_dec_layers": [("detr.dec_layers", detr.dec_layers)],
        "detr_queries": [("detr.num_queries", detr.num_queries)],
        "detr_classes": [("detr.num_classes", detr.num_classes)],
        "num_classes": [("upt.num_classes", upt.num_classes)],
        "num_shot": [("upt.num_shot", upt.num_shot)],
    }


def check_widths(config, cfg):
    """Hold every key of the configuration's ``widths`` to the port's
    ``cfg`` as ``make_model_config`` returns it: the readers count FLOPs
    and roofline shapes, and ``traffic.make_caches`` sizes the caches,
    from ``widths`` alone. Raises :class:`WidthsMismatch` naming each key
    that differs, or that the file lacks or the port has no place for,
    with the file's value and the port's."""
    widths = config["widths"]
    port = port_widths(cfg)
    wrong = []
    for key in list(widths) + [k for k in port if k not in widths]:
        if key == "dino_backbone":
            continue        # no counterpart: the port's DINO is a ResNet-50
        if key not in port:
            wrong.append(f"{key}: {widths[key]!r} in the file, no "
                         f"counterpart in the port's model")
        elif key not in widths:
            wrong.append(f"{key}: missing from the file, the port builds "
                         + ", ".join(f"{w} {v!r}" for w, v in port[key]))
        else:
            wrong += [f"{key}: {widths[key]!r} in the file, the port "
                      f"builds {where} {got!r}"
                      for where, got in port[key] if got != widths[key]]
    if wrong:
        raise WidthsMismatch(
            f"configuration {config.get('name')!r}: its widths are not the "
            f"model the port builds from its flags: " + "; ".join(wrong))


def reference_config(cfg):
    """The reference's configuration objects with the port's settings."""
    d = dataclasses.asdict(cfg)
    upt = dict(d["upt"])
    upt["proposals"] = ref_proposals.ProposalConfig(**upt["proposals"])
    clip = dict(d["clip"])
    clip["adapter_layers"] = tuple(clip["adapter_layers"])
    detr = dict(d["detr"])
    detr["fused_resnet_tail"] = tuple(detr["fused_resnet_tail"])
    return ref_hm.HOIModelConfig(
        clip=ref_clip_config.CLIPConfig(**clip),
        detr=ref_detr_config.DETRConfig(**detr),
        upt=ref_upt.UPTConfig(**upt), dtype=d["dtype"])


def spread_detection_heads(detr, seed, spread, human_logit):
    """A random DETR's queries attend nearly uniformly and differ by under
    1% after the decoder, so every query gets nearly the same box, NMS
    keeps one and no pair forms. Sharpen the queries' attention (their
    embeddings and the decoder's cross-attention query projections scaled
    by ``query_scale`` and ``cross_query_scale``), spread the box head's
    last layer by ``box_scale`` (with noise on its bias, as
    ``chip_smoke.py`` does) and shift its width and height logits by
    ``box_size_bias`` (small boxes, which NMS keeps apart), and favour the
    human logit by ``human_bias``,
    so that the detector finds distinct boxes and the head scores human
    pairs on every seed."""
    last = detr["bbox_embed"][-1]
    noise = np.random.default_rng([seed, 5]).normal(0, 1.0, last["b"].shape)
    last["w"].mul_(spread["box_scale"])
    last["b"].add_(torch.as_tensor(noise, dtype=last["b"].dtype,
                                   device=last["b"].device))
    last["b"][2:].add_(spread["box_size_bias"])
    detr["class_embed"]["b"][human_logit] += spread["human_bias"]
    detr["query_embed"].mul_(spread["query_scale"])
    for layer in detr["decoder"]:
        w = layer["cross_attn"]["w_qkv"]
        w[:w.shape[0] // 3].mul_(spread["cross_query_scale"])


@torch.no_grad()
def tower_weights(seed, cfg, config, device):
    """CLIP (vision tower and adapters), DETR and DINO weights from
    ``seed``, drawn on ``device`` by a generator there (the reference's
    init functions run with the device as torch's default). ``cfg``: the
    reference's configuration."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(
        sub_seed(seed, TOWER_STREAM))
    with dev:
        clip = init_clip_params(gen, cfg.clip)
        detr = init_detr_params(gen, cfg.detr)
        dino = init_dino_params(gen) if cfg.upt.use_dino else None
    spread_detection_heads(detr, seed, config["detr_spread"],
                           config["detr_human_logit"])
    return clip, detr, dino


def caches_of(seed, config, cfg, caches_class):
    """The configuration's caches drawn from ``seed``, as ``caches_class``
    (the port's or the reference's ``UPTCaches`` shape)."""
    return caches_class(**T.make_caches(seed, config, cfg.upt.num_classes,
                                        cfg.upt.num_shot))


class Caches:
    """The caches' arrays as attributes, as ``init_upt_params`` (the
    reference's) and ``traffic.generated_pairs`` read them."""

    def __init__(self, **arrays):
        self.one_hots_h = self.one_hots_o = self.one_hots_u = None
        self.one_hots_ho = None
        self.__dict__.update(arrays)


def build_program(seed, config, traffic, device, shrink=None):
    """(run config, model config, params, buffers) of the port, on
    ``device``."""
    from hoigen_tpu_torch.engine.hoi_model import init_hoi_model
    from hoigen_tpu_torch.models.cache import UPTCaches
    rc = run_config(config, traffic)
    cfg = model_config(config, rc, device, shrink)
    clip, detr, dino = tower_weights(seed, reference_config(cfg), config,
                                     device)
    params, buffers = init_hoi_model(
        torch.Generator().manual_seed(sub_seed(seed, HEAD_STREAM)), cfg,
        caches_of(seed, config, cfg, UPTCaches), clip_params=clip,
        detr_params=detr, dino_params=dino, device=device)
    return rc, cfg, params, buffers


def build_reference(seed, config, cfg, device):
    """(reference config, params, buffers): the same inputs, the head and
    buffers derived by the reference's own init."""
    rcfg = reference_config(cfg)
    clip, detr, dino = tower_weights(seed, rcfg, config, device)
    params, buffers = ref_hm.init_hoi_model(
        torch.Generator().manual_seed(sub_seed(seed, HEAD_STREAM)), rcfg,
        caches_of(seed, config, cfg, Caches), clip_params=clip,
        detr_params=detr, dino_params=dino, device=device)
    return rcfg, params, buffers


def dropout_seed(seed):
    """The seed the training loop hands ``Trainer.run_epoch``, which draws
    each step's dropout from (it, iteration, data rank)."""
    return sub_seed(seed, DROPOUT_STREAM) % (1 << 40)


def step_generator_seed(run_seed, iteration, data_rank=0):
    """``Trainer.run_epoch``'s dropout seed of one step."""
    return run_seed * 1_000_003 + iteration + (data_rank << 40)


def pixel_maker(device):
    """uint8 pixels (B, 3, H, W) drawn on ``device`` from a seed, returned
    as a numpy array on the host."""
    def make(seed, shape):
        gen = torch.Generator(device=device).manual_seed(seed)
        return torch.randint(0, 256, shape, generator=gen, device=device,
                             dtype=torch.uint8).cpu().numpy()
    return make
