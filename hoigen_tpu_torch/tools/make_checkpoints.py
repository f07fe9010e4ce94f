"""Random checkpoint files under the reference's key names, from a seed: a
CLIP state dict (OpenAI's keys, the text tower included; a ViT with,
optionally, the reference model's instance adapters, or a ModifiedResNet
such as :data:`RN50`), a DETR checkpoint (``{"model":
state dict}``, facebookresearch/detr's keys), a DINO checkpoint
(``{"teacher": state dict}``, torchvision ResNet-50 keys under
``backbone.``) and a pair-embedding pickle for a dataset's images.

What ``cli/main_finetune.py::load_pretrained`` and ``build_caches`` read
when no trained weights are at hand: the converters and the CLI run on
them as on the real files. The weights are random with sane scales
(He-normal convolutions, near-identity BatchNorm statistics,
1/sqrt(fan_in) linear layers); ``detr_state_dict(spread=...)`` spreads the
box head and favours the human class, so that a random DETR finds
human-object pairs. Used by ``chip_smoke.py`` (phase 8) and the port's
tests::

    paths = write_checkpoints(out_dir, clip_cfg, detr_cfg, seed=0,
                              image_names=[...])
"""
import os
import pickle

import numpy as np
import torch

from ..labels import HICO
from ..models.clip.config import CLIPConfig
from ..models.detr.config import DETRConfig
from ..models.detr.resnet import LAYER_BLOCKS

FEATURE_DIM = 512
# OpenAI's RN50: ModifiedResNet (3, 4, 6, 3) of width 64 at 224 pixels, a
# 1024-wide attention pool output, the 512-wide text tower
RN50 = CLIPConfig(embed_dim=1024, image_resolution=224, vision_layers=16,
                  vision_width=64, vision_patch_size=32,
                  rn_layers=(3, 4, 6, 3), use_adapter=False,
                  adapter_layers=())


def _normal(gen, shape, std):
    return torch.randn(shape, generator=gen) * std


def _linear(gen, sd, key, out_d, in_d, bias=True):
    sd[key + ".weight"] = _normal(gen, (out_d, in_d), in_d ** -0.5)
    if bias:
        sd[key + ".bias"] = _normal(gen, (out_d,), 0.02)


def _ln(gen, sd, key, dim):
    sd[key + ".weight"] = 1.0 + _normal(gen, (dim,), 0.05)
    sd[key + ".bias"] = _normal(gen, (dim,), 0.02)


def _mha(gen, sd, key, dim):
    sd[key + ".in_proj_weight"] = _normal(gen, (3 * dim, dim), dim ** -0.5)
    sd[key + ".in_proj_bias"] = _normal(gen, (3 * dim,), 0.02)
    _linear(gen, sd, key + ".out_proj", dim, dim)


def _clip_block(gen, sd, key, width):
    _ln(gen, sd, key + ".ln_1", width)
    _ln(gen, sd, key + ".ln_2", width)
    _mha(gen, sd, key + ".attn", width)
    _linear(gen, sd, key + ".mlp.c_fc", 4 * width, width)
    _linear(gen, sd, key + ".mlp.c_proj", width, 4 * width)


def _adapter(gen, sd, key, cfg: CLIPConfig):
    bn = cfg.adapter_bottleneck
    _linear(gen, sd, key + ".down_proj", bn, cfg.vision_width)
    _linear(gen, sd, key + ".up_proj", cfg.vision_width, bn)
    sd[key + ".scale"] = _normal(gen, (cfg.vision_width,), 0.1)
    for m in range(cfg.adapter_num_layers):
        p = f"{key}.mhsa_layers.{m}"
        _mha(gen, sd, p + ".multihead_attn", bn)
        for n in (1, 2, 3):
            _ln(gen, sd, f"{p}.norm{n}", bn)
        _linear(gen, sd, p + ".linear1", 2 * bn, bn)
        _linear(gen, sd, p + ".linear2", bn, 2 * bn)


def _rn_visual(gen, sd, cfg: CLIPConfig):
    """The ModifiedResNet tower's keys (``visual.conv1``..``bn3``, the
    ``layer<i>.<j>`` bottlenecks, ``attnpool``)."""
    w = cfg.vision_width
    for i, (o, c) in enumerate(((w // 2, 3), (w // 2, w // 2), (w, w // 2))):
        _conv_bn(gen, sd, f"visual.conv{i + 1}", f"visual.bn{i + 1}", o, c,
                 3)
    in_c = w
    for li, n_blocks in enumerate(cfg.rn_layers):
        planes = w * 2 ** li
        for bi in range(n_blocks):
            p = f"visual.layer{li + 1}.{bi}"
            _conv_bn(gen, sd, p + ".conv1", p + ".bn1", planes, in_c, 1)
            _conv_bn(gen, sd, p + ".conv2", p + ".bn2", planes, planes, 3)
            _conv_bn(gen, sd, p + ".conv3", p + ".bn3", 4 * planes, planes,
                     1)
            if bi == 0:
                _conv_bn(gen, sd, p + ".downsample.0", p + ".downsample.1",
                         4 * planes, in_c, 1)
            in_c = 4 * planes
    e = w * 32
    sd["visual.attnpool.positional_embedding"] = _normal(
        gen, (cfg.grid_size ** 2 + 1, e), e ** -0.5)
    for n in "qkv":
        _linear(gen, sd, f"visual.attnpool.{n}_proj", e, e)
    _linear(gen, sd, "visual.attnpool.c_proj", cfg.embed_dim, e)


def clip_state_dict(cfg: CLIPConfig, seed=0, adapters=False):
    """A CLIP state dict of ``cfg``'s shapes under OpenAI's key names, the
    text tower included: a ViT, with ``adapters`` the reference model's
    ``adaptermlp`` weights in ``cfg.adapter_layers``; or, for an RN config
    (``cfg.rn_layers``), a ModifiedResNet."""
    gen = torch.Generator().manual_seed(seed)
    w, tw = cfg.vision_width, cfg.transformer_width
    sd = {}
    if cfg.is_resnet:
        _rn_visual(gen, sd, cfg)
    else:
        n_tok = cfg.grid_size ** 2 + 1
        sd["visual.conv1.weight"] = _normal(
            gen, (w, 3, cfg.vision_patch_size, cfg.vision_patch_size),
            (3 * cfg.vision_patch_size ** 2) ** -0.5)
        sd["visual.class_embedding"] = _normal(gen, (w,), w ** -0.5)
        sd["visual.positional_embedding"] = _normal(gen, (n_tok, w),
                                                    w ** -0.5)
        _ln(gen, sd, "visual.ln_pre", w)
        for i in range(cfg.vision_layers):
            key = f"visual.transformer.resblocks.{i}"
            _clip_block(gen, sd, key, w)
            if adapters and i in cfg.adapter_layers:
                _adapter(gen, sd, key + ".adaptermlp", cfg)
        _ln(gen, sd, "visual.ln_post", w)
        sd["visual.proj"] = _normal(gen, (w, cfg.embed_dim), w ** -0.5)
    sd["token_embedding.weight"] = _normal(gen, (cfg.vocab_size, tw), 0.02)
    sd["positional_embedding"] = _normal(gen, (cfg.context_length, tw), 0.01)
    for i in range(cfg.transformer_layers):
        _clip_block(gen, sd, f"transformer.resblocks.{i}", tw)
    _ln(gen, sd, "ln_final", tw)
    sd["text_projection"] = _normal(gen, (tw, cfg.embed_dim), tw ** -0.5)
    sd["logit_scale"] = torch.tensor(float(np.log(1 / 0.07)))
    return sd


def _conv_bn(gen, sd, conv, bn, out_c, in_c, k):
    sd[conv + ".weight"] = _normal(gen, (out_c, in_c, k, k),
                                   (2.0 / (in_c * k * k)) ** 0.5)
    sd[bn + ".weight"] = 1.0 + _normal(gen, (out_c,), 0.05)
    sd[bn + ".bias"] = _normal(gen, (out_c,), 0.05)
    sd[bn + ".running_mean"] = _normal(gen, (out_c,), 0.05)
    sd[bn + ".running_var"] = 1.0 + torch.rand((out_c,), generator=gen) * 0.2
    sd[bn + ".num_batches_tracked"] = torch.tensor(0)


def resnet50_state_dict(gen, prefix=""):
    """torchvision ResNet-50's backbone keys (no fc) under ``prefix``."""
    sd = {}
    _conv_bn(gen, sd, prefix + "conv1", prefix + "bn1", 64, 3, 7)
    in_c = 64
    for li, (n_blocks, out_c) in enumerate(zip(LAYER_BLOCKS,
                                               (256, 512, 1024, 2048))):
        mid = out_c // 4
        for bi in range(n_blocks):
            p = f"{prefix}layer{li + 1}.{bi}"
            _conv_bn(gen, sd, p + ".conv1", p + ".bn1", mid, in_c, 1)
            _conv_bn(gen, sd, p + ".conv2", p + ".bn2", mid, mid, 3)
            _conv_bn(gen, sd, p + ".conv3", p + ".bn3", out_c, mid, 1)
            if bi == 0:
                _conv_bn(gen, sd, p + ".downsample.0", p + ".downsample.1",
                         out_c, in_c, 1)
            in_c = out_c
    return sd


def detr_state_dict(cfg: DETRConfig, seed=0, spread=None, human=0):
    """A DETR-R50 state dict of ``cfg``'s shapes. ``spread``: the last box
    layer's weights times ``spread`` plus N(0, 1) biases, and the logit of
    class ``human`` (1 in a 92-logit COCO detector) raised by 10, so that
    the queries of a random DETR differ and find people."""
    gen = torch.Generator().manual_seed(seed)
    d, ff = cfg.hidden_dim, cfg.dim_feedforward
    sd = resnet50_state_dict(gen, "backbone.0.body.")
    for i in range(cfg.enc_layers):
        p = f"transformer.encoder.layers.{i}"
        _mha(gen, sd, p + ".self_attn", d)
        _linear(gen, sd, p + ".linear1", ff, d)
        _linear(gen, sd, p + ".linear2", d, ff)
        _ln(gen, sd, p + ".norm1", d)
        _ln(gen, sd, p + ".norm2", d)
    for i in range(cfg.dec_layers):
        p = f"transformer.decoder.layers.{i}"
        _mha(gen, sd, p + ".self_attn", d)
        _mha(gen, sd, p + ".multihead_attn", d)
        _linear(gen, sd, p + ".linear1", ff, d)
        _linear(gen, sd, p + ".linear2", d, ff)
        for n in (1, 2, 3):
            _ln(gen, sd, f"{p}.norm{n}", d)
    _ln(gen, sd, "transformer.decoder.norm", d)
    sd["input_proj.weight"] = _normal(gen, (d, cfg.backbone_dim, 1, 1),
                                      cfg.backbone_dim ** -0.5)
    sd["input_proj.bias"] = _normal(gen, (d,), 0.02)
    sd["query_embed.weight"] = _normal(gen, (cfg.num_queries, d), 1.0)
    _linear(gen, sd, "class_embed", cfg.num_classes, d)
    for i in range(3):
        _linear(gen, sd, f"bbox_embed.layers.{i}", 4 if i == 2 else d, d)
    if spread is not None:
        sd["bbox_embed.layers.2.weight"] *= spread
        sd["bbox_embed.layers.2.bias"] += _normal(gen, (4,), 1.0)
        sd["class_embed.bias"][human] += 10.0
    return sd


def pair_annotations(image_names, seed=0, max_pairs=3, size=(640, 480)):
    """A pair-embedding pickle's contents for ``image_names``: per image 1
    to ``max_pairs`` annotated pairs with boxes inside ``size`` (w, h),
    HICO-DET object and verb ids of valid interactions, and unit-scale
    random CLIP crop features (the reference's ``huamn_features`` key
    kept)."""
    rng = np.random.default_rng(seed)
    w, h = size
    out = {}
    for name in image_names:
        k = int(rng.integers(1, max_pairs + 1))
        corr = [HICO.class_corr[int(i)] for i in rng.integers(0, 600, k)]
        boxes = []
        for _ in range(2 * k):
            x0, y0 = rng.uniform(0, w / 2), rng.uniform(0, h / 2)
            boxes.append([x0, y0, rng.uniform(x0 + 8, w),
                          rng.uniform(y0 + 8, h)])
        out[name] = {
            "boxes_h": np.asarray(boxes[:k], np.float32),
            "boxes_o": np.asarray(boxes[k:], np.float32),
            "objects": np.asarray([c[1] for c in corr]),
            "verbs": np.asarray([c[2] for c in corr]),
            "huamn_features": rng.normal(size=(k, FEATURE_DIM))
            .astype(np.float32),
            "object_features": rng.normal(size=(k, FEATURE_DIM))
            .astype(np.float32),
            "union_features": rng.normal(size=(k, FEATURE_DIM))
            .astype(np.float32)}
    return out


def write_checkpoints(out_dir, clip_cfg: CLIPConfig, detr_cfg: DETRConfig,
                      seed=0, image_names=(), dino=True, spread=30.0,
                      human=0):
    """Write ``clip.pt`` (a state dict), ``detr.pth`` ({"model": ...};
    ``spread`` and ``human`` as :func:`detr_state_dict` takes them),
    ``dino.pth`` ({"teacher": ...}; with ``dino``) and ``pairs.p`` (for
    ``image_names``) under ``out_dir``, from ``seed``. Returns {"clip",
    "detr", "dino", "pairs"} -> path, the RunConfig fields
    ``clip_model_path``, ``pretrained_detr``, ``dino_pretrained`` and
    ``file1``."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {k: os.path.join(out_dir, f) for k, f in (
        ("clip", "clip.pt"), ("detr", "detr.pth"), ("dino", "dino.pth"),
        ("pairs", "pairs.p"))}
    torch.save(clip_state_dict(clip_cfg, seed), paths["clip"])
    torch.save({"model": detr_state_dict(detr_cfg, seed + 1, spread, human)},
               paths["detr"])
    if dino:
        torch.save({"teacher": resnet50_state_dict(
            torch.Generator().manual_seed(seed + 2), "backbone.")},
            paths["dino"])
    with open(paths["pairs"], "wb") as f:
        pickle.dump(pair_annotations(image_names, seed + 3), f)
    return paths
