"""A (Py)Torch CLIP state dict -> the port's CLIP parameters (port of
``hoigen_tpu/models/clip/convert.py``): ViT and ModifiedResNet (RN)
checkpoints.

Takes raw OpenAI CLIP checkpoints (state dicts of tensors or numpy arrays)
and full reference-model state dicts that carry instance-adapter weights
(``adaptermlp``). Reproduces the bilinear positional-embedding
interpolation applied on load when the target resolution differs
(CLIP_models_adapter_prior2.py:508-540) and the config inference of
build_model (:934-957). Values pass through numpy in float32, as in the
JAX converter, so a leaf read from the file is the JAX one bit for bit. An
adapter missing from the file is drawn from a ``torch.Generator`` (the JAX
converter draws it from ``jax.random``). An RN tower's BatchNorms are
folded into (scale, bias) in numpy float32, as the JAX converter folds
them.
"""
import math

import numpy as np
import torch

from ..detr.resnet import fold_bn
from .config import CLIPConfig
from .model import init_adapter_params


def _np(t):
    if isinstance(t, np.ndarray):
        return t
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().float().numpy()
    return np.asarray(t, np.float32)


def _t(a):
    return torch.as_tensor(np.array(_np(a), np.float32, order="C"))


def infer_config(sd, use_adapter=True, adapter_pos="all",
                 adapter_num_layers=1) -> CLIPConfig:
    """Infer the architecture from a state dict (build_model :934-957)."""
    tw = _np(sd["ln_final.weight"]).shape[0]
    text = dict(context_length=_np(sd["positional_embedding"]).shape[0],
                vocab_size=_np(sd["token_embedding.weight"]).shape[0],
                transformer_width=tw, transformer_heads=tw // 64,
                transformer_layers=len({k.split(".")[2] for k in sd
                                        if k.startswith(
                                            "transformer.resblocks")}))
    if "visual.proj" not in sd:
        # ModifiedResNet (:937, :943-945): no adapters in the tower
        counts = tuple(
            len({k.split(".")[2] for k in sd
                 if k.startswith(f"visual.layer{b}.")}) for b in (1, 2, 3, 4))
        grid = round((_np(sd["visual.attnpool.positional_embedding"])
                      .shape[0] - 1) ** 0.5)
        return CLIPConfig(
            embed_dim=_np(sd["text_projection"]).shape[1],
            image_resolution=grid * 32, vision_layers=sum(counts),
            vision_width=_np(sd["visual.layer1.0.conv1.weight"]).shape[0],
            vision_patch_size=32, rn_layers=counts, use_adapter=False,
            adapter_layers=(), adapter_num_layers=adapter_num_layers, **text)
    vision_width = _np(sd["visual.conv1.weight"]).shape[0]
    vision_layers = len([k for k in sd if k.startswith("visual.")
                         and k.endswith(".attn.in_proj_weight")])
    patch = _np(sd["visual.conv1.weight"]).shape[-1]
    grid = round((_np(sd["visual.positional_embedding"]).shape[0] - 1) ** 0.5)
    return CLIPConfig(
        embed_dim=_np(sd["text_projection"]).shape[1],
        image_resolution=patch * grid,
        vision_layers=vision_layers,
        vision_width=vision_width,
        vision_patch_size=patch,
        **text,
        use_adapter=use_adapter,
        adapter_layers=CLIPConfig.adapter_layer_ids(adapter_pos,
                                                    vision_layers),
        adapter_num_layers=adapter_num_layers,
    )


def _bilinear_resize(grid, out_h, out_w):
    """(H, W, C) -> (out_h, out_w, C); F.interpolate's bilinear with
    align_corners=False (half-pixel centres), in numpy."""
    h, w, c = grid.shape

    def axis_weights(n_in, n_out):
        pos = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        pos = np.clip(pos, 0, n_in - 1)
        lo = np.floor(pos).astype(int)
        hi = np.minimum(lo + 1, n_in - 1)
        frac = pos - lo
        return lo, hi, frac

    ylo, yhi, fy = axis_weights(h, out_h)
    xlo, xhi, fx = axis_weights(w, out_w)
    top = grid[ylo][:, xlo] * (1 - fx)[None, :, None] \
        + grid[ylo][:, xhi] * fx[None, :, None]
    bot = grid[yhi][:, xlo] * (1 - fx)[None, :, None] \
        + grid[yhi][:, xhi] * fx[None, :, None]
    return top * (1 - fy)[:, None, None] + bot * fy[:, None, None]


def interpolate_pos_embedding(pos, target_tokens):
    """(N0+1, width) -> (target_tokens, width) by a bilinear resize of the
    spatial part (CLIP_models_adapter_prior2.py:523-536). numpy."""
    if pos.shape[0] == target_tokens:
        return pos
    cls, spatial = pos[:1], pos[1:]
    g0 = round(math.isqrt(spatial.shape[0]))
    g1 = round(math.isqrt(target_tokens - 1))
    grid = spatial.reshape(g0, g0, -1)
    out = _bilinear_resize(grid, g1, g1).reshape(g1 * g1, -1)
    return np.concatenate([cls, out], axis=0)


def _ln(sd, prefix):
    return {"g": _t(sd[prefix + ".weight"]), "b": _t(sd[prefix + ".bias"])}


def _attn(sd, prefix):
    return {"w_qkv": _t(sd[prefix + ".in_proj_weight"]),
            "b_qkv": _t(sd[prefix + ".in_proj_bias"]),
            "w_out": _t(sd[prefix + ".out_proj.weight"]),
            "b_out": _t(sd[prefix + ".out_proj.bias"])}


def _decoder_layer(sd, prefix):
    return {
        "attn": _attn(sd, prefix + ".multihead_attn"),
        "norm1": _ln(sd, prefix + ".norm1"),
        "norm2": _ln(sd, prefix + ".norm2"),
        "norm3": _ln(sd, prefix + ".norm3"),
        "lin1_w": _t(sd[prefix + ".linear1.weight"]),
        "lin1_b": _t(sd[prefix + ".linear1.bias"]),
        "lin2_w": _t(sd[prefix + ".linear2.weight"]),
        "lin2_b": _t(sd[prefix + ".linear2.bias"]),
    }


def _adapter(sd, prefix, cfg, gen):
    if prefix + ".down_proj.weight" not in sd:
        # the checkpoint predates the adapters: a fresh lora-style init
        return init_adapter_params(gen, cfg.vision_width, cfg)
    p = {
        "down_w": _t(sd[prefix + ".down_proj.weight"]),
        "down_b": _t(sd[prefix + ".down_proj.bias"]),
        "up_w": _t(sd[prefix + ".up_proj.weight"]),
        "up_b": _t(sd[prefix + ".up_proj.bias"]),
        "scale": _t(sd[prefix + ".scale"]),
        "layers": [_decoder_layer(sd, f"{prefix}.mhsa_layers.{m}")
                   for m in range(cfg.adapter_num_layers)],
    }
    if prefix + ".mhsa.multihead_attn.in_proj_weight" in sd:
        p["self_layer"] = _decoder_layer(sd, prefix + ".mhsa")
    return p


def _block(sd, prefix, cfg, has_adapter, gen):
    p = {
        "ln_1": _ln(sd, prefix + ".ln_1"),
        "ln_2": _ln(sd, prefix + ".ln_2"),
        "attn": _attn(sd, prefix + ".attn"),
        "mlp_fc_w": _t(sd[prefix + ".mlp.c_fc.weight"]),
        "mlp_fc_b": _t(sd[prefix + ".mlp.c_fc.bias"]),
        "mlp_proj_w": _t(sd[prefix + ".mlp.c_proj.weight"]),
        "mlp_proj_b": _t(sd[prefix + ".mlp.c_proj.bias"]),
    }
    if has_adapter:
        p["adapter"] = _adapter(sd, prefix + ".adaptermlp", cfg, gen)
    return p


def _fold(sd, conv, bn):
    return fold_bn(sd[conv + ".weight"], sd[bn + ".weight"], sd[bn + ".bias"],
                   sd[bn + ".running_mean"], sd[bn + ".running_var"])


def _rn_visual(sd, cfg: CLIPConfig, prefix="visual."):
    """ModifiedResNet weights (:311-420) -> ``resnet.py``'s parameters,
    BatchNorms folded; the attention pool's positional embedding resized
    bilinearly where the target resolution differs (:352-370)."""
    p = {"stem1": _fold(sd, prefix + "conv1", prefix + "bn1"),
         "stem2": _fold(sd, prefix + "conv2", prefix + "bn2"),
         "stem3": _fold(sd, prefix + "conv3", prefix + "bn3"),
         "layers": []}
    for li, n_blocks in enumerate(cfg.rn_layers):
        blocks = []
        for bi in range(n_blocks):
            bp = f"{prefix}layer{li + 1}.{bi}."
            blk = {f"conv{i}": _fold(sd, f"{bp}conv{i}", f"{bp}bn{i}")
                   for i in (1, 2, 3)}
            if bp + "downsample.0.weight" in sd:
                blk["down"] = _fold(sd, bp + "downsample.0",
                                    bp + "downsample.1")
            blocks.append(blk)
        p["layers"].append(blocks)
    ap = prefix + "attnpool."
    pos = interpolate_pos_embedding(_np(sd[ap + "positional_embedding"]),
                                    (cfg.image_resolution // 32) ** 2 + 1)
    p["attnpool"] = {"pos": _t(pos)}
    for n in "qkvc":
        p["attnpool"][n + "_w"] = _t(sd[f"{ap}{n}_proj.weight"])
        p["attnpool"][n + "_b"] = _t(sd[f"{ap}{n}_proj.bias"])
    return p


def torch_state_dict_to_params(sd, cfg: CLIPConfig = None, use_adapter=True,
                               adapter_pos="all", adapter_num_layers=1,
                               gen=None):
    """state dict -> (params on the CPU, cfg). ``cfg`` overrides the
    inferred config (its image_resolution drives the positional-embedding
    interpolation). ``gen``: the torch.Generator the missing adapters are
    drawn from (None: one seeded with 0)."""
    inferred = infer_config(sd, use_adapter, adapter_pos, adapter_num_layers)
    if cfg is None:
        cfg = inferred
    gen = gen if gen is not None else torch.Generator().manual_seed(0)

    if cfg.is_resnet:
        visual = _rn_visual(sd, cfg)
    else:
        visual = _vit_visual(sd, cfg, gen)
    text = {
        "token_embedding": _t(sd["token_embedding.weight"]),
        "positional_embedding": _t(sd["positional_embedding"]),
        "blocks": [_block(sd, f"transformer.resblocks.{i}", cfg, False, gen)
                   for i in range(cfg.transformer_layers)],
        "ln_final": _ln(sd, "ln_final"),
        "text_projection": _t(sd["text_projection"]),
    }
    return {"visual": visual, "text": text,
            "logit_scale": _t(sd["logit_scale"])}, cfg


def _vit_visual(sd, cfg, gen):
    pos = interpolate_pos_embedding(_np(sd["visual.positional_embedding"]),
                                    cfg.grid_size ** 2 + 1)
    return {
        "conv1_w": _t(sd["visual.conv1.weight"]),
        "class_embedding": _t(sd["visual.class_embedding"]),
        "positional_embedding": _t(pos),
        "ln_pre": _ln(sd, "visual.ln_pre"),
        "blocks": [
            _block(sd, f"visual.transformer.resblocks.{i}", cfg,
                   cfg.use_adapter and i in cfg.adapter_layers, gen)
            for i in range(cfg.vision_layers)],
        "ln_post": _ln(sd, "visual.ln_post"),
        "proj": _t(sd["visual.proj"]),
    }
