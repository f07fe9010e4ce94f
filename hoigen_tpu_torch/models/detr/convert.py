"""A torch DETR checkpoint ('model' / 'model_state_dict' state dict, e.g.
detr-r50-hicodet.pth) -> the port's DETR parameters, frozen BatchNorms
folded into post-conv scales and biases (port of
``hoigen_tpu/models/detr/convert.py``; the key layout of
facebookresearch/detr's backbone, transformer and detr modules)."""
import numpy as np
import torch

from .config import DETRConfig
from .resnet import LAYER_BLOCKS, fold_bn


def _np(t):
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().float().numpy()


def _t(a):
    return torch.as_tensor(np.array(_np(a), np.float32, order="C"))


def _conv_bn(sd, conv_key, bn_key):
    return fold_bn(_np(sd[conv_key + ".weight"]),
                   _np(sd[bn_key + ".weight"]), _np(sd[bn_key + ".bias"]),
                   _np(sd[bn_key + ".running_mean"]),
                   _np(sd[bn_key + ".running_var"]))


def resnet50_state_dict_to_params(sd, prefix=""):
    """A torchvision ResNet-50's keys under ``prefix`` (conv1, bn1,
    layerX.Y...) -> the folded backbone parameters."""
    params = {"stem": _conv_bn(sd, f"{prefix}conv1", f"{prefix}bn1"),
              "layers": []}
    for li, n_blocks in enumerate(LAYER_BLOCKS):
        blocks = []
        for bi in range(n_blocks):
            p = f"{prefix}layer{li + 1}.{bi}"
            blk = {f"conv{k}": _conv_bn(sd, f"{p}.conv{k}", f"{p}.bn{k}")
                   for k in (1, 2, 3)}
            if f"{p}.downsample.0.weight" in sd:
                blk["down"] = _conv_bn(sd, f"{p}.downsample.0",
                                       f"{p}.downsample.1")
            blocks.append(blk)
        params["layers"].append(blocks)
    return params


def _ln(sd, prefix):
    return {"g": _t(sd[prefix + ".weight"]), "b": _t(sd[prefix + ".bias"])}


def _attn(sd, prefix):
    return {"w_qkv": _t(sd[prefix + ".in_proj_weight"]),
            "b_qkv": _t(sd[prefix + ".in_proj_bias"]),
            "w_out": _t(sd[prefix + ".out_proj.weight"]),
            "b_out": _t(sd[prefix + ".out_proj.bias"])}


def _ffn(sd, prefix):
    return {"lin1_w": _t(sd[prefix + ".linear1.weight"]),
            "lin1_b": _t(sd[prefix + ".linear1.bias"]),
            "lin2_w": _t(sd[prefix + ".linear2.weight"]),
            "lin2_b": _t(sd[prefix + ".linear2.bias"])}


def torch_detr_state_dict_to_params(sd, cfg: DETRConfig = None):
    """state dict -> (params on the CPU, cfg); ``cfg`` None infers the
    class count, query count and width from the heads."""
    if cfg is None:
        cfg = DETRConfig(
            num_classes=_np(sd["class_embed.weight"]).shape[0],
            num_queries=_np(sd["query_embed.weight"]).shape[0],
            hidden_dim=_np(sd["query_embed.weight"]).shape[1])
    enc, dec = [], []
    for i in range(cfg.enc_layers):
        p = f"transformer.encoder.layers.{i}"
        enc.append({"attn": _attn(sd, p + ".self_attn"), **_ffn(sd, p),
                    "norm1": _ln(sd, p + ".norm1"),
                    "norm2": _ln(sd, p + ".norm2")})
    for i in range(cfg.dec_layers):
        p = f"transformer.decoder.layers.{i}"
        dec.append({"self_attn": _attn(sd, p + ".self_attn"),
                    "cross_attn": _attn(sd, p + ".multihead_attn"),
                    **_ffn(sd, p),
                    "norm1": _ln(sd, p + ".norm1"),
                    "norm2": _ln(sd, p + ".norm2"),
                    "norm3": _ln(sd, p + ".norm3")})
    params = {
        "backbone": resnet50_state_dict_to_params(sd, "backbone.0.body."),
        "input_proj": {"w": _t(sd["input_proj.weight"]),
                       "b": _t(sd["input_proj.bias"])},
        "query_embed": _t(sd["query_embed.weight"]),
        "encoder": enc,
        "decoder": dec,
        "decoder_norm": _ln(sd, "transformer.decoder.norm"),
        "class_embed": {"w": _t(sd["class_embed.weight"]),
                        "b": _t(sd["class_embed.bias"])},
        "bbox_embed": [{"w": _t(sd[f"bbox_embed.layers.{i}.weight"]),
                        "b": _t(sd[f"bbox_embed.layers.{i}.bias"])}
                       for i in range(3)],
    }
    return params, cfg
