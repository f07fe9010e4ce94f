"""The legacy UPT interaction head: cooperative and competitive layers
(port of ``hoigen_tpu/models/interaction_head.py``; reference
interaction_head.py:13-367).

As in the reference and the JAX package, the main HOIGen path does not use
it (it scores pairs with the Tip-Adapter caches); it is a supported
alternative head. It keeps the JAX package's static layout: the fixed
slots and pairs of ``models/proposals.py`` (``make_pairs``,
``pair_indices``), padded senders masked at -1e9 in the cooperative
layer's softmax over the sender axis, padded pairs masked out of the
competitive layer's attention (``models/clip/model.py::mha`` with a key
padding mask), and the detection priors of ``models/upt.py``. The batch
dimension is written out where the JAX package vmaps over images. Plain
PyTorch throughout: the JAX head reaches no Pallas kernel.
"""
import dataclasses

import torch

from ..ops.spatial import compute_spatial_encodings
from .clip.model import mha
from .proposals import ProposalConfig, make_pairs, pair_indices
from .upt import UPTConfig, compute_prior_scores


@dataclasses.dataclass(frozen=True)
class InteractionHeadConfig:
    hidden_state_size: int = 256       # DETR decoder features
    representation_size: int = 512
    num_heads: int = 8
    num_coop_layers: int = 2
    num_channels: int = 2048           # global (C5) feature channels
    num_classes: int = 117
    proposals: ProposalConfig = ProposalConfig()


def _linear(gen, out_d, in_d):
    bound = in_d ** -0.5
    return {"w": torch.rand((out_d, in_d), generator=gen) * 2 * bound - bound,
            "b": torch.rand((out_d,), generator=gen) * 2 * bound - bound}


def _apply(p, x):
    return x @ p["w"].T + p["b"]


def _norm(d):
    return {"g": torch.ones(d), "b": torch.zeros(d)}


def _ln(p, x):
    m = x.mean(-1, keepdim=True)
    v = x.var(-1, keepdim=True, unbiased=False)
    return (x - m) * torch.rsqrt(v + 1e-5) * p["g"] + p["b"]


# ---- MultiBranchFusion (:13-55) -------------------------------------------
def init_mbf(gen, appearance_size, spatial_size, hidden_size, cardinality):
    sub = hidden_size // cardinality
    return {"fc1": [_linear(gen, sub, appearance_size)
                    for _ in range(cardinality)],
            "fc2": [_linear(gen, sub, spatial_size)
                    for _ in range(cardinality)],
            "fc3": [_linear(gen, hidden_size, sub)
                    for _ in range(cardinality)]}


def mbf_forward(p, appearance, spatial):
    out = 0.0
    for f1, f2, f3 in zip(p["fc1"], p["fc2"], p["fc3"]):
        out = out + _apply(f3, torch.relu(_apply(f1, appearance)
                                          * _apply(f2, spatial)))
    return torch.relu(out)


# ---- ModifiedEncoderLayer (:58-146) ----------------------------------------
def init_modified_encoder_layer(gen, cfg: InteractionHeadConfig):
    rep, hid = cfg.representation_size, cfg.hidden_state_size
    sub = rep // cfg.num_heads
    return {
        "unary": _linear(gen, rep, hid),
        "pairwise": _linear(gen, rep, rep),
        "attn": [_linear(gen, 1, 3 * sub) for _ in range(cfg.num_heads)],
        "message": [_linear(gen, sub, sub) for _ in range(cfg.num_heads)],
        "aggregate": _linear(gen, hid, rep),
        "norm": _norm(hid),
        "ffn1": _linear(gen, hid * 4, hid),
        "ffn2": _linear(gen, hid, hid * 4),
        "ffn_norm": _norm(hid),
    }


def modified_encoder_layer(p, x, y, valid, cfg: InteractionHeadConfig):
    """x: (B, S, hidden) unary tokens; y: (B, S, S, rep) pairwise
    features; valid: (B, S) slots. Message passing with each head's
    softmax over the sender axis (axis 1), padded senders masked. ->
    (x, weights (B, S, S, heads))."""
    b, s = x.shape[:2]
    heads = cfg.num_heads
    sub = cfg.representation_size // heads
    u = torch.relu(_apply(p["unary"], x)).reshape(b, s, heads, sub)
    pw = torch.relu(_apply(p["pairwise"], y)).reshape(b, s, s, heads, sub)
    u_i = u[:, :, None].expand(b, s, s, heads, sub)
    u_j = u[:, None, :].expand(b, s, s, heads, sub)
    attn_in = torch.cat([u_i, u_j, pw], dim=-1)
    logits = torch.stack([_apply(p["attn"][h], attn_in[..., h, :])[..., 0]
                          for h in range(heads)], dim=-1)
    logits = torch.where(valid[:, :, None, None], logits, -1e9)
    weights = torch.softmax(logits, dim=1)
    msg = torch.stack([_apply(p["message"][h],
                              u_i[..., h, :] * pw[..., h, :])
                       for h in range(heads)], dim=3)
    agg = (weights[..., None] * msg).sum(dim=1)               # (B, S, H, sub)
    agg = _apply(p["aggregate"], torch.relu(agg.reshape(b, s, -1)))
    x = _ln(p["norm"], x + agg)
    h = _apply(p["ffn2"], torch.relu(_apply(p["ffn1"], x)))
    return _ln(p["ffn_norm"], x + h), weights


# ---- competitive layer (pocket TransformerEncoderLayer) --------------------
def init_comp_layer(gen, d):
    return {"attn": {"w_qkv": _linear(gen, 3 * d, d)["w"],
                     "b_qkv": torch.zeros(3 * d),
                     "w_out": _linear(gen, d, d)["w"],
                     "b_out": torch.zeros(d)},
            "norm1": _norm(d),
            "ffn1": _linear(gen, d * 4, d),
            "ffn2": _linear(gen, d, d * 4),
            "norm2": _norm(d)}


def comp_layer_forward(p, x, valid, num_heads=8):
    """x: (B, P, d) pair features; valid (B, P): padded pairs are no
    attention keys."""
    out = mha(p["attn"], x, x, num_heads, key_padding_mask=~valid)
    x = _ln(p["norm1"], x + out)
    h = _apply(p["ffn2"], torch.relu(_apply(p["ffn1"], x)))
    return _ln(p["norm2"], x + h)


# ---- the head ---------------------------------------------------------------
def init_interaction_head(gen, cfg: InteractionHeadConfig):
    """Random parameters from the torch.Generator ``gen``, in the JAX
    package's layout and distributions."""
    rep = cfg.representation_size
    return {
        "spatial_head": [_linear(gen, 128, 36), _linear(gen, 256, 128),
                         _linear(gen, rep, 256)],
        "coop": [init_modified_encoder_layer(gen, cfg)
                 for _ in range(cfg.num_coop_layers)],
        "mbf": init_mbf(gen, cfg.hidden_state_size * 2, rep, rep, 16),
        "mbf_g": init_mbf(gen, cfg.num_channels, rep, rep, 16),
        "comp": init_comp_layer(gen, rep * 2),
        "predictor": _linear(gen, cfg.num_classes, rep * 2),
    }


def interaction_head_forward(params, global_features, hidden_states, boxes,
                             scores, labels, valid, image_size,
                             object_class_multihot,
                             cfg: InteractionHeadConfig, training=True):
    """global_features: (B, num_channels) pooled backbone features;
    hidden_states: (B, S, hidden) DETR decoder embeddings of the selected
    slots; boxes/scores/labels/valid: (B, S, ...) fixed slots from
    ``select_region_proposals``; image_size (B, 2) as (h, w). -> (logits
    (B, P, C), prior (2, B, P, C), pair_valid (B, P))."""
    p_cfg = cfg.proposals
    b, s = boxes.shape[:2]
    x_idx, y_idx = pair_indices(p_cfg, boxes.device)
    _, _, _, pair_valid = make_pairs(boxes, valid, p_cfg)

    # every (i, j) slot pair of each image -> spatial head -> (B, S, S, rep)
    bi = torch.arange(s, device=boxes.device).repeat_interleave(s)
    bj = torch.arange(s, device=boxes.device).repeat(s)
    h = torch.stack([compute_spatial_encodings(boxes[n, bi], boxes[n, bj],
                                               image_size[n])
                     for n in range(b)])
    for lp in params["spatial_head"]:
        h = torch.relu(_apply(lp, h))
    sp = h.reshape(b, s, s, -1)

    unary = hidden_states
    for lp in params["coop"]:
        unary, _ = modified_encoder_layer(lp, unary, sp, valid, cfg)

    pair_app = torch.cat([unary[:, x_idx], unary[:, y_idx]], dim=-1)
    pair_sp = sp[:, x_idx, y_idx]
    pairwise = torch.cat([
        mbf_forward(params["mbf"], pair_app, pair_sp),
        mbf_forward(params["mbf_g"], global_features[:, None].expand(
            b, pair_app.shape[1], global_features.shape[-1]), pair_sp),
    ], dim=-1)
    pairwise = comp_layer_forward(params["comp"], pairwise, pair_valid)
    logits = _apply(params["predictor"], pairwise)

    u_cfg = UPTConfig(num_classes=cfg.num_classes, proposals=p_cfg)
    prior = compute_prior_scores(scores, labels, pair_valid,
                                 object_class_multihot, x_idx, y_idx,
                                 training, u_cfg)
    return logits, prior, pair_valid
