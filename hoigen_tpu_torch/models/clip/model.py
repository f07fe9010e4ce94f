"""Adapter-CLIP: the ViT image tower and the causal text tower (port of
``hoigen_tpu/models/clip/model.py``).

Plain functions over nested parameter dicts with the JAX package's key
paths and layouts (Linear weights (out, in)). ResidualAttentionBlock: a
parallel bottleneck adapter on the raw input (x = x + adapter(x, prior)),
then pre-LN self-attention and a QuickGELU MLP. LayerNorms run in float32
whatever the activation dtype. Dropout (the adapters') runs only when a
``torch.Generator`` is given, as the JAX package's runs only with an rng.
With ``cfg.fused_attention`` the blocks' self-attention goes through the
fused attention kernels (``ops/attention.py``), whose backward is K4; the
eval step turns it off, as the JAX package's does. The text tower's
self-attention takes a causal additive mask, so it runs the plain ``mha``
(the fused kernels take a per-key bias, not a mask), as in JAX. An RN
config (``cfg.rn_layers``) routes the image tower to the ModifiedResNet
of ``resnet.py``.
"""
import math

import numpy as np
import torch

from ...ops._weights import cast
from ...ops.attention import fused_attention
from .config import CLIPConfig
from .resnet import init_modified_resnet_params, modified_resnet_forward

LN_EPS = 1e-5


def layer_norm(x, p):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    out = (xf - mean) * torch.rsqrt(var + LN_EPS)
    return (out * p["g"] + p["b"]).to(x.dtype)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def apply_dropout(x, rate, generator):
    """Inverted dropout: each element kept with probability 1 - rate and
    scaled by 1 / (1 - rate), from ``generator`` (a torch.Generator on x's
    device); the identity without a generator or at rate 0."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def mha(p, q, kv, num_heads, attn_mask=None, key_padding_mask=None,
        kv_pos=None):
    """torch nn.MultiheadAttention semantics, batch-first.

    q: (B, Lq, E), kv: (B, Lk, E). attn_mask: additive (Lq, Lk).
    key_padding_mask: (B, Lk) bool, True = ignore (scores set to -1e9).
    kv_pos: optional positional embedding added to keys only."""
    b, lq, e = q.shape
    lk = kv.shape[1]
    hd = e // num_heads
    dt = q.dtype
    # projections run in the activation dtype (a no-op for an f32 tower)
    w_q, w_k, w_v = cast(p["w_qkv"], dt).chunk(3, dim=0)
    b_q, b_k, b_v = cast(p["b_qkv"], dt).chunk(3, dim=0)
    k_in = kv if kv_pos is None else kv + kv_pos
    qh = (q @ w_q.T + b_q).reshape(b, lq, num_heads, hd)
    kh = (k_in @ w_k.T + b_k).reshape(b, lk, num_heads, hd)
    vh = (kv @ w_v.T + b_v).reshape(b, lk, num_heads, hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(hd)
    scores = scores.float()
    if attn_mask is not None:
        scores = scores + attn_mask
    if key_padding_mask is not None:
        scores = torch.where(key_padding_mask[:, None, None, :], -1e9, scores)
    attn = torch.softmax(scores, dim=-1).to(dt)
    out = torch.einsum("bhqk,bkhd->bqhd", attn, vh).reshape(b, lq, e)
    return out @ cast(p["w_out"], dt).T + cast(p["b_out"], dt)


def decoder_layer(p, tgt, memory, num_heads, key_padding_mask=None,
                  dropout=0.0, generator=None):
    """Post-norm cross-attention decoder layer (self-attention elided), with
    dropout after the attention, inside the feed-forward and after it. The
    adapters use no other form."""
    tgt2 = mha(p["attn"], tgt, memory, num_heads,
               key_padding_mask=key_padding_mask)
    tgt = layer_norm(tgt + apply_dropout(tgt2, dropout, generator), p["norm2"])
    h = apply_dropout(torch.relu(tgt @ p["lin1_w"].T + p["lin1_b"]), dropout,
                 generator) @ p["lin2_w"].T + p["lin2_b"]
    return layer_norm(tgt + apply_dropout(h, dropout, generator), p["norm3"])


def adapter_forward(p, x, prior, prior_mask, cfg: CLIPConfig,
                    generator=None):
    """Instance adapter. x: (B, L, E); prior: (B, P, bottleneck);
    prior_mask: (B, P) True = pad."""
    down = torch.relu(x @ p["down_w"].T + p["down_b"])
    if prior is not None:
        for lp in p["layers"]:
            down = decoder_layer(lp, down, prior, cfg.adapter_heads,
                                 key_padding_mask=prior_mask,
                                 dropout=cfg.adapter_dropout,
                                 generator=generator)
    else:
        down = decoder_layer(p["self_layer"], down, down, cfg.adapter_heads,
                             dropout=cfg.adapter_dropout,
                             generator=generator)
    return (down @ p["up_w"].T + p["up_b"]) * p["scale"]


def _mhsa_fused(p, x, num_heads):
    """Unmasked self-attention through :func:`fused_attention` (K1 forward,
    K4 backward on CUDA; their plain versions on the CPU). The same math as
    mha(q=kv=x) with no masks.

    q, k and v are passed as (B, H, L, D) views of the (B, L, H, D)
    projections, which the kernels read through their strides; the output
    comes back as the same kind of view, so the reshape to (B, L, E) after
    the call, and autograd's reshapes of the gradients, copy nothing."""
    b, l, e = x.shape
    hd = e // num_heads
    dt = x.dtype
    w_q, w_k, w_v = cast(p["w_qkv"], dt).chunk(3, dim=0)
    b_q, b_k, b_v = cast(p["b_qkv"], dt).chunk(3, dim=0)

    def heads(w, bias):
        return (x @ w.T + bias).reshape(b, l, num_heads, hd).transpose(1, 2)

    o = fused_attention(heads(w_q, b_q), heads(w_k, b_k), heads(w_v, b_v))
    out = o.to(dt).transpose(1, 2).reshape(b, l, e)
    return out @ cast(p["w_out"], dt).T + cast(p["b_out"], dt)


def residual_block(p, x, prior, prior_mask, num_heads, cfg: CLIPConfig,
                   attn_mask=None, generator=None):
    if "adapter" in p:
        x = x + adapter_forward(p["adapter"], x, prior, prior_mask, cfg,
                                generator=generator)
    h = layer_norm(x, p["ln_1"])
    if attn_mask is None and cfg.fused_attention:
        x = x + _mhsa_fused(p["attn"], h, num_heads)
    else:
        x = x + mha(p["attn"], h, h, num_heads, attn_mask=attn_mask)
    h = layer_norm(x, p["ln_2"])
    h = quick_gelu(h @ p["mlp_fc_w"].T + p["mlp_fc_b"])
    return x + h @ p["mlp_proj_w"].T + p["mlp_proj_b"]


def _patch_embed(x, conv_w):
    """Non-overlapping patch conv as a matmul.
    x: (B, 3, H, W); conv_w: (width, 3, p, p) -> (B, gh*gw, width)."""
    width, c, ps, _ = conv_w.shape
    b, _, h, w = x.shape
    gh, gw = h // ps, w // ps
    patches = x.reshape(b, c, gh, ps, gw, ps)
    patches = patches.permute(0, 2, 4, 1, 3, 5).reshape(b, gh * gw,
                                                        c * ps * ps)
    return patches @ conv_w.reshape(width, -1).T


def encode_image(params, images, cfg: CLIPConfig, prior=None,
                 prior_mask=None, generator=None):
    """images: (B, 3, H, W) -> (global (B, embed), local (B, gh, gw, embed)).
    ln_post and the projection apply to every token; CLS is the global
    feature, the rest form the local grid. ``generator``: the adapters'
    dropout (training); None runs none.

    An RN config runs the ModifiedResNet tower, which has no instance
    adapters in the reference, so a prior is refused."""
    if cfg.is_resnet:
        if prior is not None:
            raise ValueError(
                "ModifiedResNet CLIP towers have no instance adapters "
                "(CLIP_models_adapter_prior2.py:311-420); prior must be "
                "None")
        return modified_resnet_forward(params["visual"], images,
                                       cfg.vision_heads)
    p = params["visual"]
    x = _patch_embed(images, p["conv1_w"])
    b, n_patch, width = x.shape
    cls = p["class_embedding"].to(x.dtype).expand(b, 1, width)
    x = torch.cat([cls, x], dim=1) + p["positional_embedding"]
    x = layer_norm(x, p["ln_pre"])
    for bp in p["blocks"]:
        x = residual_block(bp, x, prior, prior_mask, cfg.vision_heads, cfg,
                           generator=generator)
    x = layer_norm(x, p["ln_post"])
    x = x @ p["proj"]
    gh = gw = int(math.isqrt(n_patch))
    return x[:, 0, :], x[:, 1:, :].reshape(b, gh, gw, -1)


def _causal_mask(length, device=None):
    return torch.triu(torch.full((length, length), float("-inf"),
                                 device=device), diagonal=1)


def text_encoder_forward(params, token_embeds, eot_idx, cfg: CLIPConfig):
    """The text path shared by raw tokens and learned prompts
    (CLIP.encode_text / TextEncoder). token_embeds: (N, L, width), any
    learned context included; eot_idx: (N,) the position whose feature is
    projected. -> (N, embed_dim)."""
    p = params["text"]
    x = token_embeds + p["positional_embedding"].to(token_embeds.dtype)
    mask = _causal_mask(x.shape[1], x.device)
    for bp in p["blocks"]:
        x = residual_block(bp, x, None, None, cfg.transformer_heads, cfg,
                           attn_mask=mask)
    x = layer_norm(x, p["ln_final"])
    x = x[torch.arange(x.shape[0], device=x.device), eot_idx]
    return x @ p["text_projection"]


def encode_text(params, tokens, cfg: CLIPConfig):
    """tokens: integer (N, L) -> (N, embed_dim), each sequence's feature
    at its end-of-text token (the largest id)."""
    embeds = params["text"]["token_embedding"][tokens]
    return text_encoder_forward(params, embeds, tokens.argmax(-1), cfg)


# ------------------------------------------------------------------ init --
def _uniform(gen, shape, lo, hi):
    return torch.rand(shape, generator=gen) * (hi - lo) + lo


def _linear_init(gen, out_dim, in_dim):
    # torch nn.Linear default: U(-1/sqrt(in), 1/sqrt(in))
    bound = 1.0 / math.sqrt(in_dim)
    return (_uniform(gen, (out_dim, in_dim), -bound, bound),
            _uniform(gen, (out_dim,), -bound, bound))


def _ln_init(dim):
    return {"g": torch.ones(dim), "b": torch.zeros(dim)}


def _decoder_layer_init(gen, d, ff):
    a = math.sqrt(3.0 / d)
    w_out, b_out = _linear_init(gen, d, d)
    lin1_w, lin1_b = _linear_init(gen, ff, d)
    lin2_w, lin2_b = _linear_init(gen, d, ff)
    return {
        "attn": {"w_qkv": _uniform(gen, (3 * d, d), -a, a),
                 "b_qkv": torch.zeros(3 * d),
                 "w_out": w_out, "b_out": b_out},
        "norm1": _ln_init(d), "norm2": _ln_init(d), "norm3": _ln_init(d),
        "lin1_w": lin1_w, "lin1_b": lin1_b,
        "lin2_w": lin2_w, "lin2_b": lin2_b,
    }


def init_adapter_params(gen, d_model, cfg: CLIPConfig):
    bn = cfg.adapter_bottleneck
    # lora init: kaiming-uniform down, zero up and biases
    bound = math.sqrt(6.0 / d_model) / math.sqrt(6.0)
    return {
        "down_w": _uniform(gen, (bn, d_model), -bound, bound),
        "down_b": torch.zeros(bn),
        "up_w": torch.zeros(d_model, bn), "up_b": torch.zeros(d_model),
        "scale": torch.full((d_model,), 1e-9),
        "layers": [_decoder_layer_init(gen, bn, bn * 2)
                   for _ in range(cfg.adapter_num_layers)],
        "self_layer": _decoder_layer_init(gen, bn, bn * 2),
    }


def _block_init(gen, width, cfg, adapter):
    attn_std = width ** -0.5
    proj_std = (width ** -0.5) * ((2 * cfg.vision_layers) ** -0.5)
    fc_std = (2 * width) ** -0.5
    p = {
        "ln_1": _ln_init(width), "ln_2": _ln_init(width),
        "attn": {
            "w_qkv": torch.randn((3 * width, width), generator=gen) * attn_std,
            "b_qkv": torch.zeros(3 * width),
            "w_out": torch.randn((width, width), generator=gen) * proj_std,
            "b_out": torch.zeros(width),
        },
        "mlp_fc_w": torch.randn((4 * width, width), generator=gen) * fc_std,
        "mlp_fc_b": torch.zeros(4 * width),
        "mlp_proj_w": torch.randn((width, 4 * width), generator=gen)
        * proj_std,
        "mlp_proj_b": torch.zeros(width),
    }
    if adapter:
        p["adapter"] = init_adapter_params(gen, width, cfg)
    return p


def init_clip_params(gen, cfg: CLIPConfig, text=False):
    """Random image-tower parameters (``visual``) and ``logit_scale`` drawn
    from the torch.Generator ``gen`` on the CPU, in the JAX package's
    layout and distributions; with ``text``, the text tower (``text``)
    too, drawn after them. The eval and training steps run no text, so
    ``init_hoi_model`` leaves it out; the CLI draws it when no CLIP
    checkpoint is given. An RN config draws the ModifiedResNet tower
    (``resnet.py::init_modified_resnet_params``) in place of the ViT."""
    width = cfg.vision_width
    scale = width ** -0.5
    ps = cfg.vision_patch_size
    n_tok = cfg.grid_size ** 2 + 1
    if cfg.is_resnet:
        visual = init_modified_resnet_params(
            gen, cfg.rn_layers, width, cfg.embed_dim, cfg.grid_size)
    else:
        visual = {
            "conv1_w": torch.randn((width, 3, ps, ps), generator=gen) * scale,
            "class_embedding": torch.randn((width,), generator=gen) * scale,
            "positional_embedding": torch.randn((n_tok, width),
                                                generator=gen) * scale,
            "ln_pre": _ln_init(width),
            "blocks": [_block_init(gen, width, cfg, cfg.use_adapter
                                   and i in cfg.adapter_layers)
                       for i in range(cfg.vision_layers)],
            "ln_post": _ln_init(width),
            "proj": torch.randn((width, cfg.embed_dim), generator=gen)
            * scale,
        }
    params = {"visual": visual,
              "logit_scale": torch.tensor(float(np.log(1 / 0.07)))}
    if text:
        tw = cfg.transformer_width
        params["text"] = {
            "token_embedding": torch.randn((cfg.vocab_size, tw),
                                           generator=gen) * 0.02,
            "positional_embedding": torch.randn(
                (cfg.context_length, tw), generator=gen) * 0.01,
            "blocks": [_block_init(gen, tw, cfg, False)
                       for _ in range(cfg.transformer_layers)],
            "ln_final": _ln_init(tw),
            "text_projection": torch.randn((tw, cfg.embed_dim),
                                           generator=gen) * tw ** -0.5,
        }
    return params
