"""DETR detection transformer (port of ``hoigen_tpu/models/detr/model.py``).

Sine positional embedding with masked cumsum and normalisation, a post-norm
transformer (6 encoder + 6 decoder layers, query positions added at every
layer), a class head and a 3-layer sigmoid box MLP, and PostProcess. The
HOI pipeline runs DETR frozen, so there is no dropout.

On CUDA with a bf16 tower the encoder self-attention runs through the fused
attention kernel (``ops/attention.py``) and layer1's tail through the fused
bottleneck-chain kernel (``ops/fused_resnet.py``); everywhere else the plain
math runs, as the JAX package does off the TPU.
"""
import math

import torch

from ..clip.model import layer_norm, mha
from .config import DETRConfig
from .resnet import init_resnet50_params, resnet50_forward_nhwc
from ...ops.attention import fused_attention
from ...ops._weights import cast
from ...ops.boxes import box_cxcywh_to_xyxy


def downsample_mask(mask, out_h, out_w):
    """bool (B, H, W) padding mask -> (B, out_h, out_w) by nearest
    interpolation; the source index is trunc(i * (H / out_h)) in f32."""
    _, h, w = mask.shape
    dev = mask.device
    ys = (torch.arange(out_h, device=dev, dtype=torch.float32)
          * (h / out_h)).to(torch.long)
    xs = (torch.arange(out_w, device=dev, dtype=torch.float32)
          * (w / out_w)).to(torch.long)
    return mask[:, ys][:, :, xs]


def sine_position_embedding(mask, num_pos_feats=128, temperature=10000.0,
                            scale=2 * math.pi):
    """mask: bool (B, H, W), True = padding -> (B, H, W, 2*num_pos_feats)."""
    not_mask = (~mask).float()
    y_embed = torch.cumsum(not_mask, dim=1)
    x_embed = torch.cumsum(not_mask, dim=2)
    eps = 1e-6
    y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32,
                         device=mask.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / num_pos_feats)
    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()],
                        dim=4).flatten(3)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()],
                        dim=4).flatten(3)
    return torch.cat([pos_y, pos_x], dim=3)


def _ffn(p, x):
    # weights cast to the activation dtype, as in the JAX package
    dt = x.dtype
    h = torch.relu(x @ cast(p["lin1_w"], dt).T + cast(p["lin1_b"], dt))
    return h @ cast(p["lin2_w"], dt).T + cast(p["lin2_b"], dt)


def _mha_fused(p, q, kv, num_heads, key_padding_mask, kv_pos):
    """The math of :func:`mha` with the score/softmax/value contraction in
    :func:`fused_attention`; projections stay plain matmuls. Padded keys
    get an additive -1e9 bias, as in the JAX package."""
    b, lq, e = q.shape
    hd = e // num_heads
    dt = q.dtype
    lk = kv.shape[1]
    w_q, w_k, w_v = cast(p["w_qkv"], dt).chunk(3, dim=0)
    b_q, b_k, b_v = cast(p["b_qkv"], dt).chunk(3, dim=0)
    k_in = kv if kv_pos is None else kv + kv_pos.to(dt)
    qh = (q @ w_q.T + b_q).reshape(b, lq, num_heads, hd).transpose(1, 2)
    kh = (k_in @ w_k.T + b_k).reshape(b, lk, num_heads, hd).transpose(1, 2)
    vh = (kv @ w_v.T + b_v).reshape(b, lk, num_heads, hd).transpose(1, 2)
    bias = None if key_padding_mask is None else torch.where(
        key_padding_mask, -1e9, 0.0).float()
    o = fused_attention(qh.contiguous(), kh.contiguous(), vh.contiguous(),
                        key_bias=bias)
    out = o.to(dt).transpose(1, 2).reshape(b, lq, e)
    return out @ cast(p["w_out"], dt).T + cast(p["b_out"], dt)


def encoder_layer(p, src, pos, key_padding_mask, num_heads, fused=False):
    q = src + pos
    attn = _mha_fused if fused else mha
    a = attn(p["attn"], q, src, num_heads, key_padding_mask=key_padding_mask,
             kv_pos=pos)
    src = layer_norm(src + a, p["norm1"])
    return layer_norm(src + _ffn(p, src), p["norm2"])


def decoder_layer(p, tgt, memory, pos, query_pos, key_padding_mask,
                  num_heads):
    """Self-attention over the queries, then cross-attention to the memory
    (always plain: the JAX package keeps the decoder unfused)."""
    q = tgt + query_pos
    tgt = layer_norm(tgt + mha(p["self_attn"], q, tgt, num_heads,
                               kv_pos=query_pos), p["norm1"])
    a = mha(p["cross_attn"], tgt + query_pos, memory, num_heads,
            key_padding_mask=key_padding_mask, kv_pos=pos)
    tgt = layer_norm(tgt + a, p["norm2"])
    return layer_norm(tgt + _ffn(p, tgt), p["norm3"])


def transformer_forward(params, src, mask, query_embed, pos_embed,
                        cfg: DETRConfig):
    """src: (B, L, D) flattened features; mask: (B, L) True = pad;
    pos_embed: (B, L, D). Returns (dec_layers, B, Q, D) intermediates and
    memory (B, L, D)."""
    b = src.shape[0]
    memory = src
    # positional and query embeddings run in the tower dtype
    pos_embed = pos_embed.to(src.dtype)
    query_embed = cast(query_embed, src.dtype)
    fused = (cfg.fused_encoder_attention and src.is_cuda
             and src.dtype == torch.bfloat16)
    for p in params["encoder"]:
        memory = encoder_layer(p, memory, pos_embed, mask, cfg.nheads,
                               fused=fused)
    tgt = torch.zeros((b, cfg.num_queries, cfg.hidden_dim), dtype=src.dtype,
                      device=src.device)
    qp = query_embed.expand(b, *query_embed.shape)
    intermediates = []
    for p in params["decoder"]:
        tgt = decoder_layer(p, tgt, memory, pos_embed, qp, mask, cfg.nheads)
        intermediates.append(layer_norm(tgt, params["decoder_norm"]))
    return torch.stack(intermediates), memory


def detr_forward(params, images, image_mask, cfg: DETRConfig):
    """images: (B, 3, H, W) padded batch; image_mask: bool (B, H, W) True
    where padded. Returns pred_logits (B, Q, C+1), pred_boxes (B, Q, 4
    cxcywh in [0, 1]), their per-layer stacks, hs and memory. The heads run
    in f32 (f32 weights promote the tower's output, as in JAX)."""
    fused_tail = cfg.fused_resnet_tail if (
        images.is_cuda and images.dtype == torch.bfloat16
        and not cfg.remat_backbone) else ()
    feat = resnet50_forward_nhwc(params["backbone"],
                                 images.permute(0, 2, 3, 1).contiguous(),
                                 fused_tail=fused_tail,
                                 remat=cfg.remat_backbone)
    b, fh, fw, _ = feat.shape
    fmask = downsample_mask(image_mask, fh, fw)
    pos = sine_position_embedding(fmask, cfg.hidden_dim // 2)
    w = cast(params["input_proj"]["w"], feat.dtype)[:, :, 0, 0]
    src = (feat @ w.T + cast(params["input_proj"]["b"], feat.dtype)).reshape(
        b, fh * fw, cfg.hidden_dim)
    pos = pos.reshape(b, fh * fw, cfg.hidden_dim)
    mask = fmask.reshape(b, fh * fw)
    hs, memory = transformer_forward(params, src, mask,
                                     params["query_embed"], pos, cfg)
    hf = hs.float()
    logits = hf @ params["class_embed"]["w"].T + params["class_embed"]["b"]
    h = hf
    for i, lp in enumerate(params["bbox_embed"]):
        h = h @ lp["w"].T + lp["b"]
        if i < len(params["bbox_embed"]) - 1:
            h = torch.relu(h)
    boxes = torch.sigmoid(h)
    return {"pred_logits": logits[-1], "pred_boxes": boxes[-1],
            "aux_logits": logits, "aux_boxes": boxes,
            "hs": hs, "memory": memory}


def postprocess(pred_logits, pred_boxes, image_sizes):
    """Per-query (score, label, xyxy box) at ``image_sizes`` (B, 2) as
    (h, w): scores/labels (B, Q), boxes (B, Q, 4) in absolute coords. The
    label of a tie is the first maximal class, as ``jnp.argmax``."""
    prob = torch.softmax(pred_logits, dim=-1)[..., :-1]
    scores = prob.amax(-1)
    labels = prob.argmax(-1)
    boxes = box_cxcywh_to_xyxy(pred_boxes)
    img_h, img_w = image_sizes[:, 0], image_sizes[:, 1]
    scale = torch.stack([img_w, img_h, img_w, img_h], dim=1)
    return {"scores": scores, "labels": labels,
            "boxes": boxes * scale[:, None, :].to(boxes.dtype)}


# ------------------------------------------------------------------ init --
def _xavier(gen, shape):
    fan_in, fan_out = shape[-1], shape[-2] if len(shape) > 1 else shape[-1]
    a = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.rand(shape, generator=gen) * (2 * a) - a


def _attn_init(gen, d):
    return {"w_qkv": _xavier(gen, (3 * d, d)), "b_qkv": torch.zeros(3 * d),
            "w_out": _xavier(gen, (d, d)), "b_out": torch.zeros(d)}


def _ln(d):
    return {"g": torch.ones(d), "b": torch.zeros(d)}


def _enc_layer_init(gen, cfg):
    return {"attn": _attn_init(gen, cfg.hidden_dim),
            "lin1_w": _xavier(gen, (cfg.dim_feedforward, cfg.hidden_dim)),
            "lin1_b": torch.zeros(cfg.dim_feedforward),
            "lin2_w": _xavier(gen, (cfg.hidden_dim, cfg.dim_feedforward)),
            "lin2_b": torch.zeros(cfg.hidden_dim),
            "norm1": _ln(cfg.hidden_dim), "norm2": _ln(cfg.hidden_dim)}


def _dec_layer_init(gen, cfg):
    p = _enc_layer_init(gen, cfg)
    p["self_attn"] = _attn_init(gen, cfg.hidden_dim)
    p["cross_attn"] = p.pop("attn")
    p["norm3"] = _ln(cfg.hidden_dim)
    return p


def init_detr_params(gen, cfg: DETRConfig = DETRConfig()):
    """Random DETR parameters (xavier-uniform linears, normal query
    embeddings, He-normal backbone) drawn from the torch.Generator ``gen``
    on the CPU, in the JAX package's layout."""
    d = cfg.hidden_dim
    return {
        "backbone": init_resnet50_params(gen),
        "input_proj": {"w": _xavier(gen, (d, cfg.backbone_dim, 1, 1)),
                       "b": torch.zeros(d)},
        "query_embed": torch.randn((cfg.num_queries, d), generator=gen),
        "encoder": [_enc_layer_init(gen, cfg)
                    for _ in range(cfg.enc_layers)],
        "decoder": [_dec_layer_init(gen, cfg)
                    for _ in range(cfg.dec_layers)],
        "decoder_norm": _ln(d),
        "class_embed": {"w": _xavier(gen, (cfg.num_classes, d)),
                        "b": torch.zeros(cfg.num_classes)},
        "bbox_embed": [{"w": _xavier(gen, (4 if i == 2 else d, d)),
                        "b": torch.zeros(4 if i == 2 else d)}
                       for i in range(3)],
    }
