"""UPT, the unary-pairwise HOI head (port of ``hoigen_tpu/models/upt.py``).

DETR postprocess -> select_region_proposals (NMS + min/max instance
selection) -> detection priors (score + box + object embedding -> MLP) ->
adapter-CLIP image encoder -> roi_align_mean pooled human/object/union
features -> the logit branches (cache H/O/U or HO/U, text, CLIP-global
cache, DINO cache) -> sigmoid(logits) * prior^lambda detections, gathered
through the per-object verb LUT (eval), or ground-truth association, one
generated pair per image and the masked focal loss (training). All shapes
are static; padding slots are masked. On CUDA with ``use_pallas_cache`` the
H/O/U cache branches run the fused cache-scoring kernel
(``ops/pallas_cache.py``).
"""
import dataclasses

import numpy as np
import torch

from ..ops.boxes import box_iou, recover_boxes
from ..ops.focal import binary_focal_loss_with_logits, prior_modulated_logits
from ..ops.pallas_cache import fused_cache_logits
from ..ops.roi_align import roi_align_mean
from .clip.config import CLIPConfig
from .clip.model import apply_dropout, encode_image, mha
from .proposals import ProposalConfig, make_pairs, pair_indices, \
    select_region_proposals


@dataclasses.dataclass(frozen=True)
class UPTConfig:
    num_classes: int = 117
    num_shot: int = 2
    alpha: float = 0.5
    gamma: float = 0.2
    fg_iou_thresh: float = 0.5
    hyper_lambda: float = 2.8          # eval-time score power
    logits_type: str = "HO+U+T"        # branches to sum
    cache_model: str = "cache_feat"    # 'cache_feat' | 'gen_feat'
    use_clip_global: bool = True
    use_dino: bool = True
    use_weight_pred: bool = False
    use_mlp_proj: bool = False
    obj_affordance: bool = False
    use_insadapter: bool = True
    # the H/O/U cache products through the fused cache-scoring kernel with
    # bf16 tensor-core inputs; taken on CUDA only
    use_pallas_cache: bool = False
    # values matrix of the CLIP-global/DINO branches: 'pair_one_hots' (the
    # reference runtime) or 'built'
    global_values_mode: str = "pair_one_hots"
    prior_type: str = "cbe"
    prior_method: int = 0              # 0 instance | 1 pair | 2 learnable
    vis_prompt_num: int = 50
    use_consistloss: bool = False      # rejected (see __post_init__)
    tpt: bool = False                  # rejected (see __post_init__)
    LA: bool = False
    LA_weight: float = 0.6
    feat_mask_type: int = 0
    proposals: ProposalConfig = ProposalConfig()
    clip_resolution: int = 224
    visual_output_dim: int = 512
    dino_dim: int = 2048
    max_gt_pairs: int = 32
    generate_feature: bool = False

    def __post_init__(self):
        # flags whose reference code paths are broken at the source
        if self.use_consistloss:
            raise ValueError(
                "use_consistloss is not supported: the reference path is "
                "broken by construction (upt_tip...py:1258 returns 9 values "
                "unpacked into 8 at :1635)")
        if self.tpt:
            raise ValueError(
                "tpt is not supported: the reference calls an undefined "
                "compute_loss_tpt (upt_tip...py:1626-1627)")
        if self.prior_method not in (0, 1, 2):
            raise ValueError(f"prior_method must be 0 (instance-wise), "
                             f"1 (pair-wise) or 2 (learnable), got "
                             f"{self.prior_method}")
        if self.use_weight_pred and self.cache_model == "gen_feat":
            raise ValueError(
                "use_weight_pred requires cache_model='cache_feat': the "
                "reference's gen_feat formula reads logits_cache_HO, which "
                "gen_feat never defines -> UnboundLocalError "
                "(upt_tip...py:1172-1174)")

    @property
    def priors_initial_dim(self) -> int:
        return self.visual_output_dim + 5

    @property
    def cache_rows(self) -> int:
        return self.num_classes * self.num_shot


def _mlp3(params, x):
    for i, lp in enumerate(params):
        x = x @ lp["w"].T + lp["b"]
        if i < len(params) - 1:
            x = torch.relu(x)
    return x


def object_affordances(params, buffers):
    """Per-object affordance embeddings: a learnable query cross-attends to
    each object's valid-verb text embeddings (padding verbs masked)."""
    m = buffers["object_class_multihot"] > 0               # (O, C)
    text = buffers["origin_text_embeddings"]               # (C, D)
    n_obj = m.shape[0]
    keys = text[None].expand(n_obj, *text.shape)
    query = params["obj_affordance_query"].expand(n_obj, 1, text.shape[-1])
    out = mha(params["obj_affordance_attn"], query, keys, num_heads=1,
              key_padding_mask=~m)
    return out[:, 0, :]


def compute_priors(params, boxes, scores, labels, valid, image_sizes,
                   object_embedding, cfg: UPTConfig, buffers=None):
    """-> (prior tokens (B, T, 64), key-padding mask (B, T) True = pad).
    Every prior_type writes into the same priors_initial_dim-wide features
    with a zero tail."""
    if cfg.prior_method == 2:
        p = params["learnable_prior"]
        b = scores.shape[0]
        return (p[None].expand(b, *p.shape),
                torch.zeros((b, p.shape[0]), dtype=torch.bool,
                            device=p.device))
    h = image_sizes[:, 0:1]
    w = image_sizes[:, 1:2]
    scale = torch.cat([w, h, w, h], dim=1)[:, None, :]
    nb = boxes / scale.to(boxes.dtype)
    if cfg.obj_affordance and buffers is not None:
        object_embedding = object_affordances(params, buffers)
    obj_emb = object_embedding[labels]                     # (B, S, D)
    sc = scores[..., None]

    def pad(parts, width):
        f = torch.cat(parts, dim=-1)
        tail = cfg.priors_initial_dim - width
        if tail:
            f = torch.cat([f, f.new_zeros((*f.shape[:-1], tail))], dim=-1)
        return f

    d = cfg.visual_output_dim
    fields = {"cbe": ([sc, nb, obj_emb], d + 5), "cb": ([sc, nb], 5),
              "ce": ([sc, obj_emb], d + 1), "be": ([nb, obj_emb], d + 4),
              "c": ([sc], 1), "b": ([nb], 4), "e": ([obj_emb], d)}
    if cfg.prior_type not in fields:
        raise NotImplementedError(cfg.prior_type)
    feats = pad(*fields[cfg.prior_type])
    feats = feats * valid[..., None].to(feats.dtype)
    if cfg.prior_method == 1:
        # pair-wise: subject and object features concatenated per pair
        x_idx, y_idx = pair_indices(cfg.proposals, feats.device)
        pf = torch.cat([feats[..., x_idx, :], feats[..., y_idx, :]], dim=-1)
        pair_valid = valid[..., x_idx] & valid[..., y_idx] & (x_idx != y_idx)
        pf = pf * pair_valid[..., None].to(pf.dtype)
        return _mlp3(params["priors_downproj"], pf), ~pair_valid
    return _mlp3(params["priors_downproj"], feats), ~valid


def compute_prior_scores(scores, labels, pair_valid, object_class_multihot,
                         x_idx, y_idx, training: bool, cfg: UPTConfig):
    """-> (2, ..., P, C): detection-score priors for human and object."""
    p = 1.0 if training else cfg.hyper_lambda
    s_h = scores[..., x_idx] ** p
    s_o = scores[..., y_idx] ** p
    valid_verbs = object_class_multihot[labels[..., y_idx]]   # (..., P, C)
    m = valid_verbs * pair_valid[..., None]
    return torch.stack([s_h[..., None] * m, s_o[..., None] * m])


def _cache_branch(feats, w, b, one_hots, sample_lens, use_pallas=False):
    """((feats W^T + b) one_hots) / sample_lens. With ``use_pallas`` on CUDA
    the fused kernel runs it with bf16 operands; otherwise the plain f32
    products run, as in the JAX package off the TPU."""
    if use_pallas and feats.is_cuda:
        return fused_cache_logits(feats, w, b, one_hots, sample_lens,
                                  torch.bfloat16)
    phi = feats @ w.T + b
    return (phi @ one_hots) / sample_lens


def compute_logits(params, buffers, hum, obj, uni, feat_global, dino_feats,
                   cfg: UPTConfig):
    """All branch logits summed with learned scales. hum/obj/uni:
    (..., P, 512) L2-normalised pair features; feat_global (..., 512);
    dino_feats (..., 2048) or None. Returns (..., P, C)."""
    if cfg.use_weight_pred:
        concat = torch.cat([hum, obj, uni], dim=-1)
        w = torch.sigmoid(_mlp3(params["weight_pred_2"],
                                _mlp3(params["weight_pred_1"], concat)))
    up = cfg.use_pallas_cache
    if cfg.cache_model == "gen_feat":
        lg_h = _cache_branch(hum, params["adapter_H_w"],
                             params["adapter_H_b"], buffers["one_hots_H"],
                             buffers["sample_lens_H"], up)
        lg_o = _cache_branch(obj, params["adapter_O_w"],
                             params["adapter_O_b"], buffers["one_hots_O"],
                             buffers["sample_lens_O"], up)
        lg_u = _cache_branch(uni, params["adapter_U_w"],
                             params["adapter_U_b"], buffers["one_hots_U"],
                             buffers["sample_lens_U"], up)
        logits = (lg_h * params["logit_scale_H"]
                  + lg_o * params["logit_scale_O"]
                  + lg_u * params["logit_scale_U"])
    else:
        ho = torch.cat([hum, obj], dim=-1)
        lg_ho = _cache_branch(ho, params["adapter_HO_w"],
                              params["adapter_HO_b"], buffers["one_hots_HO"],
                              buffers["sample_lens_HO"], up) / 2.0
        lg_u = _cache_branch(uni, params["adapter_U_w"],
                             params["adapter_U_b"], buffers["one_hots_U"],
                             buffers["sample_lens_U"], up)
        if cfg.use_weight_pred:
            logits = lg_ho * w[..., 0:1] + lg_u * w[..., 1:2]
        else:
            logits = lg_ho * params["logit_scale_HO"] \
                + lg_u * params["logit_scale_U"]
    if "T" in cfg.logits_type:
        lg_t = uni @ params["text_w"].T
        if cfg.use_weight_pred:
            logits = logits + lg_t * w[..., 2:3]
        else:
            logits = logits + lg_t * params["logit_scale_T"]
    # the global and DINO cache logits enter the sum only with gen_feat
    if cfg.cache_model == "gen_feat":
        if cfg.use_clip_global:
            aff = feat_global @ params["global_cache"] \
                + params["global_cache_bias"]
            lg_g = (aff @ buffers["global_values"]) \
                / buffers["global_sample_len"]
            logits = logits + lg_g[..., None, :] * params["clip_cache_logit"]
        if cfg.use_dino and dino_feats is not None:
            aff = dino_feats @ params["dino_cache"] + params["dino_cache_bias"]
            lg_d = (aff @ buffers["dino_values"]) / buffers["dino_sample_len"]
            logits = logits + lg_d[..., None, :] * params["dino_cache_logit"]
    return logits


def _l2(f):
    return f / torch.linalg.vector_norm(f, dim=-1, keepdim=True).clamp(
        min=1e-12)


def associate_with_ground_truth(bh, bo, gt_bh, gt_bo, gt_cls, gt_valid,
                                image_size, cfg: UPTConfig):
    """bh/bo: (B, P, 4) absolute pair boxes; gt_bh/gt_bo (B, G, 4)
    normalised cxcywh; gt_cls (B, G) verb or HOI ids; gt_valid (B, G);
    image_size (B, 2). -> multihot (B, P, C)."""
    gt_h = recover_boxes(gt_bh, image_size)
    gt_o = recover_boxes(gt_bo, image_size)
    iou = torch.minimum(box_iou(bh, gt_h), box_iou(bo, gt_o))  # (B, P, G)
    match = (iou >= cfg.fg_iou_thresh) & gt_valid[..., None, :]
    # as jax.nn.one_hot: an id outside [0, C) (a padded GT slot) gives a
    # zero row, where F.one_hot would raise
    onehot = (gt_cls[..., None] == torch.arange(
        cfg.num_classes, device=gt_cls.device)).float()
    return torch.clamp(match.float() @ onehot, 0.0, 1.0)


def interaction_loss_sum(logits, prior, labels, pair_valid,
                         alpha=0.5, gamma=0.2):
    """Unnormalised masked focal-loss sum; the caller divides by the
    positive count n_p. prior: (2, ..., P, C); entries with a zero prior
    product are excluded."""
    pp = prior[0] * prior[1]
    weights = (pp > 0) & pair_valid[..., None]
    x = prior_modulated_logits(logits, pp)
    loss = binary_focal_loss_with_logits(x, labels, alpha=alpha, gamma=gamma,
                                         reduction="none")
    return torch.sum(loss * weights)


def language_aware_loss(params, origin_text_embeddings, weight: float):
    """The optional LA regulariser: cross-entropy between the learned
    text-adapter rows and the frozen CLIP text embeddings."""
    w = params["text_w"]
    w = w / torch.linalg.vector_norm(w, dim=-1, keepdim=True)
    logp = torch.log_softmax(w @ origin_text_embeddings.T, dim=-1)
    return -weight * logp.diagonal().mean()


def upt_forward(params, buffers, detr_post, images_clip, image_sizes,
                clip_cfg: CLIPConfig, cfg: UPTConfig, dino_apply=None,
                targets=None, training=False, generator=None,
                gen_sample=None):
    """One batched step.

    detr_post: DETR postprocess at the CLIP-stream image sizes:
      scores/labels (B, Q), boxes (B, Q, 4).
    images_clip: (B, 3, r, r) normalised CLIP stream; image_sizes (B, 2).
    dino_apply: optional callable images -> (B, 2048) DINO features.
    targets (training): boxes_h/boxes_o (B, G, 4) normalised cxcywh,
      labels (B, G) class ids, valid (B, G) bool.
    generator (training): a torch.Generator on the device for the
      adapters' and the ROI features' dropout; None runs no dropout.
    gen_sample (training, generate_feature): hum/obj/uni (B, 512)
      generated features, verb_multihot (B, C), obj_cls (B,).
    Eval returns the detection dict: dense and compact (verb-LUT) scores,
    verb ids, slot boxes/scores/labels/valid, pair_valid, objects, logits.
    Training returns (loss, aux) with aux's loss_sum, n_p and gt_labels."""
    p_cfg = cfg.proposals
    boxes, scores, labels, valid = select_region_proposals(
        detr_post["scores"], detr_post["labels"], detr_post["boxes"], p_cfg)
    prior_tokens, prior_mask = compute_priors(
        params, boxes, scores, labels, valid, image_sizes,
        buffers["object_embedding"], cfg, buffers=buffers)
    if not cfg.use_insadapter:
        prior_tokens = prior_mask = None
    feat_global, feat_local = encode_image(
        params["clip"], images_clip, clip_cfg, prior=prior_tokens,
        prior_mask=prior_mask, generator=generator)
    feat_global = feat_global / torch.linalg.vector_norm(
        feat_global, dim=-1, keepdim=True)
    if cfg.use_mlp_proj:
        feat_local = _mlp3(params["mlp_proj"], feat_local)

    dino_feats = None
    if cfg.use_dino and dino_apply is not None:
        dino_feats = dino_apply(images_clip)
        dino_feats = dino_feats / torch.linalg.vector_norm(
            dino_feats, dim=-1, keepdim=True)

    bh, bo, bu, pair_valid = make_pairs(boxes, valid, p_cfg)
    grid = feat_local.shape[1]
    spatial_scale = grid / cfg.clip_resolution
    fmap = feat_local.permute(0, 3, 1, 2)                   # (B, C, g, g)
    single = roi_align_mean(fmap, boxes, (7, 7), spatial_scale)
    union = roi_align_mean(fmap, bu, (7, 7), spatial_scale)
    # feat_mask_type 0: Dropout(0.2) on the pooled ROI features, in
    # training only; type 1 skips it
    if training and cfg.feat_mask_type == 0:
        single = apply_dropout(single, 0.2, generator)
        union = apply_dropout(union, 0.2, generator)

    x_idx, y_idx = pair_indices(p_cfg, boxes.device)
    hum = _l2(single[:, x_idx])
    obj = _l2(single[:, y_idx])
    uni = _l2(union)

    logits = compute_logits(params, buffers, hum, obj, uni, feat_global,
                            dino_feats, cfg)
    prior = compute_prior_scores(scores, labels, pair_valid,
                                 buffers["object_class_multihot"],
                                 x_idx, y_idx, training, cfg)
    if training:
        return _training_loss(params, buffers, logits, prior, pair_valid,
                              bh, bo, targets, image_sizes, dino_feats,
                              gen_sample, cfg)
    pp = prior[0] * prior[1]
    # mask first, so that a non-finite logit cannot leak into a zero-prior
    # (padding) slot
    det_scores = torch.where(pp > 0, torch.sigmoid(logits) * pp, 0.0)
    objects = labels[:, y_idx]                              # (B, P)
    lut = buffers["verb_lut"][objects]                      # (B, P, Vmax)
    return dict(boxes=boxes, scores=scores, labels=labels, valid=valid,
                pair_valid=pair_valid, bh=bh, bo=bo, logits=logits,
                prior=prior, detection_scores=det_scores, objects=objects,
                detection_scores_cmp=torch.gather(det_scores, -1, lut)
                * buffers["verb_lut_valid"][objects],
                detection_verbs=lut)


def _training_loss(params, buffers, logits, prior, pair_valid, bh, bo,
                   targets, image_sizes, dino_feats, gen_sample,
                   cfg: UPTConfig):
    """The training tail of upt_forward: labels by ground-truth
    association, one generated pair per image appended, and the masked
    focal loss over the positive count. -> (loss, aux)."""
    gt_labels = associate_with_ground_truth(
        bh, bo, targets["boxes_h"], targets["boxes_o"], targets["labels"],
        targets["valid"], image_sizes, cfg)
    if cfg.generate_feature and gen_sample is not None:
        g_h, g_o, g_u = (_l2(gen_sample[k])[:, None]
                         for k in ("hum", "obj", "uni"))
        # the generated pair scores the global cache with its own union
        # feature, not the image CLS; the DINO branch keeps the image's
        # features, as in the JAX package
        g_logits = compute_logits(params, buffers, g_h, g_o, g_u, g_u[:, 0],
                                  dino_feats, cfg)
        logits = torch.cat([logits, g_logits], dim=1)
        g_prior = buffers["object_class_multihot"][
            gen_sample["obj_cls"].long()][None, :, None, :].expand(
                2, *g_logits.shape)
        prior = torch.cat([prior, g_prior], dim=2)
        gt_labels = torch.cat(
            [gt_labels, gen_sample["verb_multihot"][:, None, :]], dim=1)
        pair_valid = torch.cat(
            [pair_valid, pair_valid.new_ones((pair_valid.shape[0], 1))],
            dim=1)
    n_p = torch.sum(gt_labels * pair_valid[..., None])
    loss_sum = interaction_loss_sum(logits, prior, gt_labels, pair_valid,
                                    alpha=cfg.alpha, gamma=cfg.gamma)
    aux = dict(logits=logits, prior=prior, pair_valid=pair_valid,
               gt_labels=gt_labels, n_p=n_p, loss_sum=loss_sum)
    return loss_sum / torch.clamp(n_p, min=1.0), aux


# ------------------------------------------------------------------ init --
def _uniform(gen, shape, bound):
    return torch.rand(shape, generator=gen) * (2 * bound) - bound


def init_upt_params(gen, cfg: UPTConfig, caches, clip_params):
    """caches: ``models.cache.UPTCaches`` (numpy). Returns (params,
    buffers) on the CPU: the head's parameters (with ``clip_params`` under
    "clip") drawn from the torch.Generator ``gen``, and the frozen buffers,
    including the per-object verb LUT of the compact detections."""
    log_1_007 = torch.tensor(float(np.log(1.0 / 0.07)))

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    def mlp_init(dims):
        return [{"w": _uniform(gen, (dims[i + 1], dims[i]),
                               1.0 / np.sqrt(dims[i])),
                 "b": torch.zeros(dims[i + 1])}
                for i in range(len(dims) - 1)]

    prior_in = cfg.priors_initial_dim * (2 if cfg.prior_method == 1 else 1)
    params = {
        "clip": clip_params,
        "priors_downproj": mlp_init((prior_in, 128, 128, 64)),
        "text_w": t(caches.origin_text_embeddings),
        "logit_scale_T": log_1_007.clone(),
    }
    if cfg.prior_method == 2:
        std = float(np.sqrt(2.0 / (cfg.vis_prompt_num + 64)))
        params["learnable_prior"] = std * torch.randn(
            (cfg.vis_prompt_num, 64), generator=gen)
    if cfg.use_weight_pred:
        n_branch = len(cfg.logits_type.split("+"))
        d = cfg.visual_output_dim
        params["weight_pred_1"] = mlp_init((3 * d, 512, 128))
        params["weight_pred_2"] = mlp_init((128, 32, n_branch))
    if cfg.use_mlp_proj:
        d = cfg.visual_output_dim
        params["mlp_proj"] = mlp_init((d, 512, 512, d))
    if cfg.obj_affordance:
        d = cfg.visual_output_dim
        params["obj_affordance_query"] = torch.randn(
            (1, d), generator=gen) * d ** -0.5
        params["obj_affordance_attn"] = {
            "w_qkv": torch.randn((3 * d, d), generator=gen) * d ** -0.5,
            "b_qkv": torch.zeros(3 * d),
            "w_out": torch.randn((d, d), generator=gen) * d ** -0.5,
            "b_out": torch.zeros(d)}
    rows = cfg.cache_rows
    if cfg.cache_model == "gen_feat":
        for name, arr in (("H", caches.cache_h), ("O", caches.cache_o),
                          ("U", caches.cache_u)):
            params[f"adapter_{name}_w"] = t(arr)
            params[f"adapter_{name}_b"] = -torch.ones(rows)
            params[f"logit_scale_{name}"] = log_1_007.clone()
    else:
        params.update({
            "adapter_HO_w": t(np.concatenate([caches.cache_h, caches.cache_o],
                                             axis=-1)),
            "adapter_HO_b": -torch.ones(rows),
            "adapter_U_w": t(caches.cache_u),
            "adapter_U_b": -torch.ones(rows),
            "logit_scale_HO": log_1_007.clone(),
            "logit_scale_U": log_1_007.clone(),
        })
    if cfg.use_clip_global:
        params.update({
            "global_cache": t(caches.clip_global_keys),
            "global_cache_bias": -torch.ones(caches.clip_global_keys.shape[1]),
            "clip_cache_logit": log_1_007.clone(),
        })
    if cfg.use_dino:
        params.update({
            "dino_cache": t(caches.dino_keys),
            "dino_cache_bias": -torch.ones(caches.dino_keys.shape[1]),
            "dino_cache_logit": log_1_007.clone(),
        })

    def branch(name):
        v = getattr(caches, f"one_hots_{name}", None)
        return np.asarray(caches.one_hots if v is None else v, np.float32)

    oh = {k: branch(k) for k in ("h", "o", "u", "ho")}
    if cfg.global_values_mode == "built":
        if caches.clip_global_values is None or caches.dino_values is None:
            raise ValueError(
                "global_values_mode='built' needs caches with "
                "clip_global_values/dino_values")
        g_vals, d_vals = caches.clip_global_values, caches.dino_values
    elif cfg.global_values_mode == "pair_one_hots":
        g_vals, d_vals = oh["u"], oh["u"]
    else:
        raise ValueError(f"global_values_mode: {cfg.global_values_mode}")
    buffers = {}
    for key, name in (("H", "h"), ("O", "o"), ("U", "u"), ("HO", "ho")):
        buffers[f"one_hots_{key}"] = t(oh[name])
        buffers[f"sample_lens_{key}"] = t(oh[name].sum(0))
    buffers.update({
        "global_values": t(g_vals),
        "global_sample_len": t(np.maximum(np.asarray(g_vals).sum(0), 1.0)),
        "dino_values": t(d_vals),
        "dino_sample_len": t(np.maximum(np.asarray(d_vals).sum(0), 1.0)),
        "object_class_multihot": t(caches.object_class_multihot),
        "object_embedding": t(caches.object_embedding),
        "origin_text_embeddings": t(caches.origin_text_embeddings),
    })
    # per-object verb LUT (ascending ids) and its validity, built from the
    # multihot that the prior mask uses, so compaction loses nothing
    m_np = np.asarray(caches.object_class_multihot) > 0
    vmax = max(int(m_np.sum(1).max()), 1)
    lut = np.zeros((m_np.shape[0], vmax), np.int64)
    lut_valid = np.zeros((m_np.shape[0], vmax), np.float32)
    for o in range(m_np.shape[0]):
        v = np.nonzero(m_np[o])[0]
        lut[o, :v.size] = v
        lut_valid[o, :v.size] = 1.0
    buffers["verb_lut"] = torch.as_tensor(lut)
    buffers["verb_lut_valid"] = torch.as_tensor(lut_valid)
    return params, buffers


def apply_vis_tor(params, cfg: UPTConfig, vis_tor: float):
    """The eval-time logit-scale multiplier (--vis_tor,
    main_tip_finetune.py:895-897): a copy of the head's ``params`` (the
    ``upt`` dict) with logit_scale_HO and logit_scale_U times ``vis_tor``,
    outside autograd."""
    if vis_tor == 1.0:
        return params
    params = dict(params)
    with torch.no_grad():
        for k in ("logit_scale_HO", "logit_scale_U"):
            if k in params:
                params[k] = (params[k] * vis_tor).requires_grad_(
                    params[k].requires_grad)
    return params
