"""Import a trained reference HOIGen checkpoint (port of
``hoigen_tpu/models/convert_upt.py``).

The reference saves engine checkpoints whose ``model_state_dict`` is the
whole UPT module: frozen ``detector.*`` (DETR) and ``dino_model.*``
towers, the adapted ``clip_head.*`` (CustomCLIP: image_encoder ==
clip.visual plus a TextEncoder view of the text stack), and the UPT head's
tensors (cache adapters, logit scales, prior MLP, text-adapter rows).

This module splits such a state dict and moves each piece into the port's
parameter trees, as torch tensors on the CPU. The head tensors are in the
reference's ragged per-class cache layout (class c holds ``counts[c] <=
num_shot`` rows, concatenated); ``pad_ragged_rows`` scatters them into the
zero-padded (C * num_shot, ...) layout, which scores the same (padding
rows carry zero labels; see models/cache.py).
"""
import numpy as np
import torch


def split_reference_upt_state(sd):
    """state_dict -> (detr_sd, clip_head_sd, dino_sd, head_sd), with any
    DDP 'module.' prefix stripped."""
    detr, clip_head, dino, head = {}, {}, {}, {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k.startswith("detector."):
            detr[k[len("detector."):]] = v
        elif k.startswith("clip_head."):
            clip_head[k[len("clip_head."):]] = v
        elif k.startswith("dino_model."):
            dino[k[len("dino_model."):]] = v
        else:
            head[k] = v
    return detr, clip_head, dino, head


def clip_head_to_clip_state(clip_head_sd, base_sd=None):
    """CustomCLIP keys -> plain CLIP keys for clip.convert.

    ``image_encoder.*`` -> ``visual.*``; ``text_encoder.*`` drops its
    prefix (TextEncoder holds views of transformer/positional_embedding/
    ln_final/text_projection). CustomCLIP carries no token_embedding —
    supply ``base_sd`` (the original CLIP checkpoint state dict) to fill
    it and any other missing key. prompt_learner.* tensors are returned
    separately (second value) for the CoOp path.
    """
    out, prompt = {}, {}
    for k, v in clip_head_sd.items():
        if k.startswith("image_encoder."):
            out["visual." + k[len("image_encoder."):]] = v
        elif k.startswith("text_encoder."):
            out[k[len("text_encoder."):]] = v
        elif k.startswith("prompt_learner."):
            prompt[k[len("prompt_learner."):]] = v
        else:                         # logit_scale
            out[k] = v
    if base_sd is not None:
        for k, v in base_sd.items():
            out.setdefault(k, v)
    return out, prompt


def pad_ragged_rows(ref, counts, num_shot):
    """Scatter ragged per-class rows into the zero-padded static layout:
    rows of class c land at [c*num_shot : c*num_shot + counts[c]]."""
    ref = np.asarray(ref, np.float32)
    if ref.ndim == 1:
        return pad_ragged_rows(ref[:, None], counts, num_shot)[:, 0]
    out = np.zeros((len(counts) * num_shot, ref.shape[1]), np.float32)
    lo = 0
    for c, n in enumerate(counts):
        out[c * num_shot:c * num_shot + int(n)] = ref[lo:lo + int(n)]
        lo += int(n)
    assert lo == len(ref), (lo, len(ref), "counts do not match cache rows")
    return out


def _t(a):
    return torch.as_tensor(np.array(a, np.float32, order="C"))


def reference_head_to_params(head_sd, counts, num_shot, cache_model,
                             params, buffers=None):
    """Transplant the UPT head's tensors into ``params`` (the ``upt``
    dict; in place, and returned), and the cache label matrices into
    ``buffers`` where given.

    head_sd: the non-tower part of the reference state dict (tensors or
    numpy). counts: the real rows of each class of the pair cache (from
    ``models.cache.build_pair_cache`` / ``build_gen_cache``). The names
    follow upt_tip_cache_model_free_finetune_distill3.py:474-516 (cache
    adapters), :514 (adapter_union_weight), :520-533 (prior MLP), :540-556
    (global and DINO caches)."""
    sd = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
          else np.asarray(v) for k, v in head_sd.items()}
    pad = lambda a: pad_ragged_rows(a, counts, num_shot)  # noqa: E731

    if "priors_downproj.layers.0.weight" in sd:
        params["priors_downproj"] = [
            {"w": _t(sd[f"priors_downproj.layers.{i}.weight"]),
             "b": _t(sd[f"priors_downproj.layers.{i}.bias"])}
            for i in range(3)]
    if "adapter_union_weight" in sd:
        params["text_w"] = _t(sd["adapter_union_weight"])
    if "logit_scale_text" in sd:
        params["logit_scale_T"] = _t(sd["logit_scale_text"])

    if cache_model == "cache_feat":
        names = {"HO": "adapter_HO", "U": "adapter_U"}
        scales = {"HO": "logit_scale_HO", "U": "logit_scale_U"}
    else:
        names = {f: f"gen_adapter_{f}" for f in "HOU"}
        scales = {f: f"gen_logit_scale_{f}" for f in "HOU"}
    for fam, ref_name in names.items():
        if f"{ref_name}_weight" in sd:
            params[f"adapter_{fam}_w"] = _t(pad(sd[f"{ref_name}_weight"]))
            params[f"adapter_{fam}_b"] = _t(pad(sd[f"{ref_name}_bias"]))
        if scales[fam] in sd:
            params[f"logit_scale_{fam}"] = _t(sd[scales[fam]])

    for stem in ("global_cache", "dino_cache"):
        if stem in sd:
            params[stem] = _t(pad(sd[stem].T).T)
            params[f"{stem}_bias"] = _t(pad(sd[f"{stem}_bias"]))
    if "clip_cache_logit" in sd:
        params["clip_cache_logit"] = _t(sd["clip_cache_logit"])
    if "dino_cache_logit" in sd:
        params["dino_cache_logit"] = _t(sd["dino_cache_logit"])

    # optional branches (upt_tip...py:525,595-604): learnable prior
    # (prior_method 2), Weight_Pred, mlp_proj, obj-affordance attention
    if "learnable_prior" in sd:
        params["learnable_prior"] = _t(sd["learnable_prior"])
    for ref_stem, ours, n in (("weight_pred.linear1", "weight_pred_1", 2),
                              ("weight_pred.linear2", "weight_pred_2", 2),
                              ("mlp_proj", "mlp_proj", 3)):
        if f"{ref_stem}.layers.0.weight" in sd:
            params[ours] = [
                {"w": _t(sd[f"{ref_stem}.layers.{i}.weight"]),
                 "b": _t(sd[f"{ref_stem}.layers.{i}.bias"])}
                for i in range(n)]
    if "obj_affordance_query" in sd:
        params["obj_affordance_query"] = _t(sd["obj_affordance_query"])
        params["obj_affordance_attn"] = {
            "w_qkv": _t(sd["obj_affordance_learner.in_proj_weight"]),
            "b_qkv": _t(sd["obj_affordance_learner.in_proj_bias"]),
            "w_out": _t(sd["obj_affordance_learner.out_proj.weight"]),
            "b_out": _t(sd["obj_affordance_learner.out_proj.bias"]),
        }

    if buffers is not None:
        # the cache value matrices (multi-hot labels) travel with the file
        label_keys = ({"one_hots_HO": "label_HO", "one_hots_U": "label_U"}
                      if cache_model == "cache_feat" else
                      {"one_hots_H": "gen_label_H",
                       "one_hots_O": "gen_label_O",
                       "one_hots_U": "gen_label_U"})
        for ours, ref_name in label_keys.items():
            if ref_name in sd:
                oh = pad(sd[ref_name])
                buffers[ours] = _t(oh)
                buffers[f"sample_lens{ours[len('one_hots'):]}"] = \
                    _t(np.maximum(oh.sum(0), 1e-8))
    return params


def load_torch_file(path):
    """``torch.load`` of a reference checkpoint on the CPU. Reference
    files hold pickled objects (a whole CLIP model, argparse namespaces),
    so this loads with ``weights_only=False``: use it only on files the
    user names as reference checkpoints."""
    return torch.load(path, map_location="cpu", weights_only=False)


def load_reference_checkpoint(path, params, buffers, counts, num_shot,
                              cache_model, clip_base_sd=None,
                              use_adapter=True, adapter_pos="all",
                              adapter_num_layers=1):
    """Load a reference engine checkpoint (.pt) end to end: the towers
    through their converters, the head's tensors through
    :func:`reference_head_to_params`. ``params``: the ``upt`` dict.
    Returns (params, buffers, detr_params, dino_params), the tower trees
    None where the checkpoint lacks them; new tensors are on the CPU."""
    from .clip.convert import torch_state_dict_to_params
    from .detr.convert import torch_detr_state_dict_to_params
    from .dino import torch_dino_state_dict_to_params

    ckpt = load_torch_file(path)
    sd = ckpt.get("model_state_dict", ckpt.get("model", ckpt))
    detr_sd, clip_head_sd, dino_sd, head_sd = split_reference_upt_state(sd)

    detr_params = dino_params = None
    if detr_sd:
        detr_params, _ = torch_detr_state_dict_to_params(detr_sd)
    if dino_sd:
        dino_params = torch_dino_state_dict_to_params(dino_sd)
    if clip_head_sd:
        clip_sd, _ = clip_head_to_clip_state(clip_head_sd, clip_base_sd)
        if "token_embedding.weight" not in clip_sd:
            raise ValueError(
                "checkpoint's CustomCLIP carries no token_embedding; pass "
                "clip_base_sd (the original CLIP checkpoint) to complete "
                "the text stack")
        params["clip"], _ = torch_state_dict_to_params(
            clip_sd, use_adapter=use_adapter, adapter_pos=adapter_pos,
            adapter_num_layers=adapter_num_layers)
    reference_head_to_params(head_sd, counts, num_shot, cache_model,
                             params, buffers)
    return params, buffers, detr_params, dino_params
