"""Train, evaluate or cache the HOI detector (port of
``hoigen_tpu/cli/main_finetune.py``), on one CUDA device::

  python -m hoigen_tpu_torch.cli.main_finetune --data-root ./datasets ...
  python -m hoigen_tpu_torch.cli.main_finetune --eval true --resume <ckpt> ...
  python -m hoigen_tpu_torch.cli.main_finetune --cache true ...

``main`` converts the CLIP, DETR and DINO checkpoints it is given (random
weights where a file is missing), builds the Tip-Adapter caches from the
pair-embedding pickle and the CLIP text tower, synthesises unseen-class
features through the prompted generators (``--generate-feature``), then
trains (checkpoints under ``--output-dir``), evaluates (HICO-DET mAP,
V-COCO role AP) or writes the official result files (``--cache``).

Differences from the JAX CLI:
- ``--resume`` takes the port's own ``torch.save`` checkpoints
  (``engine/checkpoint.py``, ``ckpt_<step>.pt``, or the directory holding
  them) or a reference ``.pt``/``.pth``; the JAX CLI's Orbax directories
  are not read (nor do they read the port's).
- A generator checkpoint that is missing is drawn from a generator seeded
  with ``--seed`` and the family's index (the JAX CLI salts it with
  Python's per-process ``hash``).
- Data parallelism is one process per card, as in the reference: set
  ``COORDINATOR_ADDRESS`` (host:port), ``NUM_PROCESSES`` and
  ``PROCESS_ID`` in each process (the JAX CLI's three variables), or
  give ``--devices N`` to one process, which starts N processes of one
  card each (``parallel/distributed.py::launch``); the JAX CLI puts N
  local devices in one process instead. NCCL joins processes on CUDA,
  gloo on the CPU. Process 0 alone writes files and prints.

:func:`batches_from_factory` and :func:`eval_batches` are the input and
evaluation loops; :func:`main` runs from a :class:`RunConfig`
(``parse_config``). ``main`` runs on CUDA unless it is given
``device="cpu"``. With ``--trace-dir`` the training or evaluation runs
under the program's tracer (:func:`traced`).
"""
import contextlib
import dataclasses
import json
import os
import random

import numpy as np
import torch

from ..data.factory import DataFactory, collate_batch, slice_batch
from ..data.loader import batch_indices, iter_batches
from ..engine import profiling
from ..engine.checkpoint import latest_checkpoint
from ..engine.cuda_graph import graphed
from ..engine.eval import cache_hico, cache_vcoco, evaluate_hico, \
    evaluate_vcoco
from ..engine.hoi_model import HOIModelConfig, full_f32, init_hoi_model, \
    make_eval_step, make_optimizer, make_train_step, resolve_device, \
    to_device
from ..engine.partition import mark_trainable
from ..engine.train import Trainer, load_trainable
from ..labels import HICO, VCOCO_LABELS
from ..models.cache import UPTCaches, build_gen_cache, build_pair_cache, \
    load_pair_annotations, random_caches, refresh_unseen_cache
from ..models.clip.config import CLIPConfig, clip_model
from ..models.clip.model import encode_text, init_clip_params
from ..models.clip.tokenizer import tokenize
from ..models.convert_upt import load_torch_file
from ..models.detr.config import DETRConfig
from ..models.proposals import ProposalConfig
from ..models.upt import UPTConfig, apply_vis_tor
from ..parallel import gather_pyobj, global_mesh, init_distributed, \
    launch, local_batch_indices, local_n_real, process_allgather_ragged, \
    process_count, process_index
from ..utils.config import RunConfig, parse_config


def data_factory(cfg: RunConfig, model_cfg: HOIModelConfig, partition,
                 training=False):
    """The run's ``DataFactory`` over ``partition``, its CLIP stream at the
    frame of the tower the model runs; a training one filters to the
    zero-shot split and draws from the run's seed."""
    train = dict(zero_shot=cfg.zs, zs_type=cfg.zs_type,
                 num_classes=cfg.num_classes, seed=cfg.seed) \
        if training else {}
    return DataFactory(cfg.dataset, partition, cfg.data_root,
                       training=training,
                       clip_resolution=model_cfg.upt.clip_resolution,
                       max_gt_pairs=cfg.max_gt_pairs,
                       host_clip_stream=cfg.host_clip_stream, **train)


def _other_clip(cfg: RunConfig, error):
    """The refusal of a CLIP checkpoint whose sizes are not ``--clip-model``'s
    (``models/clip/convert.py::check_shapes``), naming the flag and file."""
    return ValueError(f"--clip-model {cfg.clip_model}: "
                      f"{cfg.clip_model_path}: {error}")


def load_pretrained(cfg: RunConfig, model_cfg: HOIModelConfig, gen):
    """(clip, detr, dino) parameters on the CPU converted from the torch
    checkpoints that exist; None for each that is missing (random init
    follows). Missing adapters are drawn from the torch.Generator
    ``gen``."""
    clip_params = detr_params = dino_params = None
    if os.path.exists(cfg.clip_model_path):
        from ..models.clip.convert import torch_state_dict_to_params
        obj = load_torch_file(cfg.clip_model_path)
        sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
        try:
            clip_params, _ = torch_state_dict_to_params(
                dict(sd), cfg=model_cfg.clip,
                use_adapter=cfg.use_insadapter, adapter_pos=cfg.adapter_pos,
                adapter_num_layers=cfg.adapter_num_layers, gen=gen)
        except ValueError as e:
            raise _other_clip(cfg, e) from None
        print(f"[load] CLIP weights from {cfg.clip_model_path}")
    else:
        print(f"[warn] CLIP checkpoint missing ({cfg.clip_model_path}); "
              "random init")
    if os.path.exists(cfg.pretrained_detr):
        from ..models.detr.convert import torch_detr_state_dict_to_params
        ckpt = load_torch_file(cfg.pretrained_detr)
        sd = ckpt.get("model", ckpt.get("model_state_dict", ckpt))
        detr_params, _ = torch_detr_state_dict_to_params(sd, model_cfg.detr)
        print(f"[load] DETR weights from {cfg.pretrained_detr}")
    else:
        print(f"[warn] DETR checkpoint missing ({cfg.pretrained_detr}); "
              "random init")
    if cfg.dino and os.path.exists(cfg.dino_pretrained):
        from ..models.dino import torch_dino_state_dict_to_params
        ckpt = load_torch_file(cfg.dino_pretrained)
        sd = ckpt.get("teacher", ckpt)
        sd = {k.replace("module.", "").replace("backbone.", ""): v
              for k, v in sd.items()}
        dino_params = torch_dino_state_dict_to_params(sd)
        print(f"[load] DINO weights from {cfg.dino_pretrained}")
    return clip_params, detr_params, dino_params


PROMPT_TEMPLATES = [
    "a photo of a person {}.", "a video of a person {}.",
    "a example of a person {}.", "a demonstration of a person {}.",
    "a photo of the person {}.", "a video of the person {}.",
    "a example of the person {}.", "a demonstration of the person {}.",
]  # get_multi_prompts (upt...py:1667-1685)


def encode_class_texts(clip_params, clip_cfg, texts, chunk=256,
                       use_templates=False):
    """Frozen-CLIP class text embeddings as numpy, L2-normalised
    (get_origin_text_emb, upt...py:1687-1709), on the device of
    ``clip_params``, in full f32. With ``use_templates`` each class is the
    mean over the 8 person-action templates applied to its text after the
    5th word."""
    if use_templates:
        stripped = [" ".join(t.split(" ")[5:]) for t in texts]
        all_texts = [tmpl.format(s) for tmpl in PROMPT_TEMPLATES
                     for s in stripped]
    else:
        all_texts = list(texts)
    dev = clip_params["text"]["token_embedding"].device
    toks = torch.as_tensor(tokenize(all_texts), device=dev).long()
    with torch.no_grad(), full_f32():
        outs = [encode_text(clip_params, toks[lo:lo + chunk], clip_cfg)
                .cpu().numpy() for lo in range(0, len(toks), chunk)]
    emb = np.concatenate(outs, 0)
    if use_templates:
        emb = emb.reshape(len(PROMPT_TEMPLATES), len(texts), -1).mean(0)
    return emb / np.linalg.norm(emb, axis=-1, keepdims=True)


def hico_prior_multihot(num_classes, zs, evaluating, filtered,
                        zs_type=None):
    """Object class -> valid-verb multihot of the prior mask.

    Zero-shot training masks the priors to the seen classes
    (zs_object_to_target, utils_tip...py:144-152); evaluation and caching
    use the full test-set table (main_tip_finetune.py:868-872; the
    reference gates the swap on --eval only, and its --cache under
    zero-shot would drop every unseen detection, which this takes as an
    upstream oversight). The reference's rare_first quirk is kept: at 117
    classes RF-UC trains with the full prior (main_tip_finetune.py:680,
    upt_tip...py:821-824)."""
    rf_quirk = zs_type == "rare_first" and num_classes == 117
    if zs and not evaluating and not rf_quirk:
        return HICO.seen_object_class_multihot(num_classes, filtered)
    return HICO.object_class_multihot(num_classes)


def build_caches(cfg: RunConfig, clip_params, model_cfg, train_factory):
    """The pair cache from the pickle (``cfg.file1``) plus the text and
    object embeddings; the CLIP/DINO global caches from
    ``caches/dataset/*.npz`` (relative to the working directory) when
    present, random placeholders otherwise. -> (UPTCaches, pair cache)."""
    num_classes = cfg.num_classes
    filtered = HICO.unseen_index[cfg.zs_type] if cfg.zs else []

    if os.path.exists(cfg.file1):
        anno = load_pair_annotations(cfg.file1)
        # 117-verb mode counts annotations per verb (anno_action), 600 per
        # interaction (main_tip_finetune.py:860-862); the rare-based
        # label_choice policies read them
        if cfg.dataset != "hicodet":
            num_anno = None
        elif num_classes == 117:
            num_anno = train_factory.dataset.anno_action
        else:
            num_anno = train_factory.dataset.anno_interaction
        obj_to_verb = (train_factory.dataset.object_to_verb
                       if cfg.dataset == "hicodet"
                       else VCOCO_LABELS.object_to_verb)
        if cfg.zs and cfg.dataset == "hicodet":
            # cache construction always uses the zero-shot-filtered train
            # map (utils...py:144-152, upt...py:676-678), at eval too,
            # where only the prior table goes back to the full one
            fset = set(filtered)
            obj_to_verb = [[] for _ in range(len(obj_to_verb))]
            for hoi, obj, verb in HICO.class_corr:
                if hoi not in fset:
                    obj_to_verb[obj].append(verb)
        pair = build_pair_cache(
            anno, num_classes, cfg.num_shot,
            HICO.object_n_verb_to_interaction, obj_to_verb,
            filtered_hoi_idx=filtered, use_multi_hot=cfg.use_multi_hot,
            label_choice=cfg.label_choice, num_anno=num_anno, seed=cfg.seed,
            dim=model_cfg.clip.embed_dim)
        print(f"[cache] pair cache from {cfg.file1}")
    else:
        print(f"[warn] pair-embedding pkl missing ({cfg.file1}); random "
              "cache")
        rc = random_caches(num_classes, cfg.num_shot,
                           dim=model_cfg.clip.embed_dim)
        pair = type("P", (), dict(cache_h=rc.cache_h, cache_o=rc.cache_o,
                                  cache_u=rc.cache_u, one_hots=rc.one_hots,
                                  sample_lens=rc.sample_lens,
                                  counts=np.full(num_classes,
                                                 cfg.num_shot)))()

    if num_classes == 117:
        classnames = HICO.verbs_sentence
    elif num_classes == 600:
        classnames = HICO.hoi_prompts
    else:
        classnames = VCOCO_LABELS.verbs_sentence
    obj_texts = [t for _, t in HICO.obj_text_label]
    origin_text = encode_class_texts(clip_params, model_cfg.clip, classnames,
                                     use_templates=cfg.use_templates)
    object_embedding = encode_class_texts(clip_params, model_cfg.clip,
                                          obj_texts)

    cache_dir = os.path.join("caches", "dataset")
    os.makedirs(cache_dir, exist_ok=True)
    tag = f"{cfg.zs_type}_{cfg.num_shot}" if cfg.zs else "2shots"
    npz = os.path.join(
        cache_dir, f"{cfg.dataset}_{num_classes}_global_{tag}.npz")
    loaded = False
    if os.path.exists(npz) and cfg.clip_load_cache:
        g = np.load(npz)
        clip_keys, dino_keys = g["clip_keys"], g["dino_keys"]
        # values saved beside the keys; an older npz holds keys only, and
        # the runtime then takes the pair one_hots
        clip_values = g["clip_values"] if "clip_values" in g else None
        dino_values = g["dino_values"] if "dino_values" in g else None
        if clip_keys.shape[1] != num_classes * cfg.num_shot:
            print(f"[warn] {npz} was built for a different class/shot "
                  f"layout ({clip_keys.shape[1]} rows, expected "
                  f"{num_classes * cfg.num_shot}); ignoring it")
        else:
            loaded = True
            print(f"[cache] global caches from {npz}")
    if not loaded:
        rc = random_caches(num_classes, cfg.num_shot, seed=cfg.seed,
                           dim=model_cfg.clip.embed_dim)
        clip_keys, dino_keys = rc.clip_global_keys, rc.dino_keys
        clip_values, dino_values = rc.clip_global_values, rc.dino_values
        print("[warn] global caches not found; random placeholders")

    if cfg.dataset == "hicodet":
        multihot = hico_prior_multihot(num_classes, cfg.zs,
                                       cfg.eval or cfg.cache, filtered,
                                       zs_type=cfg.zs_type)
    else:
        # V-COCO object ids are 1-based (0 = background), the detector's
        # labels 0-based person first: drop row 0 so that multihot[label]
        # is the label's object class
        if num_classes == 24:
            # the annotations' valid-action table, as the reference
            # (object_to_action, vcoco/vcoco.py:153-160)
            m = np.zeros((81, num_classes), np.float32)
            for o, acts in train_factory.dataset.object_to_action.items():
                m[o, acts] = 1.0
        else:
            m = VCOCO_LABELS.object_class_multihot(num_classes)
        multihot = m[1:]
    return UPTCaches(
        cache_h=pair.cache_h, cache_o=pair.cache_o, cache_u=pair.cache_u,
        one_hots=pair.one_hots, sample_lens=pair.sample_lens,
        clip_global_keys=clip_keys, dino_keys=dino_keys,
        clip_global_values=clip_values, dino_values=dino_values,
        object_class_multihot=multihot,
        object_embedding=object_embedding,
        origin_text_embeddings=origin_text), pair


def maybe_gen_features(cfg: RunConfig, clip_params, model_cfg, pair):
    """Synthesise unseen-class features through the three prompted
    generators (main_tip_finetune.py:607-824), on the device of
    ``clip_params`` in full f32, and build the generated cache from them.
    -> (gen cache, (features, targets, verbs)), or (None, None) without
    ``cfg.generate_feature``. A family whose checkpoint is missing from
    ``cfg.gen_ckpt_dir`` is drawn from a torch.Generator seeded with
    ``cfg.seed`` and the family's index."""
    if not cfg.generate_feature:
        return None, None
    from ..models import generator as G
    dev = clip_params["text"]["token_embedding"].device
    emb = clip_params["text"]["token_embedding"]
    if cfg.dataset == "hicodet":
        names = {"hoi": HICO.all_classnames, "human": HICO.human_name,
                 "object": HICO.object_name}
        hoi_to_obj, hoi_to_verb = HICO.hoi_to_object, HICO.hoi_to_verb
        num_hoi = 600
    else:
        names = {"hoi": [f"{v} {o}" for v, o in VCOCO_LABELS.values],
                 "human": VCOCO_LABELS.human_name,
                 "object": VCOCO_LABELS.object_name}
        hoi_to_obj = VCOCO_LABELS.hoi_to_object
        hoi_to_verb = VCOCO_LABELS.hoi_to_verb
        num_hoi = 236
    ck = os.path.join(cfg.gen_ckpt_dir, cfg.dataset)

    def load(name):
        return torch.load(os.path.join(ck, name), map_location="cpu",
                          weights_only=True)

    fams = {}
    for fi, fam in enumerate(("hoi", "human", "object")):
        n_ctx = 5 if fam == "hoi" else 4
        if os.path.exists(os.path.join(ck, f"{fam}_netg_50.pth")):
            gen_p = G.torch_generator_state_to_params(
                load(f"{fam}_netg_50.pth"))
            ctx = G.torch_prompt_ctx_to_params(
                load(f"{fam}_prompt_learner_50.pth"))
            mlp = G.torch_ship_mlp_state_to_params(load(f"{fam}_mlp_50.pth")) \
                if os.path.exists(os.path.join(ck, f"{fam}_mlp_50.pth")) \
                else None
        else:
            g = torch.Generator().manual_seed(
                cfg.seed * 1_000_003 + 1_000 + fi)
            gen_p = G.init_generator_params(g, model_cfg.clip.embed_dim)
            ctx = G.init_prompt_ctx(g, n_ctx,
                                    model_cfg.clip.transformer_width)
            mlp = None
            print(f"[warn] generator ckpt missing for {fam}; random init")
        fams[fam] = G.GeneratorFamily(
            to_device(gen_p, dev), ctx.to(dev),
            G.build_prompt_tables(names[fam], emb, ctx.shape[0]),
            to_device(mlp, dev))
    with full_f32():
        gf, gt, gv = G.synthesize_features(
            fams, clip_params, model_cfg.clip, hoi_to_obj, hoi_to_verb,
            num_hoi, n_rounds=cfg.gen_rounds, seed=cfg.seed)
    hoi_to_class = (hoi_to_verb if cfg.num_classes in (117, 24)
                    else np.arange(num_hoi))
    gen_cache = build_gen_cache(gf, gt, hoi_to_class, cfg.num_classes,
                                cfg.num_shot, counts=pair.counts,
                                seed=cfg.seed)
    return gen_cache, (gf, gt, gv)


def make_model_config(cfg: RunConfig, device=None) -> HOIModelConfig:
    """The model configuration of a run: the CLIP tower ``--clip-model``
    names (``models/clip/config.py::CLIP_MODELS``), whose resolution and
    embedding the UPT head takes. ``use_pallas_cache`` None turns the
    fused cache scoring on where the run's device (None: CUDA) is a CUDA
    device, as the JAX CLI turns it on on a TPU."""
    num_detr_classes = 81 if cfg.dataset == "hicodet" else 92
    use_pallas_cache = (
        torch.device("cuda" if device is None else device).type == "cuda"
        if cfg.use_pallas_cache is None else cfg.use_pallas_cache)
    tower = clip_model(cfg.clip_model)
    if cfg.use_insadapter:
        # adapter placement and depth (--adapter_pos, --adapter_num_layers,
        # CLIP_models_adapter_prior2.py:958-967) over the tower's blocks;
        # 'random' draws from the run's seed
        clip_cfg = dataclasses.replace(
            tower, adapter_layers=CLIPConfig.adapter_layer_ids(
                cfg.adapter_pos, tower.vision_layers,
                rng=random.Random(cfg.seed)),
            adapter_num_layers=cfg.adapter_num_layers)
    else:
        clip_cfg = dataclasses.replace(tower, use_adapter=False)
    return HOIModelConfig(
        clip=clip_cfg,
        detr=DETRConfig(num_classes=num_detr_classes),
        upt=UPTConfig(
            num_classes=cfg.num_classes, num_shot=cfg.num_shot,
            alpha=cfg.alpha, gamma=cfg.gamma,
            fg_iou_thresh=cfg.fg_iou_thresh, hyper_lambda=cfg.hyper_lambda,
            logits_type=cfg.logits_type, cache_model=cfg.cache_model,
            use_clip_global=cfg.clip_global, use_dino=cfg.dino,
            use_weight_pred=cfg.use_weight_pred,
            use_insadapter=cfg.use_insadapter, prior_type=cfg.prior_type,
            use_mlp_proj=cfg.use_mlp_proj, obj_affordance=cfg.obj_affordance,
            prior_method=cfg.prior_method, vis_prompt_num=cfg.vis_prompt_num,
            use_consistloss=cfg.use_consistloss, tpt=cfg.tpt,
            LA=cfg.LA, LA_weight=cfg.LA_weight,
            feat_mask_type=cfg.feat_mask_type,
            use_pallas_cache=use_pallas_cache,
            global_values_mode=cfg.global_values_mode,
            proposals=ProposalConfig(
                human_idx=cfg.human_idx,
                box_score_thresh=cfg.box_score_thresh,
                min_instances=cfg.min_instances,
                max_instances=cfg.max_instances),
            max_gt_pairs=cfg.max_gt_pairs,
            generate_feature=cfg.generate_feature and not cfg.eval
            and not cfg.cache,
            clip_resolution=clip_cfg.image_resolution,
            visual_output_dim=clip_cfg.embed_dim),
        dtype=cfg.dtype)


def batches_from_factory(factory, batch_size, cfg: RunConfig, shuffle=True,
                         seed=0, pad_tail=False):
    """Yield (feed dict of numpy arrays, Batch) through the threaded input
    pipeline (``data/loader.py``). With ``pad_tail`` the final short batch
    is padded to ``batch_size`` by repeating its last sample, and
    ``Batch.n_real`` records the true length. The feed stays on the host:
    the eval and training steps move it to the card, so no worker thread
    touches CUDA.

    With several processes ``batch_size`` is the global batch: every
    process walks the same global stream and loads only its rows
    (``parallel/distributed.py::local_batch_indices``), padded to the
    global batch's image shape (``factory.padded_hw`` replays each row's
    transform from its size alone), so that the rows equal the
    single-process batch's; ``n_real`` counts this process's real rows."""
    multi = process_count() > 1

    def collate(samples, pad_hw=None):
        batch = collate_batch(samples, cfg.max_gt_pairs, pad_hw=pad_hw)
        # 600-class training associates pairs against interaction ids, not
        # verbs (reference targets['hoi'], upt_tip...py:1292-1293)
        cls_ids = batch.hoi if cfg.num_classes == 600 else batch.labels
        # uint8 pixels + (h, w) sizes: ~4x less host-to-card traffic than
        # normalized float + bool mask; the card rebuilds both (ops/pixels)
        d = {"images": batch.images, "image_sizes": batch.image_sizes,
             "clip_sizes": batch.clip_sizes,
             "boxes_h": batch.boxes_h, "boxes_o": batch.boxes_o,
             "labels": cls_ids, "gt_valid": batch.gt_valid}
        if batch.images_clip is not None:     # host 224 stream (opt-in)
            d["images_clip"] = batch.images_clip
        return d, batch

    if multi:
        idx_batches = [
            (lidx, n_real, {"pad_hw": factory.padded_hw(gidx)})
            for gidx, lidx, n_real in local_batch_indices(
                len(factory), batch_size, shuffle, seed, pad_tail=pad_tail,
                return_global=True)]
    else:
        idx_batches = batch_indices(len(factory), batch_size, shuffle, seed,
                                    pad_tail=pad_tail)
    for (d, batch), n_real in iter_batches(
            factory.__getitem__, idx_batches, collate,
            num_workers=cfg.num_workers):
        batch.n_real = local_n_real(n_real, batch_size) if multi else n_real
        yield d, batch


def eval_batches(eval_step, params, buffers, factory, cfg: RunConfig):
    """Yield (outputs as numpy, sliced to the batch's real rows;
    ``slice_batch(batch, n_real)``) for every batch of ``factory`` in
    order, tail padded to ``cfg.batch_size``: the ``run_batches`` loop of
    the JAX ``main``, with its one batch of lookahead (batch N is yielded
    after step N + 1 has run). Each step's outputs are copied to the host
    (a sync) before the next step is dispatched, as the JAX loop does, so
    the lookahead delays the yield but overlaps no card work with the
    caller's host AP. ``eval_step`` is
    ``engine/hoi_model.py::make_eval_step``'s, on the card through
    ``engine/cuda_graph.py::graphed``. The padded rows never reach
    the caller, so ``evaluate_hico`` counts each image once."""
    prev = None
    for d, batch in batches_from_factory(factory, cfg.batch_size, cfg,
                                         shuffle=False, pad_tail=True):
        out = eval_step(params, buffers, d)
        out = {k: v[:batch.n_real].cpu().numpy() for k, v in out.items()}
        if prev is not None:
            yield prev
        prev = out, slice_batch(batch, batch.n_real)
    if prev is not None:
        yield prev


def _import_reference(cfg, model_cfg, params, buffers, pair, dev):
    """``--resume`` of a reference torch checkpoint: the towers and the
    UPT head through the converters (``models/convert_upt.py``). ->
    (params, buffers) on ``dev``, trainable leaves marked again."""
    from ..models.clip.convert import check_shapes, infer_config
    from ..models.convert_upt import load_reference_checkpoint
    clip_base_sd = None
    if cfg.clip_model_path and os.path.exists(cfg.clip_model_path):
        obj = load_torch_file(cfg.clip_model_path)
        clip_base_sd = obj.state_dict() if hasattr(obj, "state_dict") \
            else obj
        try:
            check_shapes(infer_config(clip_base_sd), model_cfg.clip)
        except ValueError as e:
            raise _other_clip(cfg, e) from None
    upt, buffers, detr_p, dino_p = load_reference_checkpoint(
        cfg.resume, dict(params["upt"]), dict(buffers), pair.counts,
        cfg.num_shot, cfg.cache_model, clip_base_sd=clip_base_sd,
        adapter_pos=cfg.adapter_pos,
        adapter_num_layers=cfg.adapter_num_layers)
    params = {"upt": upt,
              "detr": detr_p if detr_p is not None else params["detr"],
              "dino": dino_p if dino_p is not None else params["dino"]}
    return mark_trainable(to_device(params, dev)), to_device(buffers, dev)


@contextlib.contextmanager
def traced(cfg: RunConfig, dev, primary=True):
    """With ``cfg.trace_dir`` (on process 0): the block under the program's
    tracer (``engine/profiling.py``; device ranges on a CUDA ``dev``),
    then ``program_trace.json`` (a Chrome trace of its spans, device
    ranges and idle gaps) and ``program_trace_summary.json`` (their
    snapshot, which names the CLIP tower) written under it. A graph
    captured before the block holds no device ranges."""
    if not (cfg.trace_dir and primary):
        yield
        return
    profiling.reset()
    profiling.enable(dev)
    # the tower --clip-model names, over this process's share of a batch
    tower = clip_model(cfg.clip_model)
    profiling.tower(cfg.clip_model, tower.vision_layers,
                    cfg.batch_size // process_count()
                    * (tower.grid_size ** 2 + 1))
    try:
        yield
        os.makedirs(cfg.trace_dir, exist_ok=True)
        profiling.write(os.path.join(cfg.trace_dir, "program_trace.json"))
        with open(os.path.join(cfg.trace_dir,
                               "program_trace_summary.json"), "w") as f:
            json.dump(profiling.snapshot(), f, indent=1)
    finally:
        profiling.disable()


def main(cfg: RunConfig, device=None):
    """Train (returns the Trainer), evaluate (returns the HICO-DET result
    dict or the V-COCO report) or cache (returns None) as ``cfg`` says, on
    ``device`` (None: CUDA; raises without a card).

    A multi-process run joins its process group first (no-op unless
    ``COORDINATOR_ADDRESS``, ``NUM_PROCESSES`` and ``PROCESS_ID`` are
    set). Otherwise ``--devices N`` above 1 (None: every visible card; 1
    on the CPU) starts N processes of one card each and returns process
    0's result, a Trainer as a dict of its epoch, iteration and last
    losses. Only process 0 prints."""
    dev = resolve_device(device)
    multi = init_distributed(device=dev)
    if not multi:
        n = cfg.devices if cfg.devices is not None else (
            torch.cuda.device_count() if dev.type == "cuda" else 1)
        if n > 1:
            return launch(_main_in_process, n, cfg, device, device=dev)
    if process_index() == 0:
        return _main(cfg, dev, multi)
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        return _main(cfg, dev, multi)


def _main_in_process(cfg, device):
    """One process of a ``--devices N`` run; a Trainer comes back as a
    picklable summary."""
    out = main(cfg, device)
    if isinstance(out, Trainer):
        return {"epoch": out.epoch, "iteration": out.iteration,
                "losses": list(out._losses)}
    return out


def _main(cfg: RunConfig, dev, multi):
    np.random.seed(cfg.seed)
    gen = torch.Generator().manual_seed(cfg.seed)
    model_cfg = make_model_config(cfg, dev)
    primary = process_index() == 0
    os.makedirs(cfg.output_dir, exist_ok=True)
    if primary:
        cfg.save(os.path.join(cfg.output_dir, "args.json"))

    if cfg.dataset == "hicodet":
        cfg.partitions = ["train2015", "test2015"]
    else:
        cfg.partitions = ["trainval", "test"]
    train_factory = data_factory(cfg, model_cfg, cfg.partitions[0],
                                 training=True)
    if cfg.training_set_ratio < 0.9:
        # random-subset training (main_tip_finetune.py:368-372), permuted
        # from cfg.seed
        perm = np.random.default_rng(cfg.seed).permutation(
            len(train_factory.keep))
        n = int(len(perm) * cfg.training_set_ratio)
        train_factory.keep = [train_factory.keep[i] for i in perm[:n]]
        print(f"[INFO] using {cfg.training_set_ratio} of the train set "
              f"({n} images)")
    test_factory = data_factory(cfg, model_cfg, cfg.partitions[1])

    clip_params, detr_params, dino_params = load_pretrained(
        cfg, model_cfg, gen)
    if clip_params is None:
        clip_params = init_clip_params(gen, model_cfg.clip, text=True)
    clip_params = to_device(clip_params, dev)

    caches, pair = build_caches(cfg, clip_params, model_cfg, train_factory)
    gen_cache, _ = maybe_gen_features(cfg, clip_params, model_cfg, pair)
    if gen_cache is not None and cfg.cache_model == "gen_feat":
        caches.cache_h, caches.cache_o, caches.cache_u = \
            gen_cache.cache_h, gen_cache.cache_o, gen_cache.cache_u
        caches.one_hots, caches.sample_lens = gen_cache.one_hots, \
            gen_cache.sample_lens
    elif gen_cache is not None and cfg.cache_model == "cache_feat":
        caches.cache_h = (caches.cache_h + gen_cache.cache_h) / 2
        caches.cache_o = (caches.cache_o + gen_cache.cache_o) / 2
        caches.cache_u = (caches.cache_u + gen_cache.cache_u) / 2

    if cfg.zs and cfg.fill_zs_verb_type == 1:
        # unseen classes' cache rows blended from the seen ones by text
        # similarity (refresh_unseen_verb_cache_mem, upt...py:609-633)
        unseen = HICO.unseen_index[cfg.zs_type]
        seen = [i for i in range(cfg.num_classes) if i not in set(unseen)]
        for attr in ("cache_h", "cache_o", "cache_u"):
            setattr(caches, attr, refresh_unseen_cache(
                getattr(caches, attr), pair.counts,
                caches.origin_text_embeddings, seen, unseen, cfg.num_shot))

    params, buffers = init_hoi_model(
        gen, model_cfg, caches, clip_params=clip_params,
        detr_params=detr_params, dino_params=dino_params, device=dev)

    base = os.path.basename(os.path.normpath(cfg.resume)) if cfg.resume \
        else ""
    if cfg.resume.endswith((".pt", ".pth")) and os.path.isfile(cfg.resume) \
            and not base.startswith("ckpt_"):
        params, buffers = _import_reference(cfg, model_cfg, params, buffers,
                                            pair, dev)
        print(f"[load] imported reference torch checkpoint {cfg.resume}")
        cfg.resume = ""           # the port's own resume below is bypassed

    if cfg.frozen_classifier:
        # freeze cache-adapter branches (--frozen_classifier,
        # main_tip_finetune.py:964-977): 'HO' the concatenated-pair cache,
        # 'U' the union cache, 'T' the text branch; a frozen leaf leaves the
        # optimizer, as requires_grad=False does in the reference
        names = []
        if "HO" in cfg.frozen_classifier:
            names += ["adapter_HO_w", "adapter_HO_b"]
        if "U" in cfg.frozen_classifier:
            names += ["adapter_U_w", "adapter_U_b"]
        if "T" in cfg.frozen_classifier:
            names += ["text_w"]
        for n in names:
            if params["upt"].get(n) is not None:
                params["upt"][n].requires_grad_(False)
        print(f"[freeze] classifier branches: {names}")

    resume_path = None
    if cfg.resume:
        resume_path = cfg.resume if base.startswith("ckpt_") \
            else latest_checkpoint(cfg.resume)
    if resume_path and (cfg.eval or cfg.cache or cfg.sanity):
        # eval and cache need the weights only; training resumes the full
        # state (optimizer, iteration, epoch) through Trainer.restore below
        load_trainable(params, resume_path)
        print(f"[load] resumed trainable params from {resume_path}")

    if cfg.vis_tor != 1.0 and (cfg.eval or cfg.cache):
        params = dict(params, upt=apply_vis_tor(params["upt"], model_cfg.upt,
                                                cfg.vis_tor))

    if cfg.sanity:
        # one sample end to end (sanity_check, main_tip_finetune.py:
        # 1034-1044)
        opt = make_optimizer()(params)
        step = make_train_step(model_cfg, opt, dev)
        batches = batches_from_factory(train_factory, 1, cfg)
        d, _ = next(batches)
        batches.close()
        metrics = step(params, buffers, d,
                       torch.Generator(device=dev).manual_seed(cfg.seed))
        print(f"[sanity] one step ok: loss={float(metrics['loss']):.4f} "
              f"n_p={float(metrics['n_p'])}")
        return metrics

    if cfg.eval or cfg.cache:
        with traced(cfg, dev, primary):
            # one CUDA graph per batch shape, as the JAX CLI jits the step
            runs = eval_batches(graphed(make_eval_step(model_cfg, dev)),
                                params, buffers, test_factory, cfg)
            # several processes score their rows and merge the ragged
            # per-image results (process 0 writes the files)
            gather = gather_pyobj if multi else None
            if cfg.cache:
                if cfg.dataset == "hicodet":
                    cache_hico(runs, test_factory.dataset,
                               model_cfg.upt.proposals,
                               HICO.object_n_verb_to_interaction,
                               HICO.object_to_interaction, cfg.num_classes,
                               cfg.output_dir, gather_fn=gather,
                               is_primary=primary)
                else:
                    cache_vcoco(runs, test_factory.dataset,
                                model_cfg.upt.proposals, cfg.output_dir,
                                gather_fn=gather, is_primary=primary)
                return None
            if cfg.dataset == "vcoco":
                # beyond the reference, which defers to the official toolkit
                # (main_tip_finetune.py:912): the vsrl role AP in-repo
                report = evaluate_vcoco(runs, test_factory.dataset,
                                        model_cfg.upt.proposals,
                                        gather_fn=gather, is_primary=primary)
                for k in ("role_ap_scenario_1", "role_ap_scenario_2",
                          "agent_ap"):
                    print(f"{k}: mean AP {report[k]['mean'] * 100:.2f}")
                return report
            result = evaluate_hico(
                runs, test_factory.dataset, cfg.num_classes,
                model_cfg.upt.proposals, HICO.object_n_verb_to_interaction,
                zs_unseen=HICO.unseen_index[cfg.zs_type] if cfg.zs else None,
                gather_fn=process_allgather_ragged if multi else None,
                ap_workers=cfg.num_workers,
                train_anno_interaction=train_factory.dataset.anno_interaction)
            print(f"The mAP is {result['mAP'] * 100:.2f}, "
                  f"rare: {result['mAP_rare'] * 100:.2f}, "
                  f"none-rare: {result['mAP_non_rare'] * 100:.2f}")
            if cfg.zs:
                print(f"zero-shot({cfg.zs_type}) "
                      f"unseen: {result['mAP_unseen'] * 100:.2f} "
                      f"seen: {result['mAP_seen'] * 100:.2f}")
            return result

    # training
    # the data axis spans the processes (any process group, even of one)
    mesh = global_mesh() if torch.distributed.is_initialized() else None
    steps_per_epoch = max(len(train_factory) // cfg.batch_size, 1)
    optimizer = make_optimizer(cfg.lr_vit, cfg.lr_head, cfg.weight_decay,
                               cfg.lr_drop * steps_per_epoch,
                               cfg.clip_max_norm, mesh=mesh)(params)
    trainer = Trainer(make_train_step(model_cfg, optimizer, dev, mesh=mesh),
                      optimizer, params, buffers,
                      print_interval=cfg.print_interval,
                      output_dir=cfg.output_dir,
                      data_rank=mesh.data_index if mesh else 0)
    if resume_path:
        trainer.restore(resume_path)
        print(f"[load] resumed full training state from {resume_path} "
              f"(epoch {trainer.epoch}, iteration {trainer.iteration})")
    with traced(cfg, dev, primary):
        for epoch in range(trainer.epoch, cfg.epochs):
            train_factory.set_epoch(epoch)
            avg = trainer.run_epoch(
                (d for d, _ in batches_from_factory(
                    train_factory, cfg.batch_size, cfg,
                    seed=cfg.seed + epoch)),
                seed=cfg.seed + epoch)
            print(f"[epoch {epoch + 1}/{cfg.epochs}] loss {avg:.4f}")
    return trainer


if __name__ == "__main__":
    main(parse_config())
