"""Tip-Adapter caches: their containers and their construction (port of
``hoigen_tpu/models/cache.py``, the same host numpy in the same order, so
that a seed gives the same arrays bit for bit).

Every class occupies exactly ``num_shot`` rows, zero-padded; padding rows
carry all-zero label vectors, so affinity @ labels / sample_lens equals the
reference's ragged layout. The pair-embedding pickle stores, per image, the
CLIP features of every annotated human/object/union crop plus boxes and
class ids, under the reference artifact's ``huamn_features`` key typo.
"""
import dataclasses
import pickle
from typing import List, Optional, Sequence

import numpy as np

from ..eval.association import box_iou
from .clip.config import VIT_B16

# the rows' width where nothing else gives it: the CLIP embedding of the
# default tower (the CLI hands the builders its tower's ``embed_dim``)
FEATURE_DIM = VIT_B16.embed_dim


@dataclasses.dataclass
class PairCache:
    cache_h: np.ndarray      # (C*num_shot, D)
    cache_o: np.ndarray
    cache_u: np.ndarray
    one_hots: np.ndarray     # (C*num_shot, C) multi-hot labels
    sample_lens: np.ndarray  # (C,) = one_hots.sum(0)
    counts: np.ndarray       # (C,) real (non-padded) rows per class


@dataclasses.dataclass
class UPTCaches:
    cache_h: np.ndarray
    cache_o: np.ndarray
    cache_u: np.ndarray
    one_hots: np.ndarray
    sample_lens: np.ndarray
    clip_global_keys: np.ndarray          # (D, C*num_shot), D the embedding
    dino_keys: np.ndarray                 # (2048, C*num_shot)
    object_class_multihot: np.ndarray     # (num_objects, C)
    object_embedding: np.ndarray          # (num_objects, D)
    origin_text_embeddings: np.ndarray    # (C, D)
    # per-image verb multi-hots co-selected with the keys; None -> the
    # pair-cache one_hots (the reference's runtime behaviour)
    clip_global_values: Optional[np.ndarray] = None   # (C*num_shot, C)
    dino_values: Optional[np.ndarray] = None          # (C*num_shot, C)
    # per-branch label matrices; None -> the shared one_hots
    one_hots_h: Optional[np.ndarray] = None
    one_hots_o: Optional[np.ndarray] = None
    one_hots_u: Optional[np.ndarray] = None
    one_hots_ho: Optional[np.ndarray] = None


def _l2(x):
    return x / np.clip(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12, None)


def load_pair_annotations(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def _multi_hot_labels(anno, num_classes, class_ids, use_multi_hot):
    """Per-pair multi-hot class rows; with use_multi_hot, pairs whose human
    AND object boxes overlap (IoU>0.6, same object class) share labels
    (:659-668)."""
    n = len(class_ids)
    rows = np.zeros((n, num_classes), np.float64)
    rows[np.arange(n), class_ids] = 1.0
    if not use_multi_hot or n == 0:
        return rows
    bh = np.asarray(anno["boxes_h"], np.float64)
    bo = np.asarray(anno["boxes_o"], np.float64)
    objs = np.asarray(anno["objects"])
    iou_h = box_iou(bh, bh)
    iou_o = box_iou(bo, bo)
    same = (iou_h > 0.6) & (iou_o > 0.6) & (objs[None] == objs[:, None])
    merged = np.clip(same.astype(np.float64) @ rows, 0, 1)
    return merged


def _select(n_rows, num_shot, label_choice, real_v, num_anno, rng):
    """Shot-selection policies (:724-744). Returns row indices."""
    k = min(n_rows, num_shot)
    if k == n_rows:
        return np.arange(n_rows)
    if label_choice == "random":
        return rng.permutation(n_rows)[:k]
    if label_choice in ("multi_first", "single_first"):
        order = np.argsort(-real_v.sum(-1), kind="stable")
        return order[:k] if label_choice == "multi_first" else order[::-1][:k]
    if label_choice == "single+multi":
        order = np.argsort(-real_v.sum(-1), kind="stable")
        return np.concatenate([order[:k // 2], order[::-1][:k // 2]])
    freq = real_v @ np.asarray(num_anno, np.float64)
    order = np.argsort(freq, kind="stable")
    if label_choice == "rare_first":
        return order[:k]
    if label_choice == "non_rare_first":
        return order[::-1][:k]
    if label_choice == "rare+non_rare":
        return np.concatenate([order[::-1][:k // 2], order[:k // 2]])
    raise ValueError(label_choice)


def build_pair_cache(annotation: dict, num_classes: int, num_shot: int,
                     object_n_verb_to_interaction: Optional[np.ndarray],
                     object_class_to_target_class: Optional[List[list]],
                     filtered_hoi_idx: Sequence[int] = (),
                     use_multi_hot: bool = True,
                     label_choice: str = "random",
                     num_anno: Optional[Sequence] = None,
                     seed: int = 0, dim: int = FEATURE_DIM) -> PairCache:
    """Group per-pair CLIP crop features by class, select shots, zero-pad.

    num_classes 117/24 groups by verb; 600 groups by interaction
    (object_n_verb_to_interaction LUT). Zero-shot: filtered HOI classes are
    excluded and backfilled with N(0,1) rows (:703-708). The rows are as
    wide as the pickle's features; ``dim`` where it holds none.
    """
    rng = np.random.default_rng(seed)
    feats = {k: [[] for _ in range(num_classes)]
             for k in ("hum", "obj", "uni")}
    real_verbs = [[] for _ in range(num_classes)]
    filtered = set(filtered_hoi_idx)

    for anno in annotation.values():
        objects = np.asarray(anno["objects"])
        verbs = np.asarray(anno["verbs"])
        if len(verbs) == 0:
            continue
        if num_classes in (117, 24):
            class_ids = verbs
        else:
            class_ids = object_n_verb_to_interaction[objects, verbs]
        rows = _multi_hot_labels(anno, num_classes, class_ids, use_multi_hot)
        hum = _l2(np.asarray(anno["huamn_features"], np.float64))
        obj = _l2(np.asarray(anno["object_features"], np.float64))
        uni = _l2(np.asarray(anno["union_features"], np.float64))
        for i, c in enumerate(class_ids):
            if num_classes in (117, 24):
                # drop pairs whose verb is invalid for the object (:676-678)
                if object_class_to_target_class is not None and \
                        verbs[i] not in object_class_to_target_class[objects[i]]:
                    continue
            elif c in filtered:
                continue
            feats["hum"][c].append(hum[i])
            feats["obj"][c].append(obj[i])
            feats["uni"][c].append(uni[i])
            real_verbs[c].append(rows[i])

    # backfill: unseen interactions get random rows; verbs with no samples
    # get zero rows with identity labels (:690-708)
    d = next((f[0].shape[-1] for k in feats for f in feats[k] if f),
             dim)   # infer the embed dim from the pkl rows
    for c in range(num_classes):
        if feats["hum"][c]:
            continue
        for _ in range(num_shot):
            if num_classes == 600 and c in filtered:
                for k in feats:
                    feats[k][c].append(rng.standard_normal(d))
            else:
                for k in feats:
                    feats[k][c].append(np.zeros(d))
            row = np.zeros(num_classes)
            row[c] = 1.0
            real_verbs[c].append(row)

    out = {k: np.zeros((num_classes * num_shot, d), np.float32)
           for k in feats}
    one_hots = np.zeros((num_classes * num_shot, num_classes), np.float32)
    counts = np.zeros(num_classes, np.int32)
    for c in range(num_classes):
        rows = np.asarray(real_verbs[c])
        idx = _select(len(rows), num_shot, label_choice, rows, num_anno, rng)
        lo = c * num_shot
        counts[c] = len(idx)
        for j, src in enumerate(idx):
            one_hots[lo + j] = rows[src]
            for k in feats:
                out[k][lo + j] = feats[k][c][src]
    return PairCache(out["hum"], out["obj"], out["uni"], one_hots,
                     one_hots.sum(0), counts)


def build_gen_cache(gen_features: np.ndarray, gen_targets: np.ndarray,
                    hoi_to_class: np.ndarray, num_classes: int,
                    num_shot: int, counts: Optional[np.ndarray] = None,
                    seed: int = 0) -> PairCache:
    """Cache from VAE-generated features (load_gen_model, :838-956).

    gen_features: (3*N, D) stacked [hoi; human; object] blocks;
    gen_targets: (3*N,) HOI class per row. hoi_to_class maps HOI id ->
    cache class (verb for 117/24, identity for 600). ``counts`` optionally
    limits rows for deficient classes to match a real cache's row counts
    (the reference's not_equal_2/idx_not_num logic); padded layout makes
    this optional — default fills num_shot everywhere.
    """
    rng = np.random.default_rng(seed)
    n = len(gen_targets) // 3
    hoi_f, hum_f, obj_f = (gen_features[:n], gen_features[n:2 * n],
                           gen_features[2 * n:3 * n])
    tgt = np.asarray(gen_targets[:n])
    d = gen_features.shape[-1]
    cache = {k: np.zeros((num_classes * num_shot, d), np.float32)
             for k in ("hum", "obj", "uni")}
    one_hots = np.zeros((num_classes * num_shot, num_classes), np.float32)
    class_to_hois = [np.nonzero(hoi_to_class == c)[0]
                     for c in range(num_classes)]
    for c in range(num_classes):
        k = int(counts[c]) if counts is not None else num_shot
        for j in range(min(k, num_shot)):
            hoi = rng.choice(class_to_hois[c])
            rows = np.nonzero(tgt == hoi)[0]
            src = rows[rng.integers(len(rows))]
            lo = c * num_shot + j
            cache["uni"][lo] = hoi_f[src]
            cache["hum"][lo] = hum_f[src]
            cache["obj"][lo] = obj_f[src]
            one_hots[lo, c] = 1.0
    return PairCache(cache["hum"], cache["obj"], cache["uni"], one_hots,
                     one_hots.sum(0),
                     counts if counts is not None
                     else np.full(num_classes, num_shot, np.int32))


def build_global_cache(image_features: np.ndarray,
                       image_multihots: np.ndarray, num_classes: int,
                       num_shot: int, seed: int = 0):
    """CLIP/DINO whole-image cache keys AND values (reference
    build_clip_cache_model / build_dino_cache_model, utils.py:6-176).

    Per class c: one permutation of the images containing c, keep the first
    min(n, num_shot) (the reference's single ``randperm(...)[:num_shot]``,
    utils.py:47-50); key = the image's L2-normalized global feature, value =
    that image's full per-verb multi-hot (utils.py:31-41) — NOT just class c.
    Classes with no images get num_shot random keys + identity values
    (utils.py:52-57). Padded layout: classes with n < num_shot real images
    carry zero keys and all-zero value rows (the reference keeps a ragged
    tensor instead; zero value rows make affinity@values identical).

    Returns (keys (D, C*num_shot) float32 L2-normalized,
             values (C*num_shot, C) float32).

    Note the runtime default substitutes the pair-cache one_hots for these
    values (the reference does exactly that at upt_tip...py:432,442-450 —
    the built values are passed to UPT but discarded); see
    UPTConfig.global_values_mode.
    """
    rng = np.random.default_rng(seed)
    d = image_features.shape[-1]
    keys = np.zeros((num_classes * num_shot, d), np.float32)
    values = np.zeros((num_classes * num_shot, num_classes), np.float32)
    for c in range(num_classes):
        rows = np.nonzero(image_multihots[:, c] > 0)[0]
        lo = c * num_shot
        if len(rows) == 0:
            for j in range(num_shot):
                keys[lo + j] = rng.standard_normal(d)
                values[lo + j, c] = 1.0
            continue
        sel = rng.permutation(rows)[:num_shot]
        for j, src in enumerate(sel):
            keys[lo + j] = image_features[src]
            values[lo + j] = image_multihots[src]
    keys = _l2(keys)
    return keys.T.astype(np.float32), values


def random_caches(num_classes: int, num_shot: int, num_objects: int = 80,
                  seed: int = 0, dim: int = FEATURE_DIM) -> UPTCaches:
    """Synthetic caches for tests and benchmarks, drawn from numpy's
    ``default_rng(seed)``: the same arrays as the JAX package's
    ``random_caches`` for the same arguments (its rows are 512 wide, the
    default ``dim``). ``dim``: the CLIP embedding's width."""
    rng = np.random.default_rng(seed)
    r = num_classes * num_shot

    def f(*s):
        return _l2(rng.standard_normal(s)).astype(np.float32)

    one_hots = np.zeros((r, num_classes), np.float32)
    one_hots[np.arange(r), np.repeat(np.arange(num_classes), num_shot)] = 1
    m = np.zeros((num_objects, num_classes), np.float32)
    for o in range(num_objects):
        m[o, rng.permutation(num_classes)[:max(
            1, num_classes // num_objects + 2)]] = 1
    return UPTCaches(
        cache_h=f(r, dim), cache_o=f(r, dim),
        cache_u=f(r, dim), one_hots=one_hots,
        sample_lens=one_hots.sum(0),
        clip_global_keys=f(r, dim).T,
        dino_keys=f(r, 2048).T,
        object_class_multihot=m,
        object_embedding=rng.standard_normal(
            (num_objects, dim)).astype(np.float32),
        origin_text_embeddings=f(num_classes, dim),
        clip_global_values=one_hots.copy(),
        dino_values=one_hots.copy(),
    )


def refresh_unseen_cache(cache: np.ndarray, counts: np.ndarray,
                         text_embeddings: np.ndarray,
                         seen_idx: Sequence[int],
                         unseen_idx: Sequence[int],
                         num_shot: int) -> np.ndarray:
    """Fill unseen classes' cache rows with a text-similarity-weighted blend
    of seen classes' (last real) cache rows
    (UPT.refresh_unseen_verb_cache_mem, upt...py:609-633, --fill_zs_verb_type
    1). Works per feature family on the padded layout."""
    cache = cache.copy()
    seen = np.asarray(list(seen_idx), int)
    text = np.asarray(text_embeddings, np.float64)
    # last real row of each seen class's block (the reference's
    # cumsum_sample_lens - 1 selection)
    tmp = np.stack([cache[c * num_shot + max(int(counts[c]) - 1, 0)]
                    for c in seen])
    for c in unseen_idx:
        sim = text[c] @ text[seen].T
        w = np.exp(sim - sim.max())
        w /= w.sum()
        emb = w @ tmp
        cache[c * num_shot:(c + 1) * num_shot] = emb
    return cache.astype(np.float32)
