"""Tip-Adapter cache containers (the part of ``hoigen_tpu/models/cache.py``
that the eval step needs: ``UPTCaches`` and ``random_caches``).

Every class occupies exactly ``num_shot`` rows, zero-padded; padding rows
carry all-zero label vectors, so affinity @ labels / sample_lens equals the
reference's ragged layout. Host-side numpy. Building caches from data waits
for the slice that runs host evaluation.
"""
import dataclasses
from typing import Optional

import numpy as np

FEATURE_DIM = 512


@dataclasses.dataclass
class UPTCaches:
    cache_h: np.ndarray
    cache_o: np.ndarray
    cache_u: np.ndarray
    one_hots: np.ndarray
    sample_lens: np.ndarray
    clip_global_keys: np.ndarray          # (512, C*num_shot)
    dino_keys: np.ndarray                 # (2048, C*num_shot)
    object_class_multihot: np.ndarray     # (num_objects, C)
    object_embedding: np.ndarray          # (num_objects, 512)
    origin_text_embeddings: np.ndarray    # (C, 512)
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


def random_caches(num_classes: int, num_shot: int, num_objects: int = 80,
                  seed: int = 0) -> UPTCaches:
    """Synthetic caches for tests and benchmarks, drawn from numpy's
    ``default_rng(seed)``: the same arrays as the JAX package's
    ``random_caches`` for the same arguments."""
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
        cache_h=f(r, FEATURE_DIM), cache_o=f(r, FEATURE_DIM),
        cache_u=f(r, FEATURE_DIM), one_hots=one_hots,
        sample_lens=one_hots.sum(0),
        clip_global_keys=f(r, FEATURE_DIM).T,
        dino_keys=f(r, 2048).T,
        object_class_multihot=m,
        object_embedding=rng.standard_normal(
            (num_objects, FEATURE_DIM)).astype(np.float32),
        origin_text_embeddings=f(num_classes, FEATURE_DIM),
        clip_global_values=one_hots.copy(),
        dino_values=one_hots.copy(),
    )
