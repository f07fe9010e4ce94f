"""Batch samplers — torch-free equivalents of pocket's data samplers
(reference/pocket/pocket/data/samplers.py:24,92,183,243,380).

These are the last corner of the pocket data API the HOI pipeline itself
never calls (HOIGen uses plain Random/Sequential/Distributed samplers);
they are provided for framework-capability parity. Index plans are host
numpy — a sampler's output feeds the loader's fetch/collate stage, never
the compiled graph — and randomized samplers take an explicit seed or
``numpy.random.Generator`` instead of torch's global RNG.

Port of ``hoigen_tpu/data/samplers.py``, the same algorithm in the same order
(the tests hold the two packages equal).
"""
import bisect
import math
from collections import defaultdict

import numpy as np


def _as_index_array(indices, name="indices"):
    arr = np.asarray(indices)
    if arr.ndim != 1:
        raise ValueError(f"{name} must be 1-d, got shape {arr.shape}")
    if not np.issubdtype(arr.dtype, np.integer):
        raise TypeError(f"invalid dtype {arr.dtype} for {name}")
    return arr


class OnlineBatchSampler:
    """Batches mix ``num_anchors`` carried-over samples (set by the caller
    from the previous batch, e.g. its highest-scoring members) with fresh
    samples taken sequentially (reference :24-88)."""

    def __init__(self, indices, batch_size, num_anchors, randomize=False,
                 seed=None):
        indices = _as_index_array(indices)
        if randomize:
            rng = np.random.default_rng(seed)
            indices = indices[rng.permutation(len(indices))]
        self._indices = indices
        self._batch_size = batch_size
        self._num_anchors = num_anchors
        self._anchors = np.array([], dtype=indices.dtype)
        self._idx_ptr = 0

    @property
    def idx_ptr(self):
        return self._idx_ptr

    @property
    def anchors(self):
        return self._anchors

    @anchors.setter
    def anchors(self, x):
        x = np.asarray(x)
        if x.shape != (self._num_anchors,):
            raise ValueError(
                f"anchor array must have shape ({self._num_anchors},), "
                f"got {x.shape}")
        self._anchors = x

    def next(self):
        if self._idx_ptr >= len(self._indices):
            raise StopIteration
        n_new = self._batch_size - len(self._anchors)
        batch = np.hstack([
            self._anchors, self._indices[self._idx_ptr:self._idx_ptr + n_new]])
        self._idx_ptr += n_new
        return batch.astype(np.int32)


class ParallelOnlineBatchSampler:
    """Multiple online samplers served round-robin; exhausted streams drop
    out of the rotation (reference :92-181). ``next`` returns
    ``(batch_indices, stream_ptr)``; anchors are set per stream with
    ``set_anchors(x, ptr)``."""

    def __init__(self, indices, batch_size, num_anchors, shuffle=False,
                 seed=None):
        indices = [_as_index_array(seq) for seq in indices]
        if shuffle:
            rng = np.random.default_rng(seed)
            indices = [seq[rng.permutation(len(seq))] for seq in indices]
        self._indices = indices
        self._batch_size = batch_size
        self._num_anchors = num_anchors
        self._anchors = [np.array([], dtype=np.int64) for _ in indices]
        self._sampler_ptr = 0
        self._active = list(range(len(indices)))
        self._idx_ptr = np.zeros(len(indices), dtype=np.int64)

    @property
    def sampler_ptr(self):
        return self._active[self._sampler_ptr]

    def idx_ptr(self, i):
        return self._idx_ptr[i]

    def set_anchors(self, x, ptr):
        x = np.asarray(x)
        if len(x) > self._num_anchors:
            raise ValueError(
                f"{len(x)} anchors exceeds limit {self._num_anchors}")
        self._anchors[ptr] = x

    def next(self):
        if not self._active:
            raise StopIteration
        ptr = self._active[self._sampler_ptr]
        n_new = self._batch_size - len(self._anchors[ptr])
        lo = self._idx_ptr[ptr]
        batch = np.hstack([self._anchors[ptr],
                           self._indices[ptr][lo:lo + n_new]])
        self._idx_ptr[ptr] += n_new
        if self._idx_ptr[ptr] >= len(self._indices[ptr]):
            # exhausted stream leaves the rotation; the pointer then already
            # addresses the next stream, so it does not advance
            self._active.pop(self._sampler_ptr)
            if self._sampler_ptr >= len(self._active):
                self._sampler_ptr = 0
        elif self._active:
            self._sampler_ptr = (self._sampler_ptr + 1) % len(self._active)
        return batch.astype(np.int32), ptr


class IndexSequentialSampler:
    """Sequential sampler over a fixed index set (reference :183-241)."""

    def __init__(self, indices):
        self._indices = _as_index_array(indices)

    def __iter__(self):
        return iter(self._indices.tolist())

    def __len__(self):
        return len(self._indices)


class StratifiedBatchSampler:
    """Each batch takes ``samples_per_stratum`` samples from
    ``num_strata_each`` strata (strata visited sequentially across batches,
    samples within a stratum drawn without replacement until the stratum
    renews), optionally padded with ``num_negatives`` draws from a negative
    pool (reference :243-367)."""

    def __init__(self, strata, num_strata_each, samples_per_stratum,
                 num_batch, negative_pool=None, num_negatives=0, seed=None):
        if num_strata_each > len(strata):
            raise ValueError("num_strata_each exceeds the number of strata")
        self._strata = [_as_index_array(s, "strata") for s in strata]
        self._num_strata_each = num_strata_each
        self._samples_per_stratum = samples_per_stratum
        self._num_batch = num_batch
        self._negative_pool = None if negative_pool is None \
            else _as_index_array(negative_pool, "negative_pool")
        self._num_negatives = num_negatives
        self._rng = np.random.default_rng(seed)

    def _stream(self, pool, total):
        """``total`` draws without replacement, reshuffling at renewal."""
        quot, rem = divmod(total, len(pool))
        parts = [pool[self._rng.permutation(len(pool))] for _ in range(quot)]
        parts.append(pool[self._rng.permutation(len(pool))[:rem]])
        return np.concatenate(parts)

    def __iter__(self):
        num_strata = len(self._strata)
        per_stratum = self._num_batch * self._samples_per_stratum
        all_indices = np.stack([self._stream(s, per_stratum)
                                for s in self._strata])
        if self._negative_pool is not None:
            negatives = self._stream(self._negative_pool,
                                     self._num_batch * self._num_negatives)
        counter = 0
        for i in range(self._num_batch):
            batch = []
            for j in range(self._num_strata_each):
                sid = (counter + j) % num_strata
                n = (counter + j) // num_strata
                lo = n * self._samples_per_stratum
                batch.extend(
                    all_indices[sid, lo:lo + self._samples_per_stratum]
                    .tolist())
            if self._negative_pool is not None:
                lo = i * self._num_negatives
                batch.extend(negatives[lo:lo + self._num_negatives].tolist())
            yield batch
            counter += self._num_strata_each

    def __len__(self):
        return self._num_batch


class GroupedBatchSampler:
    """Wraps an index iterable to yield batches whose elements share a
    group id, following the base order as closely as possible; incomplete
    trailing groups are topped up by repeating seen samples so the batch
    count is deterministic (reference :380-440, itself vendored from the
    torchvision detection references)."""

    def __init__(self, sampler, group_ids, batch_size):
        self.sampler = sampler
        self.group_ids = group_ids
        self.batch_size = batch_size

    def __iter__(self):
        buffer_per_group = defaultdict(list)
        samples_per_group = defaultdict(list)
        num_batches = 0
        for idx in self.sampler:
            gid = self.group_ids[idx]
            buffer_per_group[gid].append(idx)
            samples_per_group[gid].append(idx)
            if len(buffer_per_group[gid]) == self.batch_size:
                yield buffer_per_group[gid]
                num_batches += 1
                del buffer_per_group[gid]
        num_remaining = len(self) - num_batches
        if num_remaining > 0:
            for gid, _ in sorted(buffer_per_group.items(),
                                 key=lambda kv: len(kv[1]), reverse=True):
                remaining = self.batch_size - len(buffer_per_group[gid])
                pool = samples_per_group[gid]
                reps = math.ceil(remaining / len(pool))
                buffer_per_group[gid].extend((pool * reps)[:remaining])
                yield buffer_per_group[gid]
                num_remaining -= 1
                if num_remaining == 0:
                    break
        assert num_remaining == 0

    def __len__(self):
        return len(self.sampler) // self.batch_size


def create_aspect_ratio_groups(aspect_ratios, k=0):
    """Quantize aspect ratios into 2k+1 log-spaced bins around 1.0
    (reference :442-455); group ids feed GroupedBatchSampler."""
    bins = sorted((2 ** np.linspace(-1, 1, 2 * k + 1)).tolist()) if k > 0 \
        else [1.0]
    return [bisect.bisect_right(bins, r) for r in aspect_ratios]
