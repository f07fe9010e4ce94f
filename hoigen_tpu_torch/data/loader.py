"""Parallel input pipeline: threaded decode/transform + batch prefetch.

Reference analog: ``torch.utils.data.DataLoader(num_workers=...)`` in
reference/main_tip_finetune.py:374-388. A pool of worker
threads runs the per-sample work (PIL decode + numpy transforms — both
release the GIL), a producer thread collates finished samples into
fixed-shape batches (and runs ``to_device`` where one is given), and a
bounded queue keeps a couple of batches in flight so the card does not
wait on the host. The worker threads touch no CUDA state.

Two extra properties the torch loader doesn't give us:
  * deterministic batches regardless of worker count — the index order is
    fixed up front and batches are assembled in order, so ``num_workers=0``
    and ``num_workers=8`` produce identical streams (tested);
  * optional tail padding — with ``pad_tail`` the final short batch is
    filled by repeating its last sample and the true length is reported, so
    eval runs one batch shape instead of a ragged tail.

Port of ``hoigen_tpu/data/loader.py``, the same algorithm in the same order
(the tests hold the two packages equal).
"""
import itertools
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

__all__ = ["batch_indices", "iter_batches"]


def batch_indices(n: int, batch_size: int, shuffle: bool, seed: int = 0,
                  pad_tail: bool = False):
    """Split ``range(n)`` into batches of indices.

    Returns a list of ``(idx_array, n_real)`` where ``n_real`` is the number
    of non-padded entries. Shuffled (training) order drops the ragged tail —
    same as the reference's ``drop_last`` batch sampler; sequential (eval)
    order keeps it, optionally padded by repeating the last index.
    """
    rng = np.random.default_rng(seed)
    order = rng.permutation(n) if shuffle else np.arange(n)
    out = []
    stop = (n // batch_size) * batch_size if shuffle else n
    for lo in range(0, stop, batch_size):
        idx = order[lo:lo + batch_size]
        n_real = len(idx)
        if pad_tail and n_real < batch_size:
            idx = np.concatenate(
                [idx, np.full(batch_size - n_real, idx[-1], idx.dtype)])
        out.append((idx, n_real))
    return out


def iter_batches(fetch: Callable[[int], object], batches,
                 collate: Callable[[list], object],
                 to_device: Optional[Callable] = None,
                 num_workers: int = 0, prefetch: int = 2
                 ) -> Iterator[Tuple[object, int]]:
    """Yield ``(batch, n_real)`` for each ``(idx, n_real)`` in ``batches``.

    ``fetch(i)`` loads one sample (thread-safe); ``collate(samples)`` builds
    the fixed-shape batch; ``to_device`` (e.g. a copy to the card)
    runs on the producer thread so the transfer overlaps consumer compute.
    ``num_workers <= 0`` is the synchronous reference path.

    Items may be ``(idx, n_real, meta)`` triples: ``meta`` is a kwargs dict
    forwarded to ``collate`` (multi-process runs pass the global padded
    shape this way).
    """
    if num_workers <= 0:
        for item in batches:
            idx, n_real = item[0], item[1]
            meta = item[2] if len(item) > 2 else {}
            b = collate([fetch(int(i)) for i in idx], **meta)
            yield (to_device(b) if to_device else b), n_real
        return

    ex = ThreadPoolExecutor(max_workers=num_workers,
                            thread_name_prefix="hoigen-data")
    q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
    stop = threading.Event()
    _END = object()

    def submit(item):
        idx, n_real = item[0], item[1]
        meta = item[2] if len(item) > 2 else {}
        return [ex.submit(fetch, int(i)) for i in idx], n_real, meta

    def producer():
        try:
            it = iter(batches)
            # keep one extra batch of sample futures in flight beyond the
            # collated-batch queue so workers always have samples to chew on
            pending = deque(submit(b) for b in
                            itertools.islice(it, max(prefetch, 1) + 1))
            while pending and not stop.is_set():
                futs, n_real, meta = pending.popleft()
                b = collate([f.result() for f in futs], **meta)
                if to_device is not None:
                    b = to_device(b)
                while not stop.is_set():
                    try:
                        q.put((b, n_real), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                nxt = next(it, None)
                if nxt is not None:
                    pending.append(submit(nxt))
            if not stop.is_set():
                q.put(_END)
        except BaseException as e:  # surfaced on the consumer side
            # retry like the data path: a bounded queue can stay full for
            # >1s when the consumer is slow (e.g. eval association), and a
            # dropped exception would leave the consumer blocked forever
            while not stop.is_set():
                try:
                    q.put(e, timeout=0.1)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        ex.shutdown(wait=False, cancel_futures=True)
