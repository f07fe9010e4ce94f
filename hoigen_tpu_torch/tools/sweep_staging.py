"""Time of the graphs' input staging (``engine/cuda_graph.py::_Graph.load``)
over the staging pool's size, at the training and eval cells' batches.

    python3 -m hoigen_tpu_torch.tools.sweep_staging [--loads 20] [--seed 0]

For a batch of 32 uint8 images at (1344, 1344) and at (800, 1344), with
the small inputs a batch holds beside them, from numpy (two batches in
turn, as a loop over a pool of batches hands them over), each setting
gives the mean host time of a load (what the span ``graph.stage`` times)
and of a load until its copies have landed on the card:

- ``whole``: the whole copy on the calling thread, then the copy to the
  card (the staging before the pipeline: ``PIPE_BYTES`` out of reach);
- ``pool N``: the pipeline with a staging pool of N threads, whatever
  ``POOL_CAP`` and the CPUs visible say;
- ``pool N, R rows``: the same with ``CHUNK_BYTES`` at R image rows, for
  R in ``CHUNK_ROWS`` (one row a chunk above).

Beside them: ``np.copyto`` of one batch into pageable memory on one
thread, and the copy to the card alone from pinned memory (CUDA events).
After each setting the static inputs must equal the last batch bit for
bit. Prints one line a setting, then one JSON line. Exits non-zero
without a CUDA card.
"""
import argparse
import concurrent.futures
import json
import os
import subprocess
import time

import numpy as np
import torch

from ..engine import cuda_graph as cg

POOLS = (1, 2, 4, 6, 8, 12, 16)
CHUNK_ROWS = (2, 4, 8, 16)
CHUNK_POOLS = (1, 4, 8)
BATCH = 32


def feeds(hw, seed):
    """Two host batches of ``BATCH`` images at plane ``hw``."""
    gen = np.random.default_rng([seed, *hw])
    return [{"images": gen.integers(0, 256, (BATCH, 3, *hw), np.uint8),
             "image_sizes": gen.random((BATCH, 2), np.float32),
             "clip_sizes": gen.random((BATCH, 2), np.float32)}
            for _ in range(2)]


def timed_loads(g, batches, loads):
    """Mean ms of a load and of a load until its copies landed."""
    host, landed = [], []
    for i in range(loads):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g.load(batches[i % 2])
        t1 = time.perf_counter()
        g.copied.synchronize()
        t2 = time.perf_counter()
        host.append(t1 - t0)
        landed.append(t2 - t0)
    last = batches[(loads - 1) % 2]
    for k, v in last.items():
        if not torch.equal(g.static_in[k].cpu(), torch.as_tensor(v)):
            raise SystemExit(f"staging: {k} differs from its source")
    return 1e3 * float(np.mean(host)), 1e3 * float(np.mean(landed))


def with_pool(n):
    """Make the staging pool one of ``n`` threads."""
    if cg._pool is not None:
        cg._pool.shutdown()
    cg._pool = concurrent.futures.ThreadPoolExecutor(n)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--loads", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    cpus = len(os.sched_getaffinity(0))
    print(f"{card}; {cpus} CPUs visible, {os.cpu_count()} in the machine; "
          f"POOL_CAP {cg.POOL_CAP}", flush=True)
    device = torch.device("cuda")
    out = {"card": card, "cpus": cpus, "pool_cap": cg.POOL_CAP,
           "loads": args.loads, "planes": {}}
    for hw in ((1344, 1344), (800, 1344)):
        batches = feeds(hw, args.seed)
        images = batches[0]["images"]
        rec = out["planes"]["x".join(map(str, hw))] = {}
        plain = images.copy()                   # its pages touched
        ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            np.copyto(plain, images)
            ms.append(time.perf_counter() - t0)
        rec["np_copyto_ms"] = 1e3 * float(np.mean(ms))
        g = cg._Graph(batches[0], device)
        g.load(batches[0])
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        for _ in range(5):
            g.static_in["images"].copy_(g.staging["images"],
                                        non_blocking=True)
        end.record()
        end.synchronize()
        rec["card_copy_ms"] = start.elapsed_time(end) / 5
        print(f"{hw}: {images.nbytes / 1e6:.1f} MB; np.copyto "
              f"{rec['np_copyto_ms']:.3f} ms on one thread, the copy to "
              f"the card alone {rec['card_copy_ms']:.3f} ms", flush=True)
        row = images.nbytes // BATCH
        settings = [("whole", None, None)] + \
            [(f"pool {n}", n, None) for n in POOLS] + \
            [(f"pool {n}, {r} rows", n, r) for r in CHUNK_ROWS
             for n in CHUNK_POOLS]
        for name, n, r in settings:
            saved = cg.PIPE_BYTES, cg.CHUNK_BYTES
            if n is None:
                cg.PIPE_BYTES = 1 << 62
            else:
                with_pool(n)
            if r is not None:
                cg.CHUNK_BYTES = r * row
            try:
                g.load(batches[1])              # the pool's threads start
                host, landed = timed_loads(g, batches, args.loads)
            finally:
                cg.PIPE_BYTES, cg.CHUNK_BYTES = saved
            rec[name] = {"host_ms": host, "landed_ms": landed}
            print(f"{hw} {name}: a load {host:.3f} ms on the host, "
                  f"{landed:.3f} ms until its copies landed (mean of "
                  f"{args.loads})", flush=True)
        del g
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
