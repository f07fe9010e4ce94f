"""Multi-process runtime over ``torch.distributed`` (port of
``hoigen_tpu/parallel/distributed.py``).

The reference scales with one process per GPU, DDP over NCCL and host
gathers for the metrics (main_tip_finetune.py:328-332,
pocket/utils/distributed.py:17-143). So does the port: each process owns
one card (``cuda:{PROCESS_ID % device_count}``), walks the same global
batch stream as every other and loads only its rows of each batch
(:func:`local_batch_indices`); the training step all-reduces the positive
count and the gradients over the mesh's data axis (``engine/
hoi_model.py``), and evaluation merges its per-process results through
:func:`process_allgather_ragged` and :func:`gather_pyobj`.

The JAX package's ``global_batch_from_local`` and ``host_local_rows`` turn
per-process rows into one global array and back. Here a process only ever
holds its own rows, so neither has a job and neither is ported.

Gloo's support for CUDA tensors differs from collective to collective, so
every collective here runs on host copies under gloo (copied back to the
card after) and on the card under NCCL. A collective without a process
group is the identity; asking for more than one process without one
raises. :func:`launch` starts N processes of one function, one card each:
``--devices N`` of the CLI.
"""
import os
import pickle
import socket
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import make_mesh


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None, device=None) -> bool:
    """Join the process group of a multi-process run.

    With no arguments, reads ``COORDINATOR_ADDRESS`` (host:port),
    ``NUM_PROCESSES`` and ``PROCESS_ID`` from the environment, as the JAX
    package does, and does nothing when the address is absent. ``device``
    is the run's device (None: CUDA): on CUDA the process takes card
    ``PROCESS_ID % device_count`` and the backend is NCCL, on the CPU
    gloo; ``backend`` overrides it (gloo for several processes on one
    card, which NCCL refuses). Idempotent: once a process group exists
    (joined here or by the caller), it is the one used. Returns True when
    more than one process runs."""
    if _initialized():
        return dist.get_world_size() > 1
    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    if coordinator is None:
        return False
    num_processes = int(num_processes or os.environ["NUM_PROCESSES"])
    process_id = int(process_id if process_id is not None
                     else os.environ["PROCESS_ID"])
    cuda = torch.device("cuda" if device is None else device).type == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device is "
                               "available; pass device='cpu'")
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend or ("nccl" if cuda else "gloo"),
                            init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return num_processes > 1


def process_count() -> int:
    return dist.get_world_size() if _initialized() else 1


def process_index() -> int:
    return dist.get_rank() if _initialized() else 0


def is_primary() -> bool:
    return process_index() == 0


def barrier() -> None:
    """Wait for every process (nothing without a process group)."""
    if _initialized():
        dist.barrier()


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """In-place SUM of ``t`` over ``group`` (None: every process; the
    identity without a process group). Under gloo a CUDA tensor is reduced
    on a host copy and copied back, which a CUDA graph cannot hold: it
    raises inside a capture."""
    if not _initialized():
        return t
    if t.is_cuda and dist.get_backend(group) == "gloo":
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("all_reduce: a gloo collective of a CUDA "
                               "tensor runs on a host copy, which a CUDA "
                               "graph cannot capture")
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def capturable(mesh) -> bool:
    """Whether a training step over ``mesh`` can be captured in a CUDA
    graph with its collectives inside: every group the step reduces over
    (the data group, and the row group where the cache rows are sharded)
    is NCCL, whose collectives are device work. Under gloo they run on
    host copies. A mesh without groups (one process) has no collective."""
    groups = [g for g in (mesh.data_group, mesh.row_group) if g is not None]
    return all(dist.get_backend(g) == "nccl" for g in groups)


def local_batch_indices(n: int, global_batch_size: int, shuffle: bool,
                        seed: int = 0, pad_tail: bool = False,
                        return_global: bool = False):
    """This process's slice of each global batch: every process computes
    the same global stream (same seed) and process k takes rows
    [k*B/p, (k+1)*B/p) of each batch. -> (local_idx, global_n_real)
    pairs, or with ``return_global`` (global_idx, local_idx,
    global_n_real) triples. Sequential ragged tails are always padded (a
    short global batch cannot split evenly); :func:`local_n_real` drops
    the padding."""
    from ..data.loader import batch_indices
    p, k = process_count(), process_index()
    if global_batch_size % p:
        raise ValueError(f"global batch {global_batch_size} must divide "
                         f"over {p} processes")
    batches = batch_indices(n, global_batch_size, shuffle, seed,
                            pad_tail=pad_tail or not shuffle)
    per = global_batch_size // p
    if return_global:
        return [(idx, idx[k * per:(k + 1) * per], n_real)
                for idx, n_real in batches]
    return [(idx[k * per:(k + 1) * per], n_real) for idx, n_real in batches]


def local_n_real(global_n_real: int, global_batch_size: int) -> int:
    """How many of this process's rows are not padding, given the global
    count (the padding is at the end of the global batch)."""
    per = global_batch_size // process_count()
    lo = process_index() * per
    return int(np.clip(global_n_real - lo, 0, per))


def gather_pyobj(obj) -> list:
    """One picklable object from every process, in process order
    (``[obj]`` with one process): the official-format caching paths'
    ragged per-image results."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], (list, tuple)):
        return type(trees[0])(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def process_allgather(tree):
    """A numpy tree from every process, each leaf stacked on a leading
    process axis (one process: the axis added)."""
    parts = gather_pyobj(_tree_map(np.asarray, tree))
    return _tree_map(lambda *xs: np.stack(xs), *parts)


def process_allgather_ragged(tree):
    """Numpy arrays whose leading dims differ between processes,
    concatenated along axis 0 in process order (eval detections: each
    process scored its own pairs). One process: the tree as numpy."""
    tree = _tree_map(np.asarray, tree)
    if process_count() == 1:
        return tree
    parts = gather_pyobj(tree)
    return _tree_map(lambda *xs: np.concatenate(xs, 0), *parts)


def global_mesh(n_model: int = 1):
    """The (data, model) mesh over every process."""
    return make_mesh(n_model=n_model)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawned(index, fn, n, port, args, result_path):
    os.environ.update(COORDINATOR_ADDRESS=f"localhost:{port}",
                      NUM_PROCESSES=str(n), PROCESS_ID=str(index))
    out = fn(*args)
    if index == 0:
        with open(result_path, "wb") as f:
            pickle.dump(out, f)


def launch(fn, n: int, *args, device=None):
    """Run ``fn(*args)`` in ``n`` new processes, one card each, joined by
    the three variables that :func:`init_distributed` reads (the
    reference's ``mp.spawn`` launcher). ``fn`` must be importable by name
    and its result picklable. ``device``: the run's device (None: CUDA),
    which must hold ``n`` cards. Returns process 0's result."""
    if torch.device("cuda" if device is None else device).type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(f"{n} processes of one card each need {n} "
                               f"CUDA devices; {have} are visible")
    import tempfile

    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "result.pkl")
        mp.spawn(_spawned, args=(fn, n, free_port(), args, path), nprocs=n,
                 join=True)
        with open(path, "rb") as f:
            return pickle.load(f)
