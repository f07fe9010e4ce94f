"""The (data, model) grid of processes and the cache-row sharding (port of
``hoigen_tpu/parallel/mesh.py``).

JAX runs one SPMD program over a ``Mesh`` of devices: batches shard over
its ``data`` axis and XLA inserts the gradient psum; a ``model`` axis can
tensor-shard the cache matmuls. The port has one process per card, so a
mesh is a grid of ranks, rank = data_index * n_model + model_index, with a
process subgroup along each axis: the training step all-reduces the
positive count and the gradients over ``data_group``, and the sharded
cache branches reduce their partial logits over ``model_group``
(``models/upt.py::compute_logits``).

Every cache branch is separable by rows: ``((X W^T + b) L) / s`` sums
over the (class x shot) rows of W, b and L, and the global and DINO
caches put each row's affinity through that row's values. So a rank that
holds 1/m of every branch's rows scores its pairs against that slice
(K3 at R/m rows on the card), and the sum of the m partial logits is the
full one. Under a gradient this takes the two autograd functions of
tensor parallelism (:func:`copy_to_group`, :func:`reduce_from_group`);
the optimizer's global-norm clip adds the sharded leaves' squared norms
over the model group (``engine/hoi_model.py::GroupedAdamW``).
"""
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in an (n_data, n_model) grid of ranks. The
    groups are None without a process group (one process)."""
    n_data: int
    n_model: int
    data_index: int = 0
    model_index: int = 0
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def row_group(self):
        """The group over which :func:`shard_cache_rows` splits the cache
        rows: the model group on a model axis above 1, else None."""
        return self.model_group if self.n_model > 1 else None


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The grid over every process (n_data defaults to the process count
    over n_model; n_data * n_model must be the process count). Every
    process calls it, in the same order: it creates the subgroups."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs "
                         f"{n_data * n_model} processes; {world} run"
                         + ("" if initialized else
                            " (init_distributed was not called)"))
    if not initialized:
        return Mesh(1, 1)
    rank = dist.get_rank()
    groups = {}
    for d in range(n_data):
        groups["model", d] = dist.new_group(
            [d * n_model + m for m in range(n_model)])
    for m in range(n_model):
        groups["data", m] = dist.new_group(
            [d * n_model + m for d in range(n_data)])
    d, m = divmod(rank, n_model)
    return Mesh(n_data, n_model, d, m, groups["data", m], groups["model", d])


def shard_batch(mesh: Mesh, tree):
    """This rank's rows of every array of a batch tree: the batch axis
    split over the data axis (each process computes the same global batch
    and keeps its slice)."""
    def rows(x):
        n = x.shape[0]
        if n % mesh.n_data:
            raise ValueError(f"batch of {n} does not divide over "
                             f"{mesh.n_data} data ranks")
        per = n // mesh.n_data
        return x[mesh.data_index * per:(mesh.data_index + 1) * per]
    return {k: rows(v) for k, v in tree.items()}


# The cache-branch leaves and the axis that spans their (class x shot)
# rows; biases and value matrices are rows-first, the global and DINO keys
# (feat_dim, rows).
_CACHE_ROW_LEAVES = {
    "adapter_H_w": 0, "adapter_H_b": 0, "adapter_O_w": 0, "adapter_O_b": 0,
    "adapter_U_w": 0, "adapter_U_b": 0, "adapter_HO_w": 0, "adapter_HO_b": 0,
    "global_cache": 1, "global_cache_bias": 0,
    "dino_cache": 1, "dino_cache_bias": 0,
    "one_hots_H": 0, "one_hots_O": 0, "one_hots_U": 0, "one_hots_HO": 0,
    "global_values": 0, "dino_values": 0,
}


def is_cache_row_leaf(path) -> bool:
    """Is the leaf at ``path`` (of the parameter dict) a cache-row leaf?"""
    return len(path) == 2 and path[0] == "upt" and \
        path[1] in _CACHE_ROW_LEAVES


def shard_cache_rows(mesh: Mesh, params, buffers):
    """Each listed cache leaf of ``params["upt"]`` and ``buffers`` cut to
    this rank's 1/n_model slice of its row axis (a copy, keeping
    ``requires_grad``); everything else as it is. -> (params, buffers).
    The identity on a model axis of 1. Raises where a leaf's rows do not
    divide: a branch must be sharded whole or not at all."""
    m = mesh.n_model
    if m == 1:
        return params, buffers

    def cut(name, t):
        axis = _CACHE_ROW_LEAVES.get(name)
        if axis is None or t is None:
            return t
        if t.shape[axis] % m:
            raise ValueError(f"{name}: {t.shape[axis]} rows do not divide "
                             f"over {m} model ranks")
        per = t.shape[axis] // m
        part = t.detach().narrow(axis, mesh.model_index * per, per).clone()
        return part.requires_grad_(t.requires_grad)

    upt = {k: cut(k, v) for k, v in params["upt"].items()}
    return dict(params, upt=upt), {k: cut(k, v) for k, v in buffers.items()}


class _CopyToGroup(torch.autograd.Function):
    """Forward the identity; backward the SUM of the gradient over the
    group (features entering a branch sharded over it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from .distributed import all_reduce
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """Forward the SUM over the group (partial logits of a sharded
    branch); backward the identity."""

    @staticmethod
    def forward(ctx, x, group):
        from .distributed import all_reduce
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x, group):
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    return _ReduceFromGroup.apply(x, group)
