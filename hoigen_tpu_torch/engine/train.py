"""The training loop (port of ``hoigen_tpu/engine/train.py``): a host
loop around the training step with a NaN guard, timing meters, periodic
logging, iteration and epoch counters and a checkpoint every epoch."""
import time
from collections import deque
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..parallel.distributed import barrier, capturable, is_primary
from .checkpoint import restore_checkpoint, save_checkpoint
from .cuda_graph import GraphedTrainStep
from .partition import trainable_leaves


def key_of(path):
    """A leaf's path as a checkpoint key: its parts joined by '/'."""
    return "/".join(str(p) for p in path)


def load_trainable(params, path: str) -> None:
    """Write the trainable parameters saved at ``path`` (a checkpoint of
    :meth:`Trainer.state`) into ``params`` in place; the rest of the
    saved state (optimizer, counters) is not read."""
    leaves = trainable_leaves(params)
    state = restore_checkpoint(
        path, {"trainable": {key_of(p): t for p, t in leaves}}, partial=True)
    with torch.no_grad():
        for p, t in leaves:
            t.copy_(state["trainable"][key_of(p)])


class Trainer:
    """``train_step`` and ``optimizer`` as from
    ``engine.hoi_model.make_train_step`` and ``make_optimizer``; the step
    updates ``params`` in place. ``data_rank``: this process's index on the
    data axis of a data-parallel run, which seeds its dropout apart from
    the other ranks'. In a multi-process run process 0 writes the
    checkpoints and every process waits for it.

    On the card the step runs as one CUDA graph per batch signature
    (``engine/cuda_graph.py::GraphedTrainStep``), as the JAX Trainer jits
    it; on the CPU it runs eagerly. A step over a mesh (its ``mesh``
    attribute, from ``make_train_step``) is graphed with its collectives
    inside where every group it reduces over is NCCL
    (``parallel/distributed.py::capturable``), as the CLI's process
    groups on the card are; under gloo its collectives run on host
    copies, which no graph can hold, and the step runs eagerly."""

    def __init__(self, train_step: Callable, optimizer, params, buffers,
                 print_interval: int = 500, output_dir: Optional[str] = None,
                 checkpoint_every_epoch: bool = True, data_rank: int = 0):
        mesh = getattr(train_step, "mesh", None)
        self.step_fn = train_step if mesh is not None and \
            not capturable(mesh) else GraphedTrainStep(train_step, optimizer)
        self.optimizer = optimizer
        self.params = params
        self.buffers = buffers
        self.print_interval = print_interval
        self.output_dir = output_dir
        self.checkpoint_every_epoch = checkpoint_every_epoch
        self.data_rank = data_rank
        self.iteration = 0
        self.epoch = 0
        self._t_data = deque(maxlen=print_interval)
        self._t_iter = deque(maxlen=print_interval)
        self._losses = deque(maxlen=print_interval)

    def state(self):
        """The full training state: trainable parameters (by path),
        optimizer state (with its update count), iteration and epoch."""
        return {"trainable": {key_of(p): t.detach() for p, t in
                              trainable_leaves(self.params)},
                "opt_state": self.optimizer.state_dict(),
                "iteration": self.iteration, "epoch": self.epoch}

    def restore(self, path: str) -> None:
        """Resume the full training state saved at ``path``: the trainable
        parameters are written into ``params`` in place (the optimizer
        holds them), then the optimizer state and the counters."""
        load_trainable(self.params, path)
        state = restore_checkpoint(path)
        self.optimizer.load_state_dict(state["opt_state"])
        self.iteration = int(state["iteration"])
        self.epoch = int(state["epoch"])

    def run_epoch(self, batches: Iterable,
                  seed: Optional[int] = None) -> float:
        """batches: iterable of batch dicts. ``seed``: dropout runs, from a
        generator seeded by (seed, iteration, data rank) at each step, so
        that a resumed run draws what an uninterrupted one would; None runs
        no dropout. Returns the epoch's mean loss."""
        self.epoch += 1
        gen = None
        if seed is not None:
            gen = torch.Generator(
                device=trainable_leaves(self.params)[0][1].device)
        last = time.perf_counter()
        epoch_loss, n = 0.0, 0
        for batch in batches:
            t0 = time.perf_counter()
            self._t_data.append(t0 - last)
            if gen is not None:
                gen.manual_seed(seed * 1_000_003 + self.iteration
                                + (self.data_rank << 40))
            metrics = self.step_fn(self.params, self.buffers, batch, gen)
            loss = float(metrics["loss"])
            if not np.isfinite(loss):
                raise ValueError(
                    f"HOI loss is not finite at iteration {self.iteration}")
            self.iteration += 1
            self._losses.append(loss)
            epoch_loss += loss
            n += 1
            last = time.perf_counter()
            self._t_iter.append(last - t0)
            if self.iteration % self.print_interval == 0:
                print(f"Epoch [{self.epoch}], Iter [{self.iteration}], "
                      f"loss: {np.mean(self._losses):.4f}, "
                      f"time[data/iter]: "
                      f"[{np.sum(self._t_data):.2f}s/"
                      f"{np.sum(self._t_iter):.2f}s]")
        if self.checkpoint_every_epoch and self.output_dir:
            if is_primary():
                save_checkpoint(self.output_dir, self.iteration,
                                self.state())
            barrier()
        return epoch_loss / max(n, 1)
