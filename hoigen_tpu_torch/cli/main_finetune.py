"""The input and evaluation loops of ``hoigen_tpu/cli/main_finetune.py``.

What is here: :func:`batches_from_factory`, the single-process branch of
its JAX namesake, and :func:`eval_batches`, the eval loop of its ``main``
(``run_batches``) lifted to module level, so that a HICO-DET or V-COCO
evaluation runs from a dataset on disk to its mAP::

    test = DataFactory("hicodet", "test2015", root, training=False)
    train = DataFactory("hicodet", "train2015", root, training=True)
    result = evaluate_hico(
        eval_batches(make_eval_step(model_cfg), params, buffers, test, cfg),
        test.dataset, cfg.num_classes, model_cfg.upt.proposals,
        HICO.object_n_verb_to_interaction,
        train_anno_interaction=train.dataset.anno_interaction)

The rest of the JAX CLI (checkpoint loading, cache building, ``main``)
is still to port (``ROADMAP.md`` queue A).
"""
import torch

from ..data.factory import collate_batch, slice_batch
from ..data.loader import batch_indices, iter_batches
from ..utils.config import RunConfig


def _multi_process():
    return (torch.distributed.is_available()
            and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1)


def batches_from_factory(factory, batch_size, cfg: RunConfig, mesh=None,
                         shuffle=True, seed=0, pad_tail=False):
    """Yield (feed dict of numpy arrays, Batch) through the threaded input
    pipeline (``data/loader.py``). With ``pad_tail`` the final short batch
    is padded to ``batch_size`` by repeating its last sample, and
    ``Batch.n_real`` records the true length. The feed stays on the host:
    the eval and training steps move it to the card, so no worker thread
    touches CUDA.

    Data-parallel input (a ``mesh``, or more than one process) is not
    ported yet and raises (``ROADMAP.md`` queue A, "Parallel")."""
    if mesh is not None or _multi_process():
        raise NotImplementedError(
            "batches_from_factory: data-parallel input (a mesh, or more than "
            "one process) is not ported yet: ROADMAP.md queue A, 'Parallel'")

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

    idx_batches = batch_indices(len(factory), batch_size, shuffle, seed,
                                pad_tail=pad_tail)
    for (d, batch), n_real in iter_batches(
            factory.__getitem__, idx_batches, collate,
            num_workers=cfg.num_workers):
        batch.n_real = n_real
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
    ``engine/hoi_model.py::make_eval_step``'s. The padded rows never reach
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
