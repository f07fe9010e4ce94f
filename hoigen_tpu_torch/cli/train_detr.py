"""Fine-tune the DETR detector on HICO-DET boxes, the offline detector
preparation (port of ``hoigen_tpu/cli/train_detr.py``)::

  python -m hoigen_tpu_torch.cli.train_detr --data-root ./datasets \\
      --epochs 10

The equivalent of reference/hicodet/detections/main_detr.py: the
COCO-pretrained DETR adapts to HICO-DET's 80 classes. Each step runs the
forward once on the device, moves the matching costs of every decoder
layer to the host for the Hungarian assignment (scipy), then computes the
SetCriterion losses of all layers (detr.py:222-247: every decoder layer
matched and scored, the losses summed) on the same outputs and updates.
The JAX CLI runs the forward twice (once for the costs, once under its
gradient), which computes the same values.

As in the JAX CLI the encoder's fused attention and the fused ResNet tail
stay off (K1 and K2 are not launched) and each backbone block is
recomputed in the backward (``remat_backbone``). Two optimizer groups,
``backbone`` and ``rest``, each with its own global-norm clip, AdamW with
``--weight-decay`` and a learning-rate drop after ``--lr-drop`` epochs
counted in updates (``engine/hoi_model.py::GroupedAdamW``). Runs in full
f32 on CUDA unless ``main`` is given ``device="cpu"``.

Differences from the JAX CLI: checkpoints are the port's own
(``engine/checkpoint.py``, ``ckpt_<epoch>.pt`` under ``--output-dir``,
the parameters by path as ``engine/train.py::Trainer`` saves them;
``--resume`` reads them, not Orbax directories), and a DETR without
``--pretrained`` is drawn from a ``torch.Generator`` seeded with
``--seed``.
"""
import argparse
import dataclasses
import functools
import os

import numpy as np
import torch

from ..data.factory import DataFactory, collate_batch
from ..engine.checkpoint import latest_checkpoint, restore_checkpoint, \
    save_checkpoint
from ..engine.hoi_model import GroupedAdamW, full_f32, resolve_device, \
    to_device
from ..engine.partition import mark_trainable, named_leaves
from ..engine.train import key_of, load_trainable
from ..models.detr.config import DETRConfig
from ..models.detr.model import detr_forward, init_detr_params
from ..ops.matching import detr_matching_cost, detr_set_criterion, \
    hungarian_assign
from ..ops.pixels import device_normalize


def detr_train_step_fns(cfg: DETRConfig, optimizer, coefs, aux_loss=True,
                        device=None):
    """coefs: set_cost_class/bbox/giou, eos_coef, bbox_loss_coef,
    giou_loss_coef. Returns (forward_and_cost, loss_and_update):

    ``forward_and_cost(params, images, mask, gt_labels, gt_boxes)`` ->
    (layers, costs): the per-layer (logits (L, B, Q, C+1), boxes (L, B, Q,
    4)) with their gradient graph, and the (L, B, Q, G) matching costs,
    computed without one;
    ``loss_and_update(layers, gt_labels, gt_boxes, gt_valid, rows, cols,
    mvalid)`` -> {"total", "final"}: the summed per-layer losses on those
    outputs, backward and one optimizer step (rows/cols/mvalid: (L, B, M)
    host matches)."""
    dev = resolve_device(device)
    cost_fn = functools.partial(detr_matching_cost,
                                cost_class=coefs["set_cost_class"],
                                cost_bbox=coefs["set_cost_bbox"],
                                cost_giou=coefs["set_cost_giou"])
    crit = functools.partial(detr_set_criterion,
                             eos_coef=coefs["eos_coef"],
                             bbox_loss_coef=coefs["bbox_loss_coef"],
                             giou_loss_coef=coefs["giou_loss_coef"])

    def as_t(x):
        return torch.as_tensor(np.asarray(x)).to(dev)

    def forward_and_cost(params, images, mask, gt_labels, gt_boxes):
        mask = as_t(mask)
        with full_f32():
            optimizer.zero_grad()
            out = detr_forward(params, device_normalize(as_t(images),
                                                        pad_mask=mask),
                               mask, cfg)
            layers = ((out["aux_logits"], out["aux_boxes"]) if aux_loss
                      else (out["pred_logits"][None],
                            out["pred_boxes"][None]))
            with torch.no_grad():
                # each decoder layer is matched on its own (SetCriterion's
                # aux_outputs loop, detr.py:240-247)
                costs = cost_fn(layers[0], layers[1],
                                as_t(gt_labels).long(), as_t(gt_boxes))
        return layers, costs

    def loss_and_update(layers, gt_labels, gt_boxes, gt_valid, rows, cols,
                        mvalid):
        gt_labels, gt_boxes, gt_valid = (as_t(x) for x in (
            gt_labels, gt_boxes, gt_valid))
        rows, cols, mvalid = (as_t(x) for x in (rows, cols, mvalid))
        with full_f32():
            totals = torch.stack([
                crit(lg, bx, gt_labels, gt_boxes, gt_valid, r, c, mv,
                     cfg.num_classes - 1)["total"]
                for lg, bx, r, c, mv in zip(*layers, rows, cols, mvalid)])
            loss = totals.sum()
            loss.backward()
            optimizer.step()
        return {"total": loss.detach(), "final": totals[-1].detach()}

    return forward_and_cost, loss_and_update


def match_layers(costs, gt_valid, max_gt):
    """Host Hungarian matches of (L, B, Q, G) costs (numpy) -> rows, cols
    (L, B, max_gt) int32 and their validity, padded with 0 / False."""
    n_layers, batch_size = costs.shape[:2]
    rows = np.zeros((n_layers, batch_size, max_gt), np.int32)
    cols = np.zeros((n_layers, batch_size, max_gt), np.int32)
    mvalid = np.zeros((n_layers, batch_size, max_gt), bool)
    for li in range(n_layers):
        for i in range(batch_size):
            r, c = hungarian_assign(costs[li, i], int(gt_valid[i].sum()))
            rows[li, i, :len(r)] = r
            cols[li, i, :len(c)] = c
            mvalid[li, i, :len(r)] = True
    return rows, cols, mvalid


def run_epoch(params, optimizer, factory, cfg, fns, batch_size, max_gt,
              log=print, log_every=50, seed=0):
    """One epoch over ``factory`` in a numpy permutation seeded with
    ``seed``, full batches only. -> the mean loss (nan without a step).
    The parameters are updated in place."""
    forward_and_cost, loss_and_update = fns
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(factory))
    losses_seen = []
    for it, lo in enumerate(range(0, len(order) - batch_size + 1,
                                  batch_size)):
        samples = [factory[int(i)] for i in order[lo:lo + batch_size]]
        b = collate_batch(samples, max_gt)
        gt_labels = b.objects.astype(np.int32)   # the detector learns objects
        layers, costs = forward_and_cost(params, b.images, b.image_mask,
                                         gt_labels, b.boxes_o)
        rows, cols, mvalid = match_layers(costs.cpu().numpy(), b.gt_valid,
                                          max_gt)
        losses = loss_and_update(layers, gt_labels, b.boxes_o, b.gt_valid,
                                 rows, cols, mvalid)
        losses_seen.append(float(losses["total"]))
        if (it + 1) % log_every == 0:
            log(f"iter {it + 1}: loss {np.mean(losses_seen[-log_every:]):.4f}")
    return float(np.mean(losses_seen)) if losses_seen else float("nan")


def lr_group_of(path) -> str:
    """'backbone' for the ResNet's leaves, 'rest' otherwise (the
    reference's lr_backbone group)."""
    return "backbone" if "backbone" in path else "rest"


def parser():
    p = argparse.ArgumentParser()
    p.add_argument("--data-root", default="./datasets")
    p.add_argument("--dataset", default="hicodet")
    p.add_argument("--partition", default="train2015")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr-backbone", type=float, default=1e-5)
    p.add_argument("--lr-drop", type=int, default=200)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--clip-max-norm", type=float, default=0.1)
    p.add_argument("--set-cost-class", type=float, default=1.0)
    p.add_argument("--set-cost-bbox", type=float, default=5.0)
    p.add_argument("--set-cost-giou", type=float, default=2.0)
    p.add_argument("--bbox-loss-coef", type=float, default=5.0)
    p.add_argument("--giou-loss-coef", type=float, default=2.0)
    p.add_argument("--eos-coef", type=float, default=0.1)
    p.add_argument("--no-aux-loss", action="store_true",
                   help="train on the final decoder layer only")
    p.add_argument("--seed", type=int, default=66)
    p.add_argument("--max-gt", type=int, default=32)
    p.add_argument("--pretrained", default="")
    p.add_argument("--resume", default="",
                   help="checkpoint (or the directory of checkpoints) to "
                   "continue from")
    p.add_argument("--output-dir", default="outputs/detr")
    return p


def main(argv=None, device=None):
    """Train and write a checkpoint an epoch; returns (params, the last
    epoch's mean loss). ``device``: None for CUDA (raises without a card),
    or "cpu"."""
    args = parser().parse_args(argv)
    dev = resolve_device(device)
    # the fused encoder attention and ResNet tail are kept off, as in the
    # JAX CLI; the backbone is recomputed in the backward
    off = dict(fused_encoder_attention=False, fused_resnet_tail=(),
               remat_backbone=True)
    cfg = DETRConfig(num_classes=81, **off)
    if args.pretrained and os.path.exists(args.pretrained):
        from ..models.convert_upt import load_torch_file
        from ..models.detr.convert import torch_detr_state_dict_to_params
        ckpt = load_torch_file(args.pretrained)
        sd = ckpt.get("model", ckpt.get("model_state_dict", ckpt))
        params, cfg = torch_detr_state_dict_to_params(sd)
        cfg = dataclasses.replace(cfg, **off)
        print(f"[load] {args.pretrained}")
    else:
        params = init_detr_params(torch.Generator().manual_seed(args.seed),
                                  cfg)
        print("[warn] training DETR from scratch (no --pretrained)")
    params = mark_trainable(to_device(params, dev), lambda path: True)

    factory = DataFactory(args.dataset, args.partition, args.data_root,
                          training=True, max_gt_pairs=args.max_gt)
    # the reference StepLR(lr_drop) counts epochs (main_detr.py:317-319);
    # the optimizer counts updates
    steps_per_epoch = max(len(factory) // args.batch_size, 1)
    optimizer = GroupedAdamW(
        named_leaves(params), {"backbone": args.lr_backbone,
                               "rest": args.lr},
        group=lr_group_of, weight_decay=args.weight_decay,
        lr_drop_step=args.lr_drop * steps_per_epoch,
        max_norm=args.clip_max_norm)
    start_epoch = 0
    if args.resume:
        path = latest_checkpoint(args.resume) or args.resume
        load_trainable(params, path)
        saved = restore_checkpoint(path)
        optimizer.load_state_dict(saved["opt_state"])
        start_epoch = int(saved["epoch"])
        print(f"[load] resumed from {path} (epoch {start_epoch})")

    coefs = {k: getattr(args, k) for k in
             ("set_cost_class", "set_cost_bbox", "set_cost_giou",
              "eos_coef", "bbox_loss_coef", "giou_loss_coef")}
    fns = detr_train_step_fns(cfg, optimizer, coefs,
                              aux_loss=not args.no_aux_loss, device=dev)
    avg = float("nan")
    for epoch in range(start_epoch, args.epochs):
        avg = run_epoch(params, optimizer, factory, cfg, fns,
                        args.batch_size, args.max_gt, seed=args.seed + epoch)
        print(f"[epoch {epoch + 1}/{args.epochs}] loss {avg:.4f}")
        save_checkpoint(args.output_dir, epoch + 1, {
            "trainable": {key_of(p): t.detach()
                          for p, t in named_leaves(params)},
            "opt_state": optimizer.state_dict(), "epoch": epoch + 1})
    return params, avg


if __name__ == "__main__":
    main()
