"""SHIP-style generator finetune: freeze the generator and the prompt
context, train an alignment MLP against cached GT crop features (port of
``hoigen_tpu/cli/finetune_ship.py``)::

  python -m hoigen_tpu_torch.cli.finetune_ship --data hoi_data \\
      --vae-ckpt ckpt/hicodet/hoi_vae_50.npz \\
      --gt-features new_gt_features/hoi.pickle \\
      --split-json crops/hicodet_hoi_split.json

Runs on CUDA unless ``main`` is given ``device="cpu"``; the step in full
f32. Writes ``<ckpt-dir>/<dataset>/<family>_mlp_<epochs>.npz`` with the JAX
CLI's keys. Differences from the JAX CLI: the MLP is drawn from a
``torch.Generator`` seeded with ``seed`` and z from one seeded with
``seed + 3`` (the JAX CLI uses ``jax.random`` keys of the same seeds); the
per-label draws of GT features are numpy's, the same as the JAX CLI's.
"""
import argparse
import os
import pickle

import numpy as np
import torch

from ..data.crops import CropDataset
from ..engine.hoi_model import full_f32, resolve_device, to_device
from ..models import generator as G
from .main_vae import adamw, family_classnames, load_family, normal, \
    trainable
from .prepare_data import load_clip


def clean_gt_features(gt_features):
    """{class: [array (N_c, 512)]} -> {class: L2-normalised rows}, rows
    holding a NaN dropped and empty classes left out
    (finetune_ship.py:469-472)."""
    clean = {}
    for c, v in gt_features.items():
        if not v:
            continue
        arr = np.asarray(v[0])
        arr = arr[~np.isnan(arr).any(axis=1)]
        if len(arr):
            clean[int(c)] = arr / np.linalg.norm(arr, axis=1, keepdims=True)
    return clean


def train_ship(clip_params, clip_cfg, gen_params, ctx, tables, gt_features,
               crop_dataset, epochs=50, batch_size=256, lr=1e-3, seed=0,
               log=print):
    """-> the trained MLP (a list of {w, b}) on the device of
    ``clip_params``. Each batch's labels come from ``crop_dataset``; each
    label gets one of its class's cached GT features, drawn by numpy
    (finetune_ship.py:485-492); labels without any are dropped."""
    dev = clip_params["text"]["token_embedding"].device
    clean = clean_gt_features(gt_features)
    gen_params = to_device(gen_params, dev)
    ctx = ctx.to(dev)
    dev_tables = G.tables_on(tables, dev)
    mlp, leaves = trainable(
        G.init_ship_mlp_params(torch.Generator().manual_seed(seed)), dev)
    opt = adamw(leaves, lr)
    rng = np.random.default_rng(seed)
    z_gen = torch.Generator().manual_seed(seed + 3)
    for epoch in range(1, epochs + 1):
        losses = []
        for _, labels in crop_dataset.batches(batch_size):
            keep = [i for i, c in enumerate(labels) if int(c) in clean]
            if not keep:
                continue
            labels = labels[keep]
            feats = np.stack([
                clean[int(c)][rng.integers(len(clean[int(c)]))]
                for c in labels])
            z = normal(z_gen, (len(labels), G.FEAT), dev)
            with full_f32():
                opt.zero_grad(set_to_none=True)
                loss = G.ship_step(mlp, gen_params, ctx, dev_tables,
                                   clip_params, clip_cfg,
                                   torch.as_tensor(feats).to(dev),
                                   torch.as_tensor(labels).to(dev).long(), z)
                loss.backward()
                opt.step()
            losses.append(loss.detach())
        mean = torch.stack(losses).mean().item() if losses else float("nan")
        log(f"SHIP epoch {epoch}/{epochs} loss {mean:.4f}")
    return mlp


def save_mlp(mlp, out_dir, family, epochs=50):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{family}_mlp_{epochs}.npz")
    np.savez(path, **{f"{i}.{k}": v.detach().cpu().numpy()
                      for i, lp in enumerate(mlp) for k, v in lp.items()})
    return path


def load_mlp(path, device="cpu"):
    """The MLP of a ``*_mlp_*.npz`` (either package's), as a list of
    {w, b} tensors on ``device``."""
    z = np.load(path)
    n = max(int(k.split(".")[0]) for k in z.files) + 1
    return [{k: torch.as_tensor(z[f"{i}.{k}"], device=device)
             for k in ("w", "b")} for i in range(n)]


def parser():
    p = argparse.ArgumentParser()
    p.add_argument("--data", default="hoi_data",
                   choices=["hoi_data", "human_data", "object_data"])
    p.add_argument("--dataset", default="hicodet_crop")
    p.add_argument("--vae-ckpt", required=True)
    p.add_argument("--gt-features", required=True)
    p.add_argument("--split-json", required=True)
    p.add_argument("--clip-model", default="")
    p.add_argument("--ckpt-dir", default="ckpt")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--zs", type=lambda s: s.lower() in ("1", "true"),
                   default=False)
    p.add_argument("--zs-type", default="rare_first")
    p.add_argument("--seed", type=int, default=66)
    return p


def main(argv=None, device=None):
    """Train one family's MLP and write its ``.npz``; returns the path.
    ``device``: None for CUDA (raises without a card), or "cpu"."""
    args = parser().parse_args(argv)
    dev = resolve_device(device)
    clip_params, clip_cfg = load_clip(args.clip_model, dev)
    vae = load_family(args.vae_ckpt)
    names = family_classnames(args.dataset, args.data, args.zs, args.zs_type)
    tables = G.build_prompt_tables(
        names, clip_params["text"]["token_embedding"], vae["ctx"].shape[0])
    with open(args.gt_features, "rb") as f:
        gt = pickle.load(f)
    crops = CropDataset(args.split_json, "train", training=True,
                        seed=args.seed)
    mlp = train_ship(clip_params, clip_cfg, vae["gen"], vae["ctx"], tables,
                     gt, crops, args.epochs, args.batch_size, args.lr,
                     args.seed)
    family = args.data.split("_")[0]
    out = save_mlp(mlp, os.path.join(args.ckpt_dir,
                                     args.dataset.split("_")[0]),
                   family, args.epochs)
    print(f"saved {out}")
    return out


if __name__ == "__main__":
    main()
