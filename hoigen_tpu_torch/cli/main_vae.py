"""Train the CoOp+VAE feature generator for one crop family (port of
``hoigen_tpu/cli/main_vae.py``)::

  python -m hoigen_tpu_torch.cli.main_vae --data hoi_data \\
      --split-json crops/hicodet_hoi_split.json --clip-model <ViT-B-16.pt>

Per family (hoi / human / object): the encoder, generator and prompt
context learn to reconstruct frozen-CLIP crop features through the
prompted text tower (MSE + KLD), 50 epochs, batch 256, AdamW at 1e-3 with
optax's weight decay of 1e-4. The crop encode runs under no grad; the step
in full f32, on CUDA unless ``main`` is given ``device="cpu"``. The frozen
CLIP takes no gradient and no optimizer state.

Written to ``<ckpt-dir>/<dataset>/<family>_vae_<epochs>.npz`` with the JAX
CLI's keys, so that either package's :func:`load_family` reads the other's
file. Differences from the JAX CLI: the initial weights are drawn from
``torch.Generator`` s seeded with ``seed``, ``seed + 1`` and ``seed + 2``,
and the reparameterisation noise from one seeded with ``seed + 7`` (the
JAX CLI uses ``jax.random`` keys of the same seeds).
"""
import argparse
import os

import numpy as np
import torch

from ..data.crops import CropDataset
from ..engine.hoi_model import full_f32, resolve_device, to_device
from ..engine.partition import mark_trainable, named_leaves
from ..labels import HICO, VCOCO_LABELS
from ..models import generator as G
from ..models.clip.model import encode_image
from .prepare_data import load_clip


def family_classnames(dataset: str, data: str, zs: bool, zs_type: str):
    """Class-name list per family (main_coop_vae.py seen_classnames logic:
    zero-shot training uses seen-only names)."""
    if data == "hoi_data":
        if dataset.startswith("hicodet"):
            return (HICO.seen_classnames if zs else HICO.all_classnames)
        return [f"{v} {o}" for v, o in (VCOCO_LABELS.seen_values if zs
                                        else VCOCO_LABELS.values)]
    if data == "human_data":
        if dataset.startswith("hicodet"):
            return (HICO.human_seen_name if zs and zs_type ==
                    "unseen_object" else HICO.human_name)
        return (VCOCO_LABELS.human_seen_values if zs
                else VCOCO_LABELS.human_name)
    if dataset.startswith("hicodet"):
        return (HICO.object_seen_name if zs and zs_type == "unseen_object"
                else HICO.object_name)
    return (VCOCO_LABELS.object_seen_values if zs
            else VCOCO_LABELS.object_name)


def adamw(params, lr):
    """AdamW as optax.adamw(lr): b1 0.9, b2 0.999, eps 1e-8 and a weight
    decay of 1e-4 (``torch.optim.AdamW`` would decay by 1e-2)."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def normal(gen, shape, device):
    """Standard normal draws from the CPU generator ``gen``, on
    ``device`` (a seed gives the same draws on every device)."""
    return torch.randn(shape, generator=gen).to(device)


def trainable(tree, device):
    """``tree``'s tensors on ``device``, each requiring grad; -> (tree,
    list of its leaves)."""
    tree = mark_trainable(to_device(tree, device), lambda path: True)
    return tree, [t for _, t in named_leaves(tree)]


def train_vae(clip_params, clip_cfg, crop_dataset, classnames, n_ctx,
              epochs=50, batch_size=256, lr=1e-3, seed=0, log=print,
              ctx_init=""):
    """-> (params {enc, gen, ctx}, tables), on the device of
    ``clip_params``."""
    dev = clip_params["text"]["token_embedding"].device
    token_embedding = clip_params["text"]["token_embedding"]
    if ctx_init:
        # context initialised from the given words; n_ctx becomes the
        # phrase's token count (PromptLearner :98-106)
        ctx, n_ctx = G.init_prompt_ctx_from_text(ctx_init, token_embedding)
    else:
        ctx = G.init_prompt_ctx(torch.Generator().manual_seed(seed + 2),
                                n_ctx)
    params = {"enc": G.init_encoder_params(
                  torch.Generator().manual_seed(seed)),
              "gen": G.init_generator_params(
                  torch.Generator().manual_seed(seed + 1)),
              "ctx": ctx}
    params, leaves = trainable(params, dev)
    tables = G.build_prompt_tables(classnames, token_embedding, n_ctx)
    dev_tables = G.tables_on(tables, dev)
    opt = adamw(leaves, lr)
    noise_gen = torch.Generator().manual_seed(seed + 7)
    for epoch in range(1, epochs + 1):
        losses = []
        for images, labels in crop_dataset.batches(batch_size):
            with torch.no_grad(), full_f32():
                feats = encode_image(clip_params,
                                     torch.as_tensor(images).to(dev),
                                     clip_cfg)[0]
                feats = feats / torch.linalg.vector_norm(feats, dim=-1,
                                                         keepdim=True)
            target = torch.as_tensor(labels).to(dev).long()
            noise = normal(noise_gen, feats.shape, dev)
            with full_f32():
                opt.zero_grad(set_to_none=True)
                loss = G.vae_step(params, dev_tables, clip_params, clip_cfg,
                                  feats, target, noise)
                loss.backward()
                opt.step()
            losses.append(loss.detach())
        mean = torch.stack(losses).mean().item() if losses else float("nan")
        log(f"VAE epoch {epoch}/{epochs} loss {mean:.4f}")
    return params, tables


def _np(t):
    return t.detach().cpu().numpy()


def save_family(params, out_dir, family, epochs=50):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{family}_vae_{epochs}.npz")
    flat = {"ctx": _np(params["ctx"])}
    for mod in ("enc", "gen"):
        for k, v in params[mod].items():
            flat[f"{mod}.{k}.w"] = _np(v["w"])
            flat[f"{mod}.{k}.b"] = _np(v["b"])
    np.savez(path, **flat)
    return path


def load_family(path, device="cpu"):
    """{ctx, enc, gen} of a ``*_vae_*.npz`` (either package's), as tensors
    on ``device``."""
    z = np.load(path)
    params = {"ctx": torch.as_tensor(z["ctx"], device=device),
              "enc": {}, "gen": {}}
    for k in z.files:
        if k == "ctx":
            continue
        mod, name, wb = k.split(".")
        params[mod].setdefault(name, {})[wb] = torch.as_tensor(
            z[k], device=device)
    return params


def parser():
    p = argparse.ArgumentParser()
    p.add_argument("--data", default="hoi_data",
                   choices=["hoi_data", "human_data", "object_data"])
    p.add_argument("--dataset", default="hicodet_crop")
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
    p.add_argument("--ctx-init", default="",
                   help="words to initialize the CoOp context (e.g. "
                   "'a photo of a person'); overrides the n_ctx default")
    return p


def main(argv=None, device=None):
    """Train one family and write its ``.npz``; returns the path.
    ``device``: None for CUDA (raises without a card), or "cpu"."""
    args = parser().parse_args(argv)
    dev = resolve_device(device)
    clip_params, clip_cfg = load_clip(args.clip_model, dev)
    names = family_classnames(args.dataset, args.data, args.zs, args.zs_type)
    n_ctx = 5 if args.data == "hoi_data" else 4
    crops = CropDataset(args.split_json, "train", training=True,
                        seed=args.seed)
    params, _ = train_vae(clip_params, clip_cfg, crops, names, n_ctx,
                          args.epochs, args.batch_size, args.lr, args.seed,
                          ctx_init=args.ctx_init)
    family = args.data.split("_")[0]
    out = save_family(params, os.path.join(args.ckpt_dir,
                                           args.dataset.split("_")[0]),
                      family, args.epochs)
    print(f"saved {out}")
    return out


if __name__ == "__main__":
    main()
