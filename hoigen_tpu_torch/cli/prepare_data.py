"""Data preparation: crop extraction, split jsons, and the feature
artifacts the reference only ships pre-computed (port of
``hoigen_tpu/cli/prepare_data.py``)::

  python -m hoigen_tpu_torch.cli.prepare_data crops --dataset hicodet ...
  python -m hoigen_tpu_torch.cli.prepare_data pair-embeddings ...
  python -m hoigen_tpu_torch.cli.prepare_data gt-features ...
  python -m hoigen_tpu_torch.cli.prepare_data global-caches ...
  python -m hoigen_tpu_torch.cli.prepare_data vcoco-annotations ...

The crop and split writers and the V-COCO annotation generator run on the
host; the CLIP encodes (frozen, no adapters, full f32) and the DINO
encodes of ``global-caches`` run on CUDA unless ``main`` is given
``device="cpu"``. ``global-caches`` writes ``caches/dataset/`` relative to
the working directory, as the JAX CLI does.

Differences from the JAX CLI: a missing CLIP checkpoint is drawn from a
``torch.Generator`` seeded with 0, and ``global-caches``' random DINO from
one seeded with 1 (the JAX CLI draws both from ``jax.random`` keys 0 and 1);
the device crop encoder takes the image at its own size (the JAX one pads
it to a /128 bucket to limit recompiles, which changes no value).
"""
import argparse
import os

import numpy as np
import torch

from ..data.crops import (CropDataset, build_split_json, extract_crops,
                          make_device_crop_encoder, produce_gt_features,
                          produce_pair_embeddings)
from ..data.factory import DataFactory
from ..engine.hoi_model import full_f32, resolve_device, to_device
from ..labels import HICO
from ..models.cache import build_global_cache
from ..models.clip.config import VIT_B16
from ..models.clip.model import encode_image, init_clip_params


def load_clip(path, device):
    """(params, cfg) of the frozen CLIP (no adapters, text tower included)
    from the torch checkpoint at ``path``, or random from a generator
    seeded with 0 when the file is missing, on ``device``."""
    if path and os.path.exists(path):
        from ..models.clip.convert import torch_state_dict_to_params
        from ..models.convert_upt import load_torch_file
        obj = load_torch_file(path)
        sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
        params, cfg = torch_state_dict_to_params(dict(sd), use_adapter=False)
    else:
        print("[warn] no CLIP checkpoint; random init")
        cfg = VIT_B16
        params = init_clip_params(torch.Generator().manual_seed(0), cfg,
                                  text=True)
    return to_device(params, device), cfg


def clip_apply_fn(clip_params, clip_cfg):
    """images (N, 3, r, r) numpy, any dtype -> (N, embed) float32 numpy:
    CLIP's global features, encoded on the params' device in full f32."""
    dev = clip_params["logit_scale"].device

    def apply(images):
        x = torch.as_tensor(np.asarray(images)).to(dev).float()
        with torch.no_grad(), full_f32():
            return encode_image(clip_params, x, clip_cfg)[0].cpu().numpy()
    return apply


def _l2_rows(x):
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-8)


def parser():
    p = argparse.ArgumentParser()
    p.add_argument("task", choices=["crops", "pair-embeddings",
                                    "gt-features", "global-caches",
                                    "vcoco-annotations"])
    p.add_argument("--dataset", default="hicodet")
    p.add_argument("--partition", default="train2015")
    p.add_argument("--data-root", default="./datasets")
    p.add_argument("--out-dir", default="./crops")
    p.add_argument("--category", default="hoi",
                   choices=["hoi", "human", "object"])
    p.add_argument("--clip-model", default="")
    p.add_argument("--split-json", default="")
    p.add_argument("--out", default="")
    p.add_argument("--num-classes", type=int, default=600)
    p.add_argument("--num-shot", type=int, default=2)
    p.add_argument("--zs", type=lambda s: s.lower() in ("1", "true"),
                   default=False)
    p.add_argument("--zs-type", default="rare_first")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pickle", default="",
                   help="vcoco-annotations: the official repo's cached "
                   "vcoco_all pickle")
    p.add_argument("--vsrl-partition", type=int, default=0,
                   help="vcoco-annotations: 0 = train/val/trainval "
                   "(COCO train2014 filenames), 1 = test (val2014)")
    p.add_argument("--host-crops", action="store_true",
                   help="pair-embeddings: host PIL crop path instead of "
                   "the on-device crop+CLIP encoder")
    return p


def main(argv=None, device=None):
    """Run one task. ``device`` (None: CUDA; raises without a card) holds
    the CLIP and DINO encodes."""
    args = parser().parse_args(argv)

    if args.task == "vcoco-annotations":
        from ..data.vcoco import generate_vcoco_annotations
        out = generate_vcoco_annotations(args.pickle, args.vsrl_partition,
                                         out=args.out or None)
        print(f"vcoco annotations -> {out}")
        return

    if args.task != "gt-features":   # gt-features only needs the split json
        factory = DataFactory(args.dataset, args.partition, args.data_root,
                              training=False)
        dataset = factory.dataset

    if args.task == "crops":
        items = extract_crops(dataset, args.out_dir, args.category,
                              limit=args.limit)
        excluded = HICO.unseen_index[args.zs_type] if (
            args.zs and args.category == "hoi") else ()
        out = args.out or os.path.join(
            args.out_dir, f"{args.dataset}_{args.category}_split.json")
        build_split_json(items, out, excluded_classes=excluded,
                         seed=args.seed)
        print(f"{len(items)} crops -> {out}")
        return

    dev = resolve_device(device)
    clip_params, clip_cfg = load_clip(args.clip_model, dev)
    apply_fn = clip_apply_fn(clip_params, clip_cfg)

    if args.task == "pair-embeddings":
        out = args.out or ("hicodet_pkl_files/union_embeddings_cachemodel_"
                           "crop_padding_zeros_vitb16.p")
        crop_encoder = None if args.host_crops else \
            make_device_crop_encoder(clip_params, clip_cfg)
        produce_pair_embeddings(dataset, apply_fn, out, limit=args.limit,
                                crop_encoder=crop_encoder)
        print(f"pair embeddings -> {out}")
    elif args.task == "gt-features":
        crops = CropDataset(args.split_json, "train", training=False)
        out = args.out or f"new_gt_features/{args.category}.pickle"
        produce_gt_features(crops, apply_fn, args.num_classes, out)
        print(f"gt features -> {out}")
    elif args.task == "global-caches":
        # one pass over the stream encoding whole (CLIP-frame) uint8 images,
        # unnormalised, as the JAX CLI feeds them
        feats, multihots = [], []
        n = len(factory) if args.limit is None else min(args.limit,
                                                        len(factory))
        for i in range(n):
            _, clip_img, tgt, _ = factory[i]
            feats.append(clip_img)
            mh = np.zeros(args.num_classes, np.float32)
            mh[np.asarray(tgt["labels"], int)] = 1
            multihots.append(mh)
        embs = _l2_rows(np.concatenate([
            apply_fn(np.stack(feats[lo:lo + 64]))
            for lo in range(0, len(feats), 64)]))
        clip_keys, clip_values = build_global_cache(
            embs, np.stack(multihots), args.num_classes, args.num_shot,
            seed=args.seed)
        from ..models.dino import dino_forward, init_dino_params
        dino_params = to_device(
            init_dino_params(torch.Generator().manual_seed(1)), dev)
        with torch.no_grad(), full_f32():
            dembs = _l2_rows(np.concatenate([
                dino_forward(dino_params, torch.as_tensor(
                    np.stack(feats[lo:lo + 64])).to(dev).float())
                .cpu().numpy() for lo in range(0, len(feats), 64)]))
        dino_keys, dino_values = build_global_cache(
            dembs, np.stack(multihots), args.num_classes, args.num_shot,
            seed=args.seed)
        tag = f"{args.zs_type}_{args.num_shot}" if args.zs else "2shots"
        # num_classes is part of the name: a 600-class cache must not be
        # picked up by a 117-class run (row counts differ)
        out = args.out or os.path.join(
            "caches", "dataset",
            f"{args.dataset}_{args.num_classes}_global_{tag}.npz")
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        np.savez(out, clip_keys=clip_keys, clip_values=clip_values,
                 dino_keys=dino_keys, dino_values=dino_values)
        print(f"global caches -> {out}")


if __name__ == "__main__":
    main()
