"""Detector-output preparation and detection-level evaluation (port of
``hoigen_tpu/cli/detections.py``)::

  python -m hoigen_tpu_torch.cli.detections dump --data-root ... \\
      --pretrained checkpoints/detr-r50-hicodet.pth --out-dir detections/
  python -m hoigen_tpu_torch.cli.detections gt --data-root ... --out-dir gt/
  python -m hoigen_tpu_torch.cli.detections eval --det-dir detections/ \\
      --data-root ...
  python -m hoigen_tpu_torch.cli.detections vis --data-root ... --out-dir vis/
  python -m hoigen_tpu_torch.cli.detections remap --det-dir ... \\
      --label-map coco80tohico80.json --out-dir ...

The equivalent of the reference's hicodet/detections/{preprocessing.py,
generate_gt_detections.py, eval_detections.py} and the GT pair renderer
of visualise_and_cache.py. ``dump`` runs the DETR forward in f32 (full f32
on the card, where the encoder's fused attention stays off: its gate
needs bf16) and ``postprocess``, on CUDA unless ``main`` is given
``device="cpu"``; the other tasks run on the host. A DETR without
``--pretrained`` is drawn from a ``torch.Generator`` seeded with 0.
"""
import argparse
import json
import os

import numpy as np
import torch

from ..data.detections import dump_detections, eval_detections, \
    generate_gt_detections, remap_detections
from ..data.factory import DataFactory, collate_batch
from ..engine.hoi_model import full_f32, resolve_device, to_device
from ..models.detr.config import DETRConfig
from ..models.detr.model import detr_forward, init_detr_params, postprocess
from ..ops.pixels import device_normalize


def detr_batches(factory, params, cfg, batch_size, limit=None, device=None):
    """Yield (postprocessed numpy {scores, labels, boxes}, batch) over the
    first ``limit`` images of ``factory``, the DETR on ``device``."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def step(images, mask, clip_sizes):
        images, mask, clip_sizes = (torch.as_tensor(x).to(dev) for x in (
            images, mask, clip_sizes))
        with full_f32():
            out = detr_forward(params, device_normalize(images,
                                                        pad_mask=mask),
                               mask, cfg)
            post = postprocess(out["pred_logits"].float(),
                               out["pred_boxes"].float(), clip_sizes)
        return {k: v.cpu().numpy() for k, v in post.items()}

    n = len(factory) if limit is None else min(limit, len(factory))
    for lo in range(0, n, batch_size):
        idx = list(range(lo, min(lo + batch_size, n)))
        batch = collate_batch([factory[i] for i in idx], 8)
        yield step(batch.images, batch.image_mask, batch.clip_sizes), batch


def render_gt_pairs(dataset, out_dir, partition, limit=None):
    """GT pair renderer ({hicodet,vcoco}/utilities/visualise_and_cache.py:
    38-75): per image, one PNG per HOI/action class present, human box
    blue, object green, a red centre line joining the pair. Returns the
    directory written."""
    from PIL import ImageDraw
    n = len(dataset) if limit is None else min(limit, len(dataset))
    root = os.path.join(out_dir, partition)
    for idx in range(n):
        image = dataset.load_image(idx)
        target = dataset.target(idx)
        classes = np.asarray(target["hoi"] if "hoi" in target
                             else target["actions"])
        for cls_idx in np.unique(classes):
            img = image.copy()
            canvas = ImageDraw.Draw(img)
            for i in np.where(classes == cls_idx)[0]:
                b1 = np.asarray(target["boxes_h"][i], np.float64)
                b2 = np.asarray(target["boxes_o"][i], np.float64)
                canvas.rectangle(b1.tolist(), outline="#007CFF", width=5)
                canvas.rectangle(b2.tolist(), outline="#46FF00", width=5)
                ch = (b1[:2] + b1[2:]) / 2
                co = (b2[:2] + b2[2:]) / 2
                canvas.line(ch.tolist() + co.tolist(), fill="#FF4444",
                            width=5)
                for c in (ch, co):
                    canvas.ellipse((c - 5).tolist() + (c + 5).tolist(),
                                   fill="#FF4444")
            d = os.path.join(root, f"class_{int(cls_idx):03d}")
            os.makedirs(d, exist_ok=True)
            img.save(os.path.join(d, f"{idx}.png"))
    return root


def parser():
    p = argparse.ArgumentParser()
    p.add_argument("task", choices=["dump", "gt", "eval", "vis", "remap"])
    p.add_argument("--dataset", default="hicodet")
    p.add_argument("--partition", default="test2015")
    p.add_argument("--data-root", default="./datasets")
    p.add_argument("--out-dir", default="detections")
    p.add_argument("--det-dir", default="detections")
    p.add_argument("--pretrained", default="",
                   help="dump: DETR torch checkpoint to convert")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--score-thresh", type=float, default=0.0)
    p.add_argument("--min-iou", type=float, default=0.5)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--label-map", default="",
                   help="remap: json mapping of source label id (string) -> "
                        "HICO-80 id, e.g. the reference's coco80tohico80.json")
    return p


def main(argv=None, device=None):
    """Run one task; ``eval`` returns the per-class AP. ``device`` (None:
    CUDA; raises without a card) holds ``dump``'s DETR."""
    args = parser().parse_args(argv)

    if args.task == "remap":
        # an external detector's label surgery (the legacy Faster-RCNN
        # prep, hicodet/detections/preprocessing.py): no dataset or model
        with open(args.label_map) as f:
            label_map = json.load(f)
        n = remap_detections(args.det_dir, args.out_dir, label_map)
        print(f"remapped {n} detection files -> {args.out_dir}")
        return

    factory = DataFactory(args.dataset, args.partition, args.data_root,
                          training=False)
    dataset = factory.dataset

    if args.task == "gt":
        generate_gt_detections(dataset, args.out_dir)
        print(f"GT detections -> {args.out_dir}")
        return

    if args.task == "vis":
        root = render_gt_pairs(dataset, args.out_dir, args.partition,
                               args.limit)
        print(f"GT visualisations -> {root}")
        return

    if args.task == "eval":
        ap = eval_detections(args.det_dir, dataset, min_iou=args.min_iou,
                             limit=args.limit)
        mean = float(ap[ap > 0].mean() if (ap > 0).any() else 0.0)
        print(f"detection mAP: {mean:.4f} ({(ap > 0).sum()} classes with "
              "detections)")
        return ap

    # dump: run the (converted) DETR over the partition
    dev = resolve_device(device)
    cfg = DETRConfig(num_classes=81 if args.dataset == "hicodet" else 92)
    if args.pretrained and os.path.exists(args.pretrained):
        from ..models.convert_upt import load_torch_file
        from ..models.detr.convert import torch_detr_state_dict_to_params
        ckpt = load_torch_file(args.pretrained)
        sd = ckpt.get("model", ckpt.get("model_state_dict", ckpt))
        params, cfg = torch_detr_state_dict_to_params(sd)
        print(f"[load] {args.pretrained}")
    else:
        params = init_detr_params(torch.Generator().manual_seed(0), cfg)
        print("[warn] no --pretrained; random DETR")
    dump_detections(
        detr_batches(factory, to_device(params, dev), cfg, args.batch_size,
                     args.limit, dev),
        dataset, args.out_dir, score_thresh=args.score_thresh)
    print(f"detections -> {args.out_dir}")


if __name__ == "__main__":
    main()
