"""Inference on one image with figures (port of
``hoigen_tpu/cli/inference.py``; reference inference.py:321-938): build
the model as the training CLI does, run the eval step on one image of the
test set, print the per-action pair listing and draw figures into
``--output-dir``. The reference's three modes (inference.py:333-397):

  * ``--action K``: one figure of every box pair predicted for action K
    with a score of at least ``--action-score-thresh``, the score at the
    human box's corner;
  * ``--action K --failure``: the same for the pairs below it;
  * default: print every predicted action with its (human, object)
    instance numbers, score and object name, then draw every instance box
    of a valid pair numbered 1..N and an overview of the top-k pairs.

  python -m hoigen_tpu_torch.cli.inference --index 0 --data-root ... \\
      --resume <ckpt> --output-dir visualization

The listing and the file names are the JAX CLI's. The figures are drawn
with Pillow (``PIL.ImageDraw``) where the JAX CLI uses matplotlib: the same
boxes, lines, colours and texts at the same image coordinates, on an image
of the original's size rather than a matplotlib canvas. Runs on CUDA
unless ``main`` is given ``device="cpu"``.
"""
import os

import numpy as np

from ..labels import HICO
from ..models.proposals import pair_indices

# matplotlib's tab10 colours that the JAX CLI names
BLUE, RED, GREEN = (31, 119, 180), (214, 39, 40), (44, 160, 44)
WHITE, BLACK = (255, 255, 255), (0, 0, 0)


def _font(size):
    from PIL import ImageFont
    return ImageFont.load_default(size=size)


def _canvas(image):
    from PIL import ImageDraw
    image = image.convert("RGB")
    return image, ImageDraw.Draw(image, "RGBA")


def _rect(box):
    """[x0, y0, x1, y1] with x0 <= x1 and y0 <= y1, as PIL requires
    (matplotlib draws a box of negative width as it comes)."""
    x1, y1, x2, y2 = (float(v) for v in box)
    return [min(x1, x2), min(y1, y2), max(x1, x2), max(y1, y2)]


def _save(image, out_path):
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    image.save(out_path)
    return out_path


def draw_boxes(image, boxes, out_path):
    """Every instance box in white, numbered 1..N at its top-left corner
    in white on a black outline (reference draw_boxes,
    inference.py:321-330)."""
    image, draw = _canvas(image)
    font = _font(20)
    for i, (x1, y1, x2, y2) in enumerate(np.asarray(boxes, np.float64)):
        draw.rectangle(_rect((x1, y1, x2, y2)), outline=WHITE, width=1)
        draw.text((x1, y1), str(i + 1), fill=WHITE, font=font,
                  stroke_width=2, stroke_fill=BLACK)
    return _save(image, out_path)


def draw_action_pairs(image, boxes_h, boxes_o, scores, out_path):
    """Every pair of one action: the human box blue, the object box red
    (5 wide), a green line between their centres, the score at the human
    box's corner (reference action branch, inference.py:352-371)."""
    image, draw = _canvas(image)
    font = _font(15)
    for bh, bo, s in zip(np.asarray(boxes_h, np.float64),
                         np.asarray(boxes_o, np.float64), np.asarray(scores)):
        for box, color in ((bh, BLUE), (bo, RED)):
            draw.rectangle(_rect(box), outline=color, width=5)
        draw.line([((bh[0] + bh[2]) / 2, (bh[1] + bh[3]) / 2),
                   ((bo[0] + bo[2]) / 2, (bo[1] + bo[3]) / 2)],
                  fill=GREEN, width=2)
        draw.text((bh[0], bh[1]), f"{s:.2f}", fill=WHITE, font=font,
                  stroke_width=2, stroke_fill=BLACK)
    return _save(image, out_path)


def draw_box_pairs(image, boxes_h, boxes_o, scores, labels, out_path,
                   top_k=10, action_names=None):
    """The top-k pairs by score, each labelled with its action name and
    score on a green box above the human box."""
    order = np.argsort(-np.asarray(scores))[:top_k]
    image, draw = _canvas(image)
    font = _font(9)
    for rank, i in enumerate(order):
        for box, color in ((boxes_h[i], BLUE), (boxes_o[i], RED)):
            draw.rectangle(_rect(box), outline=color, width=2)
        name = (action_names[int(labels[i])] if action_names is not None
                else str(int(labels[i])))
        xy = (float(boxes_h[i][0]), float(boxes_h[i][1]) - 3 - 12 * rank)
        text = f"{name}: {scores[i]:.2f}"
        draw.rectangle(draw.textbbox(xy, text, font=font),
                       fill=GREEN + (204,))
        draw.text(xy, text, fill=WHITE, font=font)
    return _save(image, out_path)


def main(argv=None, device=None):
    import argparse
    import dataclasses

    from ..data.factory import DataFactory, collate_batch
    from ..engine.checkpoint import latest_checkpoint
    from ..engine.hoi_model import init_hoi_model, make_eval_step, \
        resolve_device, to_device
    from ..engine.train import load_trainable
    from ..models.clip.model import init_clip_params
    from ..utils.config import RunConfig, add_args
    from .main_finetune import build_caches, load_pretrained, \
        make_model_config, maybe_gen_features

    parser = argparse.ArgumentParser(
        description="hoigen_tpu_torch: inference on one image")
    add_args(parser)
    parser.add_argument("--index", type=int, default=0)
    parser.add_argument("--image-path", default="")
    parser.add_argument("--action", type=int, default=None,
                        help="draw only this action id's pairs")
    parser.add_argument("--failure", action="store_true",
                        help="with --action: draw the pairs BELOW the "
                        "score threshold (reference inference.py:355)")
    parser.add_argument("--action-score-thresh", type=float, default=0.2)
    args = parser.parse_args(argv)
    cfg = RunConfig(**{f.name: getattr(args, f.name)
                       for f in dataclasses.fields(RunConfig)})

    import torch
    dev = resolve_device(device)
    model_cfg = make_model_config(cfg, dev)
    factory = DataFactory(cfg.dataset, "test2015" if cfg.dataset == "hicodet"
                          else "test", cfg.data_root, training=False,
                          host_clip_stream=cfg.host_clip_stream)
    gen = torch.Generator().manual_seed(cfg.seed)
    clip_params, detr_params, dino_params = load_pretrained(cfg, model_cfg,
                                                            gen)
    if clip_params is None:
        clip_params = init_clip_params(gen, model_cfg.clip, text=True)
    clip_params = to_device(clip_params, dev)
    caches, pair = build_caches(cfg, clip_params, model_cfg, factory)
    maybe_gen_features(cfg, clip_params, model_cfg, pair)
    params, buffers = init_hoi_model(
        gen, model_cfg, caches, clip_params=clip_params,
        detr_params=detr_params, dino_params=dino_params, device=dev)
    if cfg.resume and os.path.exists(cfg.resume):
        load_trainable(params, latest_checkpoint(cfg.resume)
                       if os.path.isdir(cfg.resume) else cfg.resume)

    batch = collate_batch([factory[args.index]], cfg.max_gt_pairs)
    feed = {
        "images": batch.images, "image_sizes": batch.image_sizes,
        "clip_sizes": batch.clip_sizes,
        "boxes_h": batch.boxes_h, "boxes_o": batch.boxes_o,
        "labels": batch.labels, "gt_valid": batch.gt_valid}
    if batch.images_clip is not None:
        feed["images_clip"] = batch.images_clip
    out = {k: v.cpu().numpy()
           for k, v in make_eval_step(model_cfg, dev)(params, buffers,
                                                      feed).items()}

    # the dense (P, C) matrix rebuilt from the compact LUT-gathered form
    # (np.maximum.at: the LUT's pad slots carry zeros and scores are >= 0,
    # so they never clobber a real verb-0 entry)
    cmp = out["detection_scores"][0]
    verbs = out["detection_verbs"][0]
    P = cmp.shape[0]
    scores_mat = np.zeros((P, model_cfg.upt.num_classes), cmp.dtype)
    np.maximum.at(scores_mat,
                  (np.repeat(np.arange(P), cmp.shape[1]), verbs.ravel()),
                  cmp.ravel())
    boxes = out["boxes"][0]
    objects = out["objects"][0]
    pair_valid = out["pair_valid"][0]
    px, py = (x.numpy() for x in pair_indices(model_cfg.upt.proposals))

    # boxes live in the CLIP frame: rescale to the original image's size
    # (reference visualise_entire_image :335-341)
    image = factory.dataset.load_image(args.index)
    ow, oh = image.size
    h, w = np.asarray(batch.clip_sizes[0])
    boxes = boxes * np.asarray([ow / w, oh / h, ow / w, oh / h])

    ps, cs = np.nonzero(scores_mat)
    sc = scores_mat[ps, cs]
    names = (HICO.hoi_prompts if cfg.num_classes == 600
             else HICO.verbs_sentence)

    if args.action is not None:
        # one figure of the requested action (scores >= thresh, or
        # < thresh in --failure mode)
        m = cs == args.action
        m &= ((sc < args.action_score_thresh) if args.failure
              else (sc >= args.action_score_thresh))
        out_path = os.path.join(
            cfg.output_dir,
            f"vis_{args.index:06d}_action_{args.action:03d}"
            f"{'_failure' if args.failure else ''}.png")
        draw_action_pairs(image, boxes[px[ps[m]]], boxes[py[ps[m]]],
                          sc[m], out_path)
        print(f"saved {out_path} ({int(m.sum())} pairs, "
              f"action '{names[args.action]}')")
        return

    # the numbered instance boxes: every slot of a valid pair
    valid_pairs = np.nonzero(pair_valid)[0]
    used = (np.unique(np.concatenate([px[valid_pairs], py[valid_pairs]]))
            if len(valid_pairs) else np.arange(0))
    # the printed numbers are the boxes figure's, which counts positions
    # within `used`
    slot_no = {int(slot): i + 1 for i, slot in enumerate(used)}

    # every predicted action with its pairs' numbers, score and object
    # (reference :377-387); numbers are 1-based like the figures'
    thresh_keep = sc >= args.action_score_thresh
    for verb in np.unique(cs[thresh_keep]):
        print(f"\n=> Action: {names[int(verb)]}")
        for j in np.nonzero((cs == verb) & thresh_keep)[0]:
            hi = slot_no.get(int(px[ps[j]]), int(px[ps[j]]) + 1)
            oi = slot_no.get(int(py[ps[j]]), int(py[ps[j]]) + 1)
            print(f"({hi:<2}, {oi:<2}), "
                  f"score: {sc[j]:.4f}, "
                  f"object: {HICO.objects[int(objects[ps[j]])]}.")
    boxes_path = os.path.join(cfg.output_dir,
                              f"vis_{args.index:06d}_boxes.png")
    draw_boxes(image, boxes[used], boxes_path)

    out_path = os.path.join(cfg.output_dir, f"vis_{args.index:06d}.png")
    draw_box_pairs(image, boxes[px[ps[thresh_keep]]],
                   boxes[py[ps[thresh_keep]]], sc[thresh_keep],
                   cs[thresh_keep], out_path, action_names=names)
    print(f"saved {boxes_path}, {out_path} ({int(thresh_keep.sum())} pairs "
          f"above {args.action_score_thresh})")


if __name__ == "__main__":
    main()
