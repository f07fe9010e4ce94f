"""Detector-output preparation and detection-level evaluation.

Equivalents of reference/hicodet/detections/{preprocessing.py,
generate_gt_detections.py,eval_detections.py}: dump per-image detection
jsons from the DETR, generate GT detections, and score detection mAP
against ground truth with the same meter used for HOI eval.

Port of ``hoigen_tpu/data/detections.py``, the same algorithm in the same order
(the tests hold the two packages equal).
"""
import json
import os
from typing import Optional

import numpy as np

from ..eval import BoxAssociation, DetectionAPMeter


def dump_detections(run_batches, dataset, out_dir: str,
                    score_thresh: float = 0.0):
    """Write per-image detection jsons {boxes, labels, scores}
    (preprocessing.py format). run_batches yields (postprocessed, batch)
    where postprocessed has boxes/labels/scores per image in the CLIP
    frame; boxes are rescaled to original image size."""
    os.makedirs(out_dir, exist_ok=True)
    for post, batch in run_batches:
        boxes = np.asarray(post["boxes"])
        labels = np.asarray(post["labels"])
        scores = np.asarray(post["scores"])
        for i in range(boxes.shape[0]):
            ds_idx = int(batch.indices[i])
            ow, oh = dataset.image_size(ds_idx)
            h, w = batch.clip_sizes[i]
            scale = np.asarray([ow / w, oh / h, ow / w, oh / h])
            keep = scores[i] >= score_thresh
            name = os.path.splitext(dataset.filename(ds_idx))[0] + ".json"
            with open(os.path.join(out_dir, name), "w") as f:
                json.dump({
                    "boxes": (boxes[i][keep] * scale).tolist(),
                    "labels": labels[i][keep].tolist(),
                    "scores": scores[i][keep].tolist(),
                }, f)


def generate_gt_detections(dataset, out_dir: str):
    """GT boxes as perfect detections (generate_gt_detections.py);
    duplicate boxes (one instance in several pairs) are deduped."""
    os.makedirs(out_dir, exist_ok=True)
    for i in range(len(dataset)):
        tgt = dataset.target(i)
        boxes = np.concatenate([tgt["boxes_h"], tgt["boxes_o"]], 0)
        labels = np.concatenate([np.zeros(len(tgt["boxes_h"]), int),
                                 tgt.get("object", tgt.get("objects"))])
        _, uniq = np.unique(np.concatenate([boxes, labels[:, None]], 1),
                            axis=0, return_index=True)
        boxes, labels = boxes[sorted(uniq)], labels[sorted(uniq)]
        name = os.path.splitext(dataset.filename(i))[0] + ".json"
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump({"boxes": boxes.tolist(), "labels": labels.tolist(),
                       "scores": [1.0] * len(boxes)}, f)


def remap_detections(det_dir: str, out_dir: str, label_map: dict,
                     filenames=None) -> int:
    """Remap per-image detection jsons from an EXTERNAL detector's label
    space (e.g. torchvision Faster R-CNN's COCO-91 ids) into HICO-80 order,
    dropping detections of classes absent from the map — the label
    surgery of the reference's legacy Faster-RCNN prep
    (reference/hicodet/detections/preprocessing.py:16-63, which
    loads coco80tohico80.json and pops unmapped entries). Keys of
    ``label_map`` are source ids as strings (the json convention the
    reference uses); returns the number of files written."""
    os.makedirs(out_dir, exist_ok=True)
    names = filenames if filenames is not None else sorted(
        n for n in os.listdir(det_dir) if n.endswith(".json"))
    written = 0
    for name in names:
        path = os.path.join(det_dir, name)
        if not os.path.exists(path):
            continue
        with open(path) as f:
            det = json.load(f)
        keep = [(box, label_map[str(lab)], score)
                for box, lab, score in zip(det["boxes"], det["labels"],
                                           det["scores"])
                if str(lab) in label_map]
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump({"boxes": [k[0] for k in keep],
                       "labels": [k[1] for k in keep],
                       "scores": [k[2] for k in keep]}, f)
        written += 1
    return written


def eval_detections(det_dir: str, dataset, num_classes: int = 80,
                    min_iou: float = 0.5, algorithm: str = "11P",
                    limit: Optional[int] = None) -> np.ndarray:
    """Detection mAP of prepared detection files vs GT boxes
    (eval_detections.py). GT: humans are class 0 plus the annotated object
    boxes. Returns per-class AP."""
    assoc = BoxAssociation(min_iou=min_iou)
    meter = DetectionAPMeter(num_classes, algorithm=algorithm)
    n = len(dataset) if limit is None else min(limit, len(dataset))
    for i in range(n):
        name = os.path.splitext(dataset.filename(i))[0] + ".json"
        path = os.path.join(det_dir, name)
        if not os.path.exists(path):
            continue
        with open(path) as f:
            det = json.load(f)
        boxes = np.asarray(det["boxes"], np.float64).reshape(-1, 4)
        labels = np.asarray(det["labels"], int)
        scores = np.asarray(det["scores"], np.float64)
        tgt = dataset.target(i)
        gt_boxes = np.concatenate([tgt["boxes_h"], tgt["boxes_o"]], 0)
        gt_labels = np.concatenate([
            np.zeros(len(tgt["boxes_h"]), int),
            np.asarray(tgt.get("object", tgt.get("objects")))])
        binary = np.zeros(len(labels))
        for c in np.unique(labels):
            gt_idx = np.nonzero(gt_labels == c)[0]
            det_idx = np.nonzero(labels == c)[0]
            if len(gt_idx):
                binary[det_idx] = assoc(gt_boxes[gt_idx], boxes[det_idx],
                                        scores[det_idx])
        meter.append(scores, labels, binary)
    return meter.eval()
