"""The data layer of training from HICO-DET files in plain Python, the
reference of the JPEG cell: an annotation file and its images read, the
zero-shot filter, each sample's transform drawn from (seed, epoch, index)
(``transforms.py``, a frozen copy of the port's), the DETR stream padded
into the batch's bucket in uint8 with its sizes, the ground truth padded
to 32 pairs, and the shuffled order of an epoch's batches."""
import json
import os

import numpy as np
from PIL import Image

from .transforms import DualStreamTransform

BUCKETS = ((800, 1344), (1344, 800), (1088, 1088), (1344, 1344))


def pick_bucket(h, w):
    fitting = [b for b in BUCKETS if b[0] >= h and b[1] >= w]
    if not fitting:
        return max(BUCKETS, key=lambda b: b[0] * b[1])
    return min(fitting, key=lambda b: b[0] * b[1])


class TrainFiles:
    """``instances_train2015.json`` and its images under ``root``, the
    images holding at least one seen interaction kept (``unseen``: the
    zero-shot setting's unseen interaction ids, or None)."""

    def __init__(self, root, unseen, seed, clip_resolution=224):
        with open(os.path.join(root, "instances_train2015.json")) as f:
            inst = json.load(f)
        self.dir = os.path.join(root, "hico_20160224_det", "images",
                                "train2015")
        empty = set(inst["empty"])
        self.names = inst["filenames"]
        self.annos = inst["annotation"]
        idx = [i for i in range(len(self.names)) if i not in empty]
        self.unseen = set(unseen or ())
        self.keep = [i for i in idx if not self.unseen
                     or set(self.annos[i]["hoi"]) - self.unseen]
        self.seed = seed
        self.transform = DualStreamTransform(True, clip_resolution, seed,
                                             host_clip_stream=False)

    def sample(self, i, epoch):
        idx = self.keep[i]
        a = self.annos[idx]
        bh = np.asarray(a["boxes_h"], np.float32)
        bo = np.asarray(a["boxes_o"], np.float32)
        if len(bh):
            bh[:, :2] -= 1
            bo[:, :2] -= 1
        target = {"boxes_h": bh, "boxes_o": bo,
                  "hoi": np.asarray(a["hoi"], np.int32),
                  "verb": np.asarray(a["verb"], np.int32),
                  "object": np.asarray(a["object"], np.int32)}
        if self.unseen:
            m = ~np.isin(target["hoi"], sorted(self.unseen))
            target = {k: v[m] for k, v in target.items()}
        target["labels"] = target["verb"]
        image = Image.open(os.path.join(self.dir, self.names[idx])) \
            .convert("RGB")
        rng = np.random.default_rng((self.seed, epoch, idx))
        img, _, target = self.transform(image, target, rng=rng)
        return img, target


def epoch_batches(n, batch_size, seed):
    """The index batches of a shuffled epoch (the ragged tail dropped)."""
    order = np.random.default_rng(seed).permutation(n)
    stop = (n // batch_size) * batch_size
    return [order[lo:lo + batch_size] for lo in range(0, stop, batch_size)]


def collate(samples, max_gt=32, clip_resolution=224):
    """The feed of one batch, as the training step takes it."""
    b = len(samples)
    hb = wb = 0
    for img, _ in samples:
        bh, bw = pick_bucket(img.shape[1], img.shape[2])
        hb, wb = max(hb, bh), max(wb, bw)
    feed = {"images": np.zeros((b, 3, hb, wb), np.uint8),
            "image_sizes": np.zeros((b, 2), np.int32),
            "clip_sizes": np.full((b, 2), float(clip_resolution),
                                  np.float32),
            "boxes_h": np.zeros((b, max_gt, 4), np.float32),
            "boxes_o": np.zeros((b, max_gt, 4), np.float32),
            "labels": np.zeros((b, max_gt), np.int32),
            "gt_valid": np.zeros((b, max_gt), bool)}
    for i, (img, t) in enumerate(samples):
        _, h, w = img.shape
        feed["images"][i, :, :h, :w] = img
        feed["image_sizes"][i] = (h, w)
        n = min(len(t["boxes_h"]), max_gt)
        feed["boxes_h"][i, :n] = t["boxes_h"][:n]
        feed["boxes_o"][i, :n] = t["boxes_o"][:n]
        feed["labels"][i, :n] = t["labels"][:n]
        feed["gt_valid"][i, :n] = True
    return feed
