"""A synthetic V-COCO tree on disk (port of
``tools/make_fixture.py::build_vcoco``, the same files for the same
arguments):

    <root>/instances_vcoco_{trainval,test}.json
    <root>/images/{train2014,val2014}/COCO_<dir>_<i:012d>.jpg

Tiny random JPEGs (64 x 48), each with one or two annotated pairs whose
actions and objects are drawn from ``VCOCO_LABELS`` (the 24 actions, the
80 objects, the valid action-object table).
:func:`annotate_vcoco_from_detections` then rewrites a partition's ground
truth from a model's own detections, so that a model with random weights
scores true positives. Used by ``chip_smoke.py`` (phase 8) and the port's
tests.
"""
import json
import os

import numpy as np

from ..engine.eval import _extract_detections
from ..labels import VCOCO_LABELS
from ..models.proposals import pair_indices


def build_vcoco(root: str, n_images: int = 4, seed: int = 0) -> str:
    """Write both partitions of ``n_images`` images each from numpy's
    generator seeded with ``seed``. Returns ``root``."""
    from PIL import Image

    v = VCOCO_LABELS
    rng = np.random.default_rng(seed)
    actions = [v.values[next(i for i, k in enumerate(v.keys)
                             if k[0] == a)][0] for a in range(24)]
    objects = ["background"] + list(v.object_name)
    a2o = [sorted({k[1] for k in v.keys if k[0] == a}) for a in range(24)]
    os.makedirs(root, exist_ok=True)
    for part, img_dir_name, n in (("trainval", "train2014", n_images),
                                  ("test", "val2014", n_images)):
        img_dir = os.path.join(root, "images", img_dir_name)
        os.makedirs(img_dir, exist_ok=True)
        annos, images = [], []
        for i in range(n):
            w, h = 64, 48
            name = f"COCO_{img_dir_name}_{i:012d}.jpg"
            Image.fromarray(rng.integers(0, 255, (h, w, 3),
                                         dtype=np.uint8)) \
                .save(os.path.join(img_dir, name))
            k = int(rng.integers(1, 3))
            acts = rng.integers(0, 24, k).tolist()
            objs = [int(rng.choice(a2o[a])) for a in acts]
            annos.append({"boxes_h": [[2, 2, 30, 30]] * k,
                          "boxes_o": [[5, 5, 40, 40]] * k,
                          "actions": acts, "objects": objs,
                          "file_name": name})
            images.append(1000 + i)
        inst = {"annotations": annos, "classes": actions,
                "objects": objects, "images": images,
                "action_to_object": a2o}
        with open(os.path.join(root, f"instances_vcoco_{part}.json"),
                  "w") as f:
            json.dump(inst, f)
    return root


def annotate_vcoco_from_detections(root, runs, proposal_cfg,
                                   partition="test", top=2):
    """Rewrite ``partition``'s ground truth as each image's ``top``
    highest-scoring detections in ``runs`` (the (outputs, batch) pairs of
    a V-COCO evaluation, action ids as classes), boxes back in the
    image's pixels, objects as V-COCO's 1-based ids of the detector's
    labels. An image without a detection keeps its own. Returns the
    number of images rewritten. Every image of a tree that
    :func:`build_vcoco` wrote has pairs, so a dataset index is an
    annotation's index."""
    from PIL import Image

    path = os.path.join(root, f"instances_vcoco_{partition}.json")
    with open(path) as f:
        inst = json.load(f)
    img_dir = os.path.join(root, "images", "train2014"
                           if partition == "trainval" else "val2014")
    px, py = (np.asarray(x) for x in pair_indices(proposal_cfg))
    n = 0
    for outputs, batch in runs:
        for i, idx in enumerate(batch.indices):
            det = _extract_detections(
                outputs["detection_scores"][i], outputs["boxes"][i],
                outputs["objects"][i], px, py, outputs["detection_verbs"][i])
            best = np.argsort(-det["scores"], kind="stable")[:top]
            if not len(best):
                continue
            anno = inst["annotations"][idx]
            with Image.open(os.path.join(img_dir, anno["file_name"])) as im:
                ow, oh = im.size
            h, w = batch.clip_sizes[i]
            scale = np.asarray([ow / w, oh / h, ow / w, oh / h])
            anno.update(
                boxes_h=(det["boxes_h"][best] * scale).tolist(),
                boxes_o=(det["boxes_o"][best] * scale).tolist(),
                actions=[int(det["verbs"][j]) for j in best],
                objects=[int(det["objects"][j]) + 1 for j in best])
            n += 1
    with open(path, "w") as f:
        json.dump(inst, f)
    return n
