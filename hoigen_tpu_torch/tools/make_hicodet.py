"""A synthetic HICO-DET tree on disk, in the real dataset's layout:

    <root>/instances_<partition>.json
    <root>/hico_20160224_det/images/<partition>/HICO_<partition>_<i>.jpg

Images are random uint8 pixels saved as JPEG at the given (width, height)
sizes; each has 1 to ``MAX_PAIRS`` ground-truth pairs, boxes inside the
image, interaction classes drawn from ``HICO.class_corr``. The schema is
that of the JAX package's ``tools/make_fixture.py::build``.
:func:`annotate_from_detections` then rewrites a partition's ground truth
from a model's own detections, so that a model with random weights scores
true positives. Used by ``chip_smoke.py`` (phase 7) and the port's
tests.
"""
import json
import os

import numpy as np

from ..engine.eval import _extract_detections
from ..labels import HICO
from ..models.proposals import pair_indices

MAX_PAIRS = 3


def write_hicodet(root, sizes, seed=0):
    """Write the test2015 and train2015 partitions, each with one image
    of every (width, height) in ``sizes``, from numpy's generator seeded
    with ``seed``. Returns ``root``."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for part in ("test2015", "train2015"):
        img_dir = os.path.join(root, "hico_20160224_det", "images", part)
        os.makedirs(img_dir, exist_ok=True)
        names, annos = [], []
        for i, (w, h) in enumerate(sizes):
            name = f"HICO_{part}_{i:08d}.jpg"
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)) \
                .save(os.path.join(img_dir, name))
            names.append(name)
            anno = {"boxes_h": [], "boxes_o": [], "hoi": [], "verb": [],
                    "object": []}
            for _ in range(int(rng.integers(1, MAX_PAIRS + 1))):
                for key in ("boxes_h", "boxes_o"):
                    x0, y0 = rng.integers(0, w // 2), rng.integers(0, h // 2)
                    x1 = rng.integers(x0 + w // 8, w + 1)
                    y1 = rng.integers(y0 + h // 8, h + 1)
                    anno[key].append([int(x0), int(y0), int(x1), int(y1)])
                hoi, obj, verb = HICO.class_corr[int(rng.integers(0, 600))]
                anno["hoi"].append(int(hoi))
                anno["verb"].append(int(verb))
                anno["object"].append(int(obj))
            annos.append(anno)
        inst = {"annotation": annos, "filenames": names, "empty": [],
                "objects": HICO.objects, "verbs": HICO.verbs,
                "correspondence": HICO.class_corr,
                "size": [list(s) for s in sizes]}
        with open(os.path.join(root, f"instances_{part}.json"), "w") as f:
            json.dump(inst, f)
    return root


def annotate_from_detections(root, runs, proposal_cfg,
                             partition="test2015", top=2):
    """Rewrite ``partition``'s ground truth as each image's ``top``
    highest-scoring detections in ``runs`` (the (outputs, batch) pairs of
    an evaluation whose classes are interaction ids, as ``evaluate_hico``
    takes them at any class count but 117), boxes back in the image's
    pixels. An image without a detection keeps its own. Returns the
    number of images rewritten."""
    path = os.path.join(root, f"instances_{partition}.json")
    with open(path) as f:
        inst = json.load(f)
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
            ow, oh = inst["size"][idx]
            h, w = batch.clip_sizes[i]
            scale = np.asarray([ow / w, oh / h, ow / w, oh / h])
            hois = [int(det["verbs"][j]) for j in best]
            inst["annotation"][idx] = {
                "boxes_h": (det["boxes_h"][best] * scale).tolist(),
                "boxes_o": (det["boxes_o"][best] * scale).tolist(),
                "hoi": hois,
                "verb": [int(HICO.class_corr[x][2]) for x in hois],
                "object": [int(HICO.class_corr[x][1]) for x in hois]}
            n += 1
    with open(path, "w") as f:
        json.dump(inst, f)
    return n
