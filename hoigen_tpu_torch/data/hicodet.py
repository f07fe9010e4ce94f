"""HICO-DET dataset reader.

Parses the ``instances_{partition}.json`` annotation format (same schema as
reference/hicodet/hicodet.py:52-312: keys annotation/filenames/empty/
objects/verbs/correspondence/size) and exposes the derived lookup tables the
pipeline needs. Images load lazily via PIL when a root directory is given.

Port of ``hoigen_tpu/data/hicodet.py``, the same algorithm in the same order
(the tests hold the two packages equal).
"""
import json
import os
from typing import List, Optional, Tuple

import numpy as np


class HICODetDataset:
    num_object_cls = 80
    num_interaction_cls = 600
    num_action_cls = 117

    def __init__(self, anno_file: str, root: Optional[str] = None):
        self.root = root
        self.anno_file = anno_file
        with open(anno_file) as f:
            f_ = json.load(f)
        idx = [i for i in range(len(f_["filenames"]))
               if i not in set(f_["empty"])]
        self._idx = idx
        self._anno = f_["annotation"]
        self._filenames = f_["filenames"]
        self._image_sizes = f_["size"]
        self._class_corr = f_["correspondence"]
        self._objects = f_["objects"]
        self._verbs = f_["verbs"]
        num_anno = [0] * self.num_interaction_cls
        for anno in self._anno:
            for hoi in anno["hoi"]:
                num_anno[hoi] += 1
        self._num_anno = num_anno

    def __len__(self):
        return len(self._idx)

    def filename(self, i: int) -> str:
        return self._filenames[self._idx[i]]

    def image_size(self, i: int) -> Tuple[int, int]:
        """(width, height) of image i."""
        return tuple(self._image_sizes[self._idx[i]])

    def target(self, i: int) -> dict:
        """Raw annotation; boxes_h/boxes_o xyxy pixel-index coords, plus
        hoi/verb/object lists. HICO boxes are 1-based pixel indices on the
        top-left corner (utils_tip_cache_and_union_finetune.py:185-189
        subtracts 1 from x1,y1)."""
        anno = self._anno[self._idx[i]]
        bh = np.asarray(anno["boxes_h"], np.float32)
        bo = np.asarray(anno["boxes_o"], np.float32)
        if len(bh):
            bh[:, :2] -= 1
            bo[:, :2] -= 1
        return {
            "boxes_h": bh, "boxes_o": bo,
            "hoi": np.asarray(anno["hoi"], np.int32),
            "verb": np.asarray(anno["verb"], np.int32),
            "object": np.asarray(anno["object"], np.int32),
        }

    def load_image(self, i: int):
        from PIL import Image
        return Image.open(os.path.join(self.root,
                                       self.filename(i))).convert("RGB")

    # ---- derived tables (hicodet.py:145-234) ------------------------------
    @property
    def annotations(self) -> List[dict]:
        return self._anno

    @property
    def objects(self) -> List[str]:
        return list(self._objects)

    @property
    def verbs(self) -> List[str]:
        return list(self._verbs)

    @property
    def class_corr(self):
        return [list(c) for c in self._class_corr]

    @property
    def anno_interaction(self) -> List[int]:
        return list(self._num_anno)

    @property
    def anno_action(self) -> List[int]:
        out = [0] * self.num_action_cls
        for i, j, k in self._class_corr:
            out[k] += self._num_anno[i]
        return out

    @property
    def object_n_verb_to_interaction(self) -> np.ndarray:
        lut = np.full((self.num_object_cls, self.num_action_cls), -1,
                      np.int32)
        for i, j, k in self._class_corr:
            lut[j, k] = i
        return lut

    @property
    def object_to_interaction(self):
        out = [[] for _ in range(self.num_object_cls)]
        for i, j, k in self._class_corr:
            out[j].append(i)
        return out

    @property
    def object_to_verb(self):
        out = [[] for _ in range(self.num_object_cls)]
        for i, j, k in self._class_corr:
            out[j].append(k)
        return out

    @property
    def interaction_to_verb(self):
        return [k for _, _, k in self._class_corr]
