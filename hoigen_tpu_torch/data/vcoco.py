"""V-COCO dataset reader over instances_vcoco_{partition}.json
(schema as reference/vcoco/vcoco.py:33-204: annotations/classes/
objects/images/action_to_object; images without pairs are dropped).

Port of ``hoigen_tpu/data/vcoco.py``, the same algorithm in the same order
(the tests hold the two packages equal).
"""
import json
import os
from typing import List, Optional

import numpy as np


class VCOCODataset:
    num_action_cls = 24

    def __init__(self, anno_file: str, root: Optional[str] = None):
        self.root = root
        self.anno_file = anno_file
        with open(anno_file) as f:
            f_ = json.load(f)
        self._anno = f_["annotations"]
        self._actions = f_["classes"]
        self._objects = f_["objects"]
        self._image_ids = f_["images"]
        self._action_to_object = f_["action_to_object"]
        keep, num_instances = [], [0] * len(self._actions)
        for i, anno in enumerate(self._anno):
            if len(anno["actions"]) == 0:
                continue
            keep.append(i)
            for act in anno["actions"]:
                num_instances[act] += 1
        self._keep = keep
        self._num_instances = num_instances

    def __len__(self):
        return len(self._keep)

    def filename(self, i: int) -> str:
        return self._anno[self._keep[i]]["file_name"]

    def image_id(self, i: int) -> int:
        return self._image_ids[self._keep[i]]

    def image_size(self, i: int):
        """(w, h). The vsrl-derived annotations carry no sizes (unlike
        HICO-DET's), so read the image header — PIL parses only metadata
        until pixels are requested, so this stays cheap."""
        anno = self._anno[self._keep[i]]
        if "size" in anno:
            return tuple(anno["size"])
        from PIL import Image
        with Image.open(os.path.join(self.root, self.filename(i))) as im:
            return im.size

    def target(self, i: int) -> dict:
        anno = self._anno[self._keep[i]]
        return {
            "boxes_h": np.asarray(anno["boxes_h"], np.float32),
            "boxes_o": np.asarray(anno["boxes_o"], np.float32),
            "actions": np.asarray(anno["actions"], np.int32),
            "objects": np.asarray(anno["objects"], np.int32),
        }

    def load_image(self, i: int):
        from PIL import Image
        return Image.open(os.path.join(self.root,
                                       self.filename(i))).convert("RGB")

    @property
    def actions(self) -> List[str]:
        return list(self._actions)

    @property
    def objects(self) -> List[str]:
        return list(self._objects)

    @property
    def num_object_cls(self) -> int:
        return len(self._objects)

    @property
    def action_to_object(self):
        return [list(x) for x in self._action_to_object]

    @property
    def num_instances(self) -> List[int]:
        return list(self._num_instances)

    @property
    def object_to_action(self):
        """{object id 1..80: action list}, the inverse of the json's
        ``action_to_object`` table (reference vcoco.py:152-160; feeds the
        24-class prior table at main_tip_finetune.py:850-851)."""
        out = {o: [] for o in range(1, 81)}
        for act, objs in enumerate(self._action_to_object):
            for o in objs:
                if act not in out[o]:
                    out[o].append(act)
        return out


# V-COCO interaction names and the COCO-id compaction used by the official
# annotation generator (reference/vcoco/utilities/
# generate_annotations.py:44-72)
VSRL_INTERACTIONS = [
    "hold obj", "sit instr", "ride instr", "look obj", "hit instr",
    "hit obj", "eat obj", "eat instr", "jump instr", "lay instr",
    "talk_on_phone instr", "carry obj", "throw obj", "catch obj",
    "cut instr", "cut obj", "work_on_computer instr", "ski instr",
    "surf instr", "skateboard instr", "drink instr", "kick obj",
    "read obj", "snowboard instr"]
_COCO_KEEP = [
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18,
    19, 20, 21, 22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36,
    37, 38, 39, 40, 41, 42, 43, 44, 46, 47, 48, 49, 50, 51, 52,
    53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 67, 70,
    72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84, 85, 86, 87,
    88, 89, 90]
_COCOIDX = {k: i for i, k in enumerate(_COCO_KEEP)}


def generate_vcoco_annotations(vsrl_pickle: str, partition: int,
                               objects: Optional[List[str]] = None,
                               out: Optional[str] = None) -> str:
    """Build instances_vcoco_*.json from the official v-coco repo's cached
    ``vcoco_all`` pickle (with the vsrl_utils obj_category patch).

    Port of reference/vcoco/utilities/generate_annotations.py:76-140:
    per action/role, every labelled example with an annotated object box
    becomes a (boxes_h, boxes_o, action, object) record on its image;
    'point' is skipped; partition 0 = COCO train2014 filenames, 1 =
    val2014. Additionally emits ``action_to_object`` (the object classes
    seen per action), which the shipped reference jsons carry and
    VCOCODataset requires.
    """
    import pickle

    with open(vsrl_pickle, "rb") as f:
        vsrl = pickle.load(f, encoding="latin1")

    if objects is None:
        # 'background' + the 80 COCO names (generate_annotations.py:51-62)
        from ..labels import VCOCO_LABELS
        objects = ["background"] + list(VCOCO_LABELS.object_name)

    unique_im_id = np.unique(vsrl[0]["image_id"]).tolist()
    prefix = "COCO_train2014" if partition == 0 else "COCO_val2014"
    anno = [dict(boxes_h=[], boxes_o=[], actions=[], objects=[],
                 file_name=f"{prefix}_{str(i).zfill(12)}.jpg")
            for i in unique_im_id]
    idx_of = {im: k for k, im in enumerate(unique_im_id)}
    a2o = [set() for _ in VSRL_INTERACTIONS]

    for data in vsrl:
        if data["action_name"] == "point":
            continue
        for i in range(len(data["role_name"]) - 1):
            name = " ".join([data["action_name"], data["role_name"][i + 1]])
            idx = VSRL_INTERACTIONS.index(name)
            for j in np.where(np.asarray(data["label"]).ravel())[0]:
                bo = np.asarray(
                    data["role_bbox"])[j, (i + 1) * 4:(i + 2) * 4]
                if np.isnan(bo).any():
                    continue
                k = idx_of[int(np.asarray(data["image_id"]).ravel()[j])]
                obj = _COCOIDX[int(np.asarray(
                    data["obj_category"])[j, i + 1])]
                anno[k]["boxes_h"].append(
                    np.asarray(data["role_bbox"])[j, :4].tolist())
                anno[k]["boxes_o"].append(bo.tolist())
                anno[k]["actions"].append(idx)
                anno[k]["objects"].append(obj)
                a2o[idx].add(obj)

    out = out or vsrl_pickle.rsplit(".", 1)[0] + ".json"
    with open(out, "w") as f:
        json.dump(dict(annotations=anno, classes=VSRL_INTERACTIONS,
                       objects=objects, images=unique_im_id,
                       action_to_object=[sorted(s) for s in a2o]), f)
    return out
