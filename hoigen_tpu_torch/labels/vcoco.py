"""V-COCO label tables and derived lookups (port of
``hoigen_tpu/labels/vcoco.py``, with the same JSON tables under
``hoigen_tpu_torch/labels/data``).

Loads the 236 (verb, object) interaction keys / name pairs and the 24 verb
prompt sentences (reference: reference/vcoco_list.py:1-129). The
reference imports a missing module ``vcoco_text_label`` for
``vcoco_hoi_text_label`` (main_tip_finetune.py:27); we reconstruct the
equivalent tables from ``vcoco_keys``/``vcoco_values`` (the documented fix —
see SURVEY.md §2.2 "known broken pieces").
"""
import functools
import json
import os

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

NUM_INTERACTIONS = 236
NUM_VERBS = 24
NUM_OBJECTS = 81  # V-COCO uses 81 object categories (vcoco json 'objects')

# the standard 91-slot COCO category table (public DETR convention: index
# 0 and ten other slots are 'N/A' holes; person = slot 1). Used to gather
# the COCO-pretrained DETR's 92 logits down to 81 (80 classes + no-object)
COCO_91_CLASSES = (
    "N/A", "person", "bicycle", "car", "motorcycle", "airplane", "bus",
    "train", "truck", "boat", "traffic light", "fire hydrant", "N/A",
    "stop sign", "parking meter", "bench", "bird", "cat", "dog", "horse",
    "sheep", "cow", "elephant", "bear", "zebra", "giraffe", "N/A",
    "backpack", "umbrella", "N/A", "N/A", "handbag", "tie", "suitcase",
    "frisbee", "skis", "snowboard", "sports ball", "kite", "baseball bat",
    "baseball glove", "skateboard", "surfboard", "tennis racket", "bottle",
    "N/A", "wine glass", "cup", "fork", "knife", "spoon", "bowl", "banana",
    "apple", "sandwich", "orange", "broccoli", "carrot", "hot dog", "pizza",
    "donut", "cake", "chair", "couch", "potted plant", "bed", "N/A",
    "dining table", "N/A", "N/A", "toilet", "N/A", "tv", "laptop", "mouse",
    "remote", "keyboard", "cell phone", "microwave", "oven", "toaster",
    "sink", "refrigerator", "N/A", "book", "clock", "vase", "scissors",
    "teddy bear", "hair drier", "toothbrush",
)

_VOWELS = ("a", "e", "i", "o", "u")


def _article(noun):
    return "an" if noun.lower().startswith(_VOWELS) else "a"


class _Vcoco:
    @functools.cached_property
    def _tab(self):
        with open(os.path.join(_DATA_DIR, "vcoco_list.json")) as f:
            return json.load(f)

    # ---- raw tables -----------------------------------------------------
    @property
    def keys(self):
        """236 x (verb_idx, obj_idx) interaction keys (vcoco_list.py:1)."""
        return [tuple(k) for k in self._tab["vcoco_keys"]]

    @property
    def values(self):
        """236 x (verb_name, object_name) (vcoco_list.py)."""
        return [tuple(v) for v in self._tab["vcoco_values"]]

    @property
    def seen_keys(self):
        return [tuple(k) for k in self._tab["vcoco_seen_keys"]]

    @property
    def seen_values(self):
        return [tuple(v) for v in self._tab["vcoco_seen_values"]]

    @property
    def object_seen_keys(self):
        return list(self._tab["object_seen_keys"])

    @property
    def object_seen_values(self):
        return list(self._tab["object_seen_values"])

    @property
    def object_name(self):
        return list(self._tab["vcoco_object_name"])

    @property
    def verbs_sentence(self):
        """24 verb prompt sentences used as CLIP classnames."""
        return list(self._tab["vcoco_verbs_sentence"])

    @property
    def human_name(self):
        return list(self._tab["vcoco_human_name"])

    @property
    def human_seen_values(self):
        return list(self._tab["human_seen_values"])

    # ---- derived --------------------------------------------------------
    @functools.cached_property
    def hoi_text_label(self):
        """Reconstructed {(verb_idx, obj_idx): prompt} for 236 interactions
        (replaces the reference's missing vcoco_text_label module)."""
        out = {}
        for (v, o), (vn, on) in zip(self.keys, self.values):
            out[(v, o)] = f"a photo of a person {vn}ing {_article(on)} {on}"
        return out

    @functools.cached_property
    def class_corr(self):
        """236 x [hoi_idx, obj_idx, verb_idx] (main_tip_finetune.py:283-297)."""
        return [[i, k[1], k[0]] for i, k in enumerate(self.keys)]

    @functools.cached_property
    def hoi_to_verb(self):
        return np.asarray([k[0] for k in self.keys], dtype=np.int32)

    @functools.cached_property
    def hoi_to_object(self):
        return np.asarray([k[1] for k in self.keys], dtype=np.int32)

    def object_n_verb_to_interaction(self, num_action_cls=NUM_VERBS):
        """int32[81, 24] (main_tip_finetune.py:299-312); -1 where invalid."""
        lut = np.full((NUM_OBJECTS, num_action_cls), -1, dtype=np.int32)
        for i, j, k in self.class_corr:
            lut[j, k] = i
        return lut

    @functools.cached_property
    def object_to_verb(self):
        out = [[] for _ in range(NUM_OBJECTS)]
        for i, j, k in self.class_corr:
            out[j].append(k)
        return out

    @property
    def detr_reserve_indices(self):
        """int list (81,): gather for the COCO-pretrained 92-logit DETR head
        — the 80 real classes of the 91-slot COCO table (N/A holes dropped,
        person first) + the no-object logit at 91. Mirrors
        upt_tip...py:575-581/:1600-1602; applied BEFORE the postprocess
        softmax so scores normalize over the gathered 81."""
        return [i for i, n in enumerate(COCO_91_CLASSES) if n != "N/A"] \
            + [91]

    def object_class_multihot(self, num_classes=NUM_VERBS):
        """float32[81, num_classes]: valid verb (24) or HOI (236) classes per
        object; see hico.HICO.object_class_multihot."""
        m = np.zeros((NUM_OBJECTS, num_classes), dtype=np.float32)
        for i, j, k in self.class_corr:
            m[j, k if num_classes == NUM_VERBS else i] = 1.0
        return m


VCOCO_LABELS = _Vcoco()


def detr_reserve_indices():
    """The 81 logit indices, in order, of a 92-logit COCO-pretrained DETR
    head that the V-COCO model keeps (``VCOCO_LABELS.detr_reserve_indices``
    as a function, which the eval step calls)."""
    return VCOCO_LABELS.detr_reserve_indices
