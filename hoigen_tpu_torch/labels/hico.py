"""HICO-DET label tables and derived lookup structures (port of
``hoigen_tpu/labels/hico.py``).

Mirrors the data surfaced by the reference modules (see
reference/hico_list.py:1, hico_text_label.py:1,827, hico_label.py:1,
HICO_utils.py:2) but loads everything from JSON and derives index tables
programmatically.

Conventions (identical to the reference / HICO-DET):
  * 600 interaction (HOI) classes, each a (verb, object) pair
  * 117 verb classes, 80 object classes (COCO order), human class index 0
  * zero-shot splits keyed by ``zs_type`` in
    {rare_first, non_rare_first, unseen_verb, unseen_object, uc0..uc4}
"""
import functools
import json
import os

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _load(name):
    with open(os.path.join(_DATA_DIR, name + ".json")) as f:
        return json.load(f)


class _Hico:
    """Lazy accessor over the extracted HICO label tables."""

    @functools.cached_property
    def _list(self):
        return _load("hico_list")

    @functools.cached_property
    def _text(self):
        return _load("hico_text_label")

    @functools.cached_property
    def _label(self):
        return _load("hico_label")

    @functools.cached_property
    def _utils(self):
        return _load("HICO_utils")

    # ---- raw tables -----------------------------------------------------
    @property
    def verb_object_list(self):
        """600 x (verb_name, object_name) pairs (hico_list.py:1)."""
        return [tuple(x) for x in self._list["hico_verb_object_list"]]

    @property
    def verbs(self):
        """117 verb names."""
        return list(self._list["hico_verbs"])

    @property
    def objects(self):
        """80 object names in COCO order ('person' first)."""
        return list(self._list["hico_objects"])

    @property
    def verbs_sentence(self):
        """117 verb phrases used as CLIP classnames (hico_list.py)."""
        return list(self._list["hico_verbs_sentence"])

    @property
    def verbs_sentence_2(self):
        return list(self._list["hico_verbs_sentence_2"])

    @functools.cached_property
    def text_label(self):
        """dict {(verb_idx, obj_idx): prompt text} for the 600 HOI classes
        (hico_text_label.py:1). Values ordered = HOI class order."""
        return {
            tuple(int(v) for v in k.split(",")): t
            for k, t in self._text["hico_text_label"].items()
        }

    @property
    def hoi_prompts(self):
        """600 HOI prompt sentences in HOI class order."""
        return list(self.text_label.values())

    @property
    def obj_text_label(self):
        """80 x (obj_idx, prompt text) (hico_text_label.py)."""
        return [(int(i), t) for i, t in self._text["hico_obj_text_label"]]

    @property
    def hum_text_label(self):
        return [(int(i), t) for i, t in self._text["hico_hum_text_label"]]

    @functools.cached_property
    def unseen_index(self):
        """Zero-shot unseen HOI index sets keyed by zs_type
        (hico_text_label.py:827-950)."""
        return {k: list(v) for k, v in self._text["hico_unseen_index"].items()}

    # label-table extras used by the generator pipeline (hico_label.py)
    @property
    def rare_first_num(self):
        return list(self._label["rare_first_num"])

    @property
    def nonrare_first_num(self):
        return list(self._label["nonrare_first_num"])

    @property
    def all_classnames(self):
        return list(self._label["all_classnames"])

    @property
    def object_name(self):
        return list(self._label["object_name"])

    @property
    def human_name(self):
        return list(self._label["human_name"])

    @property
    def object_seen_name(self):
        return list(self._label["object_seen_name"])

    @property
    def human_seen_name(self):
        return list(self._label["human_seen_name"])

    @property
    def human_for_verb_name(self):
        return list(self._label["human_for_verb_name"])

    @property
    def seen_classnames(self):
        return list(self._label["seen_classnames"])

    # ---- derived index tables -------------------------------------------
    @functools.cached_property
    def hoi_to_object(self):
        """int32[600] HOI -> object class (HICO_utils.py HOI_IDX_TO_OBJ_IDX)."""
        return np.asarray(self._utils["HOI_IDX_TO_OBJ_IDX"], dtype=np.int32)

    @functools.cached_property
    def hoi_to_verb(self):
        """int32[600] HOI -> verb class (HICO_utils.py HOI_IDX_TO_ACT_IDX)."""
        return np.asarray(self._utils["HOI_IDX_TO_ACT_IDX"], dtype=np.int32)

    @functools.cached_property
    def no_interaction_indexes(self):
        """The 80 'no_interaction' HOI class ids."""
        return list(self._utils["no_interaction_indexes"])

    @functools.cached_property
    def obj_to_no_interaction(self):
        """int32[80] object -> its no_interaction HOI class
        (upt_tip_cache_model_free_finetune_distill3.py:562)."""
        out = np.full(80, -1, dtype=np.int32)
        for hoi in self.no_interaction_indexes:
            out[self.hoi_to_object[hoi]] = hoi
        assert (out >= 0).all()
        return out

    @functools.cached_property
    def class_corr(self):
        """600 x [hoi_idx, obj_idx, verb_idx] (hicodet.py class_corr)."""
        return [
            [i, int(self.hoi_to_object[i]), int(self.hoi_to_verb[i])]
            for i in range(600)
        ]

    @functools.cached_property
    def object_n_verb_to_interaction(self):
        """int32[80, 117]: HOI id for a valid (object, verb) pair else -1
        (hicodet.py:145-157 uses None; we use -1 for array friendliness)."""
        lut = np.full((80, 117), -1, dtype=np.int32)
        for i, j, k in self.class_corr:
            lut[j, k] = i
        return lut

    @functools.cached_property
    def object_to_verb(self):
        """list[80] of valid verb ids per object (hicodet.py object_to_verb)."""
        out = [[] for _ in range(80)]
        for i, j, k in self.class_corr:
            out[j].append(k)
        return out

    @functools.cached_property
    def object_to_interaction(self):
        """list[80] of HOI ids per object (hicodet.py object_to_interaction)."""
        out = [[] for _ in range(80)]
        for i, j, k in self.class_corr:
            out[j].append(i)
        return out

    @functools.cached_property
    def interaction_to_verb(self):
        """int32[600] = hoi_to_verb (hicodet.py interaction_to_verb)."""
        return self.hoi_to_verb.copy()

    def object_class_multihot(self, num_classes):
        """float32[80, num_classes] multi-hot M[o, c] = 1 iff class c (verb for
        117, HOI for 600) is valid for object o. Static-matrix form of the
        per-pair python loops in compute_prior_scores
        (upt_tip_cache_model_free_finetune_distill3.py:806-833)."""
        m = np.zeros((80, num_classes), dtype=np.float32)
        for i, j, k in self.class_corr:
            m[j, k if num_classes == 117 else i] = 1.0
        return m

    def seen_object_class_multihot(self, num_classes, filtered_hoi_idx):
        """Same as object_class_multihot but excluding unseen HOIs, matching
        the zero-shot LUT zs_object_to_target
        (utils_tip_cache_and_union_finetune.py:144-152)."""
        m = np.zeros((80, num_classes), dtype=np.float32)
        filtered = set(filtered_hoi_idx)
        for i, j, k in self.class_corr:
            if i in filtered:
                continue
            m[j, k if num_classes == 117 else i] = 1.0
        return m


HICO = _Hico()
