"""Fixed-capacity region-proposal selection and human-object pairing (port
of ``hoigen_tpu/models/proposals.py``).

Every image yields exactly ``max_instances`` human slots and
``max_instances`` object slots (score-sorted, validity-masked) and
``max_instances * 2*max_instances`` candidate pairs. Among NMS survivors of
each group (human / non-human), the top clamp(#above-threshold, min, max) by
score are kept. The batch dimension is written out (the JAX package vmaps).
Ties in score go to the lower index, as ``jax.lax.top_k``: the ranking is a
stable descending sort, not ``torch.topk``, whose tie order is unspecified.
"""
import dataclasses

import torch

from ..ops.boxes import union_boxes
from ..ops.nms import batched_nms_mask


@dataclasses.dataclass(frozen=True)
class ProposalConfig:
    human_idx: int = 0
    box_score_thresh: float = 0.2
    min_instances: int = 3
    max_instances: int = 15
    nms_thresh: float = 0.5

    @property
    def n_slots(self) -> int:
        return 2 * self.max_instances

    @property
    def n_pairs(self) -> int:
        return self.max_instances * self.n_slots


def _select_group(scores, member, keep, cfg: ProposalConfig):
    """(B, N) -> top-max_instances indices of a group by score (B, K) and
    their validity: the valid count is clamp(#above-thresh, min, max),
    limited by the group's size."""
    cand = member & keep
    masked = torch.where(cand, scores, float("-inf"))
    top_scores, top_idx = torch.sort(masked, dim=-1, descending=True,
                                     stable=True)
    top_scores = top_scores[..., :cfg.max_instances]
    top_idx = top_idx[..., :cfg.max_instances]
    exists = torch.isfinite(top_scores)
    n_above = (cand & (scores >= cfg.box_score_thresh)).sum(-1, keepdim=True)
    k = torch.clamp(n_above, cfg.min_instances, cfg.max_instances)
    slots = torch.arange(cfg.max_instances, device=scores.device)
    return top_idx, (slots < k) & exists


def select_region_proposals(scores, labels, boxes, cfg: ProposalConfig,
                            valid_in=None):
    """Detections scores/labels (B, N), boxes (B, N, 4) -> fixed slots
    (B, 2*max_instances): [0, max) humans, [max, 2*max) objects, each
    score-sorted. Returns (boxes, scores, labels, valid)."""
    keep = batched_nms_mask(boxes, scores, labels, cfg.nms_thresh,
                            valid=valid_in)
    is_human = labels == cfg.human_idx
    h_idx, h_valid = _select_group(scores, is_human, keep, cfg)
    o_idx, o_valid = _select_group(scores, ~is_human, keep, cfg)
    idx = torch.cat([h_idx, o_idx], dim=-1)
    valid = torch.cat([h_valid, o_valid], dim=-1)
    sel_boxes = torch.gather(boxes, -2, idx[..., None].expand(
        *idx.shape, boxes.shape[-1]))
    return (torch.where(valid[..., None], sel_boxes, 0.0),
            torch.where(valid, torch.gather(scores, -1, idx), 0.0),
            torch.where(valid, torch.gather(labels, -1, idx), 0),
            valid)


def pair_indices(cfg: ProposalConfig, device=None):
    """Static (x, y) slot indices of all candidate pairs: x over human
    slots, y over all slots."""
    x = torch.arange(cfg.max_instances, device=device).repeat_interleave(
        cfg.n_slots)
    y = torch.arange(cfg.n_slots, device=device).repeat(cfg.max_instances)
    return x, y


def make_pairs(boxes, valid, cfg: ProposalConfig):
    """boxes (..., S, 4), valid (..., S) -> pair boxes h/o/union
    (..., P, 4) and pair_valid (..., P)."""
    x, y = pair_indices(cfg, boxes.device)
    bh = boxes[..., x, :]
    bo = boxes[..., y, :]
    pair_valid = valid[..., x] & valid[..., y] & (x != y)
    return bh, bo, union_boxes(bh, bo), pair_valid
