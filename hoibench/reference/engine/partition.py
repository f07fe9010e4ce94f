"""Trainable/frozen selection and learning-rate groups (port of
``hoigen_tpu/engine/partition.py``).

The port holds one merged parameter dict ``{"upt": ..., "detr": ...,
"dino": ...}``; a leaf's path is the tuple of its keys and list indices from
the root. DETR and DINO are frozen; within CLIP only the visual positional
embedding, ln_post, the visual projection and all adapter weights train;
every other UPT head parameter trains. Trainable leaves get
``requires_grad``. Two learning-rate groups: CLIP at lr_vit, the rest at
lr_head.
"""
import torch


def clip_trainable(path_parts) -> bool:
    """Is this CLIP-subtree leaf trainable? path_parts: tuple of str keys
    below ``clip``."""
    p = path_parts
    if "adapter" in p:
        return True
    if p[:2] == ("visual", "positional_embedding"):
        return True
    if len(p) >= 2 and p[0] == "visual" and p[1] in ("ln_post", "proj"):
        return True
    return False


def trainable_predicate(path) -> bool:
    """Over the merged dict: every ``upt`` leaf trains except the frozen
    parts of its CLIP subtree; DETR and DINO never train."""
    if not path or path[0] != "upt":
        return False
    if len(path) > 1 and path[1] == "clip":
        return clip_trainable(tuple(p for p in path[2:]
                                    if isinstance(p, str)))
    return True


def lr_group(path) -> str:
    """'vit' for CLIP-subtree leaves, 'head' otherwise."""
    return "vit" if path[:2] == ("upt", "clip") else "head"


def named_leaves(tree, prefix=()):
    """(path, tensor) for every tensor of a nested dict/list, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, prefix + (i,))
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree


def mark_trainable(params, predicate=trainable_predicate):
    """Set ``requires_grad`` on every leaf of ``params`` from
    ``predicate``; returns ``params``."""
    for path, t in named_leaves(params):
        t.requires_grad_(predicate(path))
    return params


def trainable_leaves(params):
    """(path, tensor) of the leaves that require grad."""
    return [(p, t) for p, t in named_leaves(params) if t.requires_grad]
