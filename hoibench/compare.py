"""The numbers that decide ``correct``, each worked out between what the
timed path produced and what the reference works out again, and judged
against its limit (``limits/<workload>.json``).

Training (the first three steps that set-up drives through the window's
own call): each step's loss; every trainable leaf's first gradient as the
optimizer got it (its first moment after one step over 1 - b1) and its
change after three steps, each by the gap between the two norms over the
larger of the reference leaf's norm and the median leaf's. Leaves whose
reference gradient is under a thousandth of the median leaf's move by
round-off alone (the adapters' up-projections start at zero and their
scale at 1e-9) and are left out of both, by that rule.

Evaluation: a sample of the window's batches, drawn from the seed: the
indices (pairs, objects, verbs) exactly, boxes by their widest gap over
the largest reference value, scores by their root-mean-square gap over
the reference's root mean square (a bf16 rounding of the cache kernel
moves a few scores by up to 0.3%, which the widest gap would see as much
as a precision lost everywhere).

Both: the detector the comparison hands over. The reference follows the
program from the detector's outputs on (the selection of proposals is a
sort of near-equal scores, which bf16 rounding reorders), so the detector
is checked by itself, stage by stage: the first residual layer on the
same images, the rest of the backbone and the encoder from the port's
first-layer output, the decoder and the heads from the port's encoder
output, by root-mean-square gaps.
"""
import numpy as np
import torch

ADAM_B1 = 0.9
NEGLIGIBLE = 1e-3


def rms_gap(got, want):
    """The root-mean-square gap over the reference's root mean square."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    scale = max(float(np.sqrt(np.mean(want ** 2))), 1e-30)
    return float(np.sqrt(np.mean((got - want) ** 2))) / scale


def rel_gap(got, want):
    """The widest gap over the largest magnitude of ``want``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    return float(np.abs(got - want).max(initial=0.0)) / scale


def leaf_gaps(got, want, keep):
    """{path: |norm(got) - norm(want)| over max(norm(want), median leaf
    norm of ``want``)} over the paths in ``keep``."""
    g = {p: float(torch.linalg.vector_norm(got[p].double())) for p in keep}
    w = {p: float(torch.linalg.vector_norm(want[p].double())) for p in keep}
    med = float(np.median(list(w.values()))) if w else 0.0
    return {p: abs(g[p] - w[p]) / max(w[p], med, 1e-30) for p in keep}


def leaf_norm_gaps(got, want, keep):
    """The worst leaf's gap (:func:`leaf_gaps`)."""
    gaps = leaf_gaps(got, want, keep)
    return max(gaps.values()) if gaps else float("inf")


def worst_leaves(got, want, keep, n=3):
    """The ``n`` worst leaves as "path gap" strings (a run's notes)."""
    gaps = leaf_gaps(got, want, keep)
    return ["/".join(map(str, p)) + f" {g:.3g}" for p, g in
            sorted(gaps.items(), key=lambda r: -r[1])[:n]]


def rms_over_leaves(got, want, keep):
    """The root-mean-square gap over every leaf in ``keep`` together,
    over the reference's root mean square: a steady reading of what moves
    every leaf a little (a lower precision), where one leaf's worst gap
    swings with a single rounding flip."""
    num = sum(float(((got[p] - want[p]).double() ** 2).sum()) for p in keep)
    den = sum(float((want[p].double() ** 2).sum()) for p in keep)
    return (num / max(den, 1e-300)) ** 0.5 if keep else float("inf")


def moving_leaves(first_grad):
    """The paths whose reference first gradient is at least a thousandth of
    the median leaf's norm."""
    norms = {p: float(torch.linalg.vector_norm(t.double()))
             for p, t in first_grad.items()}
    med = float(np.median(list(norms.values())))
    return sorted((p for p, n in norms.items() if n >= NEGLIGIBLE * med),
                  key=str)


def first_gradients(optimizer_mu):
    """{path: the gradient the optimizer took at its first update}, from
    its first moment after that update."""
    return {p: m / (1.0 - ADAM_B1) for p, m in optimizer_mu.items()}


def train_numbers(prog, ref):
    """prog/ref: {"losses": [3 floats], "mu1": {path: tensor},
    "p0": {...}, "p3": {...}} -> {name: value}."""
    g_ref = first_gradients(ref["mu1"])
    keep = moving_leaves(g_ref)
    change = {k: {p: s["p3"][p] - s["p0"][p] for p in s["p0"]}
              for k, s in (("prog", prog), ("ref", ref))}
    losses = [abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]) or not all(
            np.isfinite(prog["losses"])):
        losses = [float("inf")]
    g_prog = first_gradients(prog["mu1"])
    return {
        "init_gap": max(float((prog["p0"][p] - ref["p0"][p]).abs().max())
                        for p in ref["p0"]),
        "loss_gap": max(losses),
        "grad_gap": leaf_norm_gaps(g_prog, g_ref, keep),
        "change_gap": leaf_norm_gaps(change["prog"], change["ref"], keep),
        "grad_rms": rms_over_leaves(g_prog, g_ref, keep),
        "change_rms": rms_over_leaves(change["prog"], change["ref"], keep),
    }


INDEX_KEYS = ("pair_valid", "objects", "detection_verbs")


def eval_numbers(prog_outs, ref_outs):
    """Lists of output dicts (numpy) of the same batches -> {name: value}:
    ``index_mismatch`` counts differing index entries, ``box_gap`` is
    relative to the largest reference box, ``score_rms`` to the
    reference scores' root mean square; ``pairs`` and ``scored`` count
    what the reference found (readings, not compared)."""
    mismatch = 0
    boxes, rms = [], []
    for p, r in zip(prog_outs, ref_outs):
        for k in INDEX_KEYS:
            a, b = np.asarray(p[k]), np.asarray(r[k])
            mismatch += a.size if a.shape != b.shape else int((a != b).sum())
        boxes.append(rel_gap(p["boxes"], r["boxes"]))
        rms.append(rms_gap(p["detection_scores"], r["detection_scores"]))
    if len(prog_outs) != len(ref_outs) or not ref_outs:
        return {"index_mismatch": float("inf"), "box_gap": float("inf"),
                "score_rms": float("inf")}
    return {"index_mismatch": float(mismatch), "box_gap": max(boxes),
            "score_rms": max(rms),
            "pairs": float(sum(np.asarray(r["pair_valid"]).sum()
                               for r in ref_outs)),
            "scored": float(sum((np.asarray(r["detection_scores"]) > 0).sum()
                                for r in ref_outs))}


def handover_gap(timed, eager):
    """The widest gap between the detector's logits and boxes as the timed
    step made them (``cells.DetectorTap``) and as the eager pass whose
    stages the reference checks made them (exact: the same kernels on the
    same inputs)."""
    if len(timed) != len(eager) or not timed:
        return float("inf")
    gap = 0.0
    for t, e in zip(timed, eager):
        for i in (0, 1):
            a = np.asarray(t[i], np.float64)
            b = np.asarray(e[i], np.float64)
            if a.shape != b.shape:
                return float("inf")
            gap = max(gap, float(np.abs(a - b).max(initial=0.0)))
    return gap


def rms_gap_rows(got, want, device):
    """:func:`rms_gap` of two large tensors, summed image by image on
    ``device``."""
    num = den = 0.0
    for g, w in zip(got, want):
        g, w = g.to(device).double(), w.to(device).double()
        num += float(((g - w) ** 2).sum())
        den += float((w ** 2).sum())
    return (num / max(den, 1e-300)) ** 0.5


def detector_numbers(prog_detr, ref_detr, device="cpu"):
    """Lists of ``cells.detector_outputs`` of the judged side and of the
    reference that followed it stage by stage -> {name: value}, root-mean-
    square gaps over the reference's root mean square: the first residual
    layer's output (the fused K2 tail's) against the reference's own; the
    encoder's output against the reference's from the judged side's
    first-layer output; the logits and the last decoder output against
    the reference's decoder on the judged side's encoder output. (A random
    network moves a rounding difference further at every layer: by 3% rms
    from the images to the encoder's output. Judged stage by stage, each
    gap holds its own stage's rounding alone.)"""
    names = {"detr_layer1_rms": 4, "detr_memory_rms": 3,
             "detr_logit_rms": 0, "detr_hidden_rms": 2}
    if len(prog_detr) != len(ref_detr) or not ref_detr:
        return {k: float("inf") for k in names}
    out = {k: max(rms_gap(p[i], r[i]) for p, r in zip(prog_detr, ref_detr))
           for k, i in names.items() if i < 4}
    out["detr_layer1_rms"] = max(rms_gap_rows(p[4], r[4], device)
                                 for p, r in zip(prog_detr, ref_detr))
    return out


def judge(numbers, limits):
    """-> (correct, {name: {"value", "limit"}}) over the numbers the
    cell's limits name: every one at most its limit (one the run did not
    produce fails)."""
    out = {}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name, float("inf"))
        ok = ok and bool(np.isfinite(value) and value <= limit)
        out[name] = {"value": value, "limit": limit}
    return ok and bool(out), out
