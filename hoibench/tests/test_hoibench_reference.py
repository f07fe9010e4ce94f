"""The frozen reference against the port at a tiny configuration on the
CPU, from the same inputs: the eval step's outputs, and one training
step's loss and updated leaves. (The CPU runs every kernel's plain
version; the port's attention there keeps f32 products where the
reference rounds them to bf16 as the card's kernels do, so the CLIP
attention is left plain, as the eval step runs it.)"""
import dataclasses

import numpy as np
import pytest
import torch

from hoibench import cells as C, model as M, traffic as T
from hoibench.tests.conftest import shrink, tiny_run


def plain_clip(cfg):
    cfg = shrink(cfg)
    return dataclasses.replace(
        cfg, clip=dataclasses.replace(cfg.clip, fused_attention=False))


def inputs(workload, small_sizes):
    run, cell = tiny_run(workload, shrink=plain_clip)
    rc, cfg, params, buffers = M.build_program(
        run.seed, run.config, run.traffic, "cpu", plain_clip)
    caches = M.Caches(**T.make_caches(run.seed, run.config,
                                      cfg.upt.num_classes,
                                      cfg.upt.num_shot))
    pool, _ = T.make_batches(run.seed, run.config, run.traffic,
                             cfg.upt.num_classes, caches=caches,
                             clip_resolution=cfg.upt.clip_resolution)
    return run, rc, cfg, params, buffers, pool


def test_eval_outputs_match(small_sizes):
    from hoigen_tpu_torch.engine.hoi_model import make_eval_step
    run, rc, cfg, params, buffers, pool = inputs("vcoco-eval-b32",
                                                 small_sizes)
    step = make_eval_step(cfg, "cpu")
    got = [{k: v.numpy() for k, v in step(params, buffers, b).items()}
           for b in pool]
    detr = [C.program_detector(params, cfg, b, "cpu") for b in pool]
    want = C.reference_eval(run, cfg, pool, detr)
    assert sum(int(g["pair_valid"].sum()) for g in got) > 0
    for g, w in zip(got, want):
        for k in ("pair_valid", "objects", "detection_verbs", "boxes"):
            np.testing.assert_array_equal(g[k], w[k])
        np.testing.assert_allclose(g["detection_scores"],
                                   w["detection_scores"], rtol=1e-5,
                                   atol=1e-12)
    ref = C.reference_detectors(run, cfg, pool)
    for d, r in zip(detr, ref):
        for a, b in zip(d[:4], r[:4]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(d[4], r[4], rtol=1e-5, atol=1e-6)


def test_training_step_matches(small_sizes):
    from hoigen_tpu_torch.engine.hoi_model import make_optimizer, \
        make_train_step
    from hoigen_tpu_torch.engine.partition import trainable_leaves
    run, rc, cfg, params, buffers, pool = inputs("hico-rfuc-train-b32",
                                                 small_sizes)
    opt = make_optimizer(rc.lr_vit, rc.lr_head, rc.weight_decay,
                         rc.lr_drop * C.steps_per_epoch(run.config,
                                                        run.traffic),
                         rc.clip_max_norm)(params)
    seed = M.dropout_seed(run.seed)
    gen = torch.Generator().manual_seed(M.step_generator_seed(seed, 0))
    p0 = {p: t.detach().clone() for p, t in trainable_leaves(params)}
    loss = float(make_train_step(cfg, opt, "cpu")(params, buffers, pool[0],
                                                  gen)["loss"])
    detr = [C.program_detector(params, cfg, pool[0], "cpu")]
    ref = C.reference_train(run, cfg, pool[:1], detr, seed, rc)
    assert loss == pytest.approx(ref["losses"][0], rel=1e-6)
    moved = 0
    for p, t in trainable_leaves(params):
        np.testing.assert_allclose(t.detach().numpy(), ref["p3"][p].numpy(),
                                   rtol=1e-5, atol=1e-7)
        moved += not torch.equal(t.detach(), p0[p])
    assert moved > 0
