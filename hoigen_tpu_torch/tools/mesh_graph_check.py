"""The training step over a mesh across cards, graphed with its NCCL
collectives inside, against the eager mesh step.

    python3 -m hoigen_tpu_torch.tools.mesh_graph_check [--cards 4]
        [--out FILE]

Starts one process a card (``parallel/distributed.py::launch``, NCCL).
On each mesh, (N, 1) and (N/2, 2) on N cards (the second shards the
cache rows over two model ranks and the batch over N/2 data ranks),
every rank builds the training flagship of ``chip_smoke.py`` phase 6
(f32 towers, 117 classes, one generated pair an image, the fused cache,
CLIP's fused attention, the language-aware term and dropout on) from
seed 0, takes its rows of a global batch of ``RANK_BATCH`` a data rank,
and runs :func:`mesh_run`; the global loss must be equal on every rank.
Prints one JSON line of every rank's numbers (also written to ``--out``)
and exits non-zero when a check fails. ``chip_smoke.py`` runs
:func:`mesh_run` in a process group of one (phase 6c), and this tool on
a machine with two cards or more (phase 6d).
"""
import argparse
import json
import math
import sys
import time

import numpy as np
import torch

FLAGSHIP_CLASSES = 117
# a data rank's rows: the repro scripts' --batch-size 32 over four cards
RANK_BATCH = 8
SEED = 0
STEPS = 20          # checked, and timed, after 2 more
WARMUP = 2
PROFILE_STEPS = 3
LR_DROP = 10
# K1 and K4 in the 12 CLIP blocks, K3 on H/O/U twice (the generated
# pairs): the launches of the flagship's step, on every mesh
STEP_LAUNCHES = (12, 12, 6)


def flagship(device):
    """(cfg, params, buffers, caches) from ``SEED``: phase 6's training
    flagship with the language-aware term on, the random DETR's heads
    spread so that pairs form."""
    from ..engine.hoi_model import HOIModelConfig, init_hoi_model
    from ..models.cache import random_caches
    from ..models.upt import UPTConfig
    cfg = HOIModelConfig(upt=UPTConfig(
        num_classes=FLAGSHIP_CLASSES, num_shot=2, cache_model="gen_feat",
        use_pallas_cache=True, generate_feature=True, LA=True),
        dtype="float32")
    caches = random_caches(FLAGSHIP_CLASSES, 2, num_objects=80, seed=SEED)
    params, buffers = init_hoi_model(torch.Generator().manual_seed(SEED),
                                     cfg, caches, device=device)
    last = params["detr"]["bbox_embed"][-1]
    noise = np.random.default_rng(SEED).normal(0, 1.0, last["b"].shape)
    last["w"] = last["w"] * 30.0
    last["b"] = last["b"] + torch.as_tensor(noise, dtype=last["b"].dtype,
                                            device=last["b"].device)
    params["detr"]["class_embed"]["b"][0] += 10.0
    return cfg, params, buffers, caches


def trainable_copy(params):
    """``params`` with its ``upt`` subtree (every trainable leaf, and
    CLIP) cloned, each clone requiring grad as its source does; DETR and
    DINO, frozen, shared."""
    def clone(tree):
        if isinstance(tree, dict):
            return {k: clone(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(clone(v) for v in tree)
        return tree.detach().clone().requires_grad_(tree.requires_grad)
    return dict(params, upt=clone(params["upt"]))


def new_run(cfg, model, device, mesh=None, graphed=True, norm_mesh=None):
    """A copy of ``model``'s trainable weights, a fresh optimizer
    (learning-rate drop at ``LR_DROP``) and a ``Trainer`` over ``mesh``
    (None: one process), as the CLI makes them; the run steps through the
    Trainer's step (graphed where ``Trainer`` graphs) or, ``graphed``
    False, the eager step. ``norm_mesh`` (default ``mesh``): the mesh whose
    row group the optimizer sums its norm over. -> the run's state."""
    from ..engine.hoi_model import make_optimizer, make_train_step
    from ..engine.train import Trainer
    params, buffers = trainable_copy(model[0]), model[1]
    opt = make_optimizer(lr_drop_step=LR_DROP,
                         mesh=norm_mesh or mesh)(params)
    step = make_train_step(cfg, opt, device, mesh=mesh)
    trainer = Trainer(step, opt, params, buffers,
                      checkpoint_every_epoch=False,
                      data_rank=mesh.data_index if mesh else 0)
    return {"params": params, "buffers": buffers, "opt": opt,
            "step": trainer.step_fn if graphed else step,
            "data_rank": mesh.data_index if mesh else 0, "done": 0,
            "metrics": []}


def step_once(r, batch, seed=SEED):
    """One step of run ``r``, dropout from a generator seeded as a
    ``Trainer`` seeds it (the seed, the step, the data rank)."""
    gen = torch.Generator(device=batch["images"].device).manual_seed(
        seed * 1_000_003 + r["done"] + (r["data_rank"] << 40))
    m = r["step"](r["params"], r["buffers"], batch, gen)
    r["done"] += 1
    r["metrics"].append((float(m["loss"]), float(m["n_p"])))


def state(r):
    """Copies of what a run's steps made: the metrics so far, every
    trainable leaf, the moments and the count."""
    from ..engine.partition import trainable_leaves
    return {"metrics": np.asarray(r["metrics"]),
            "leaves": [t.detach().clone()
                       for _, t in trainable_leaves(r["params"])],
            "moments": [t.clone() for g in r["opt"].param_groups
                        for t in g["mu"] + g["nu"]],
            "count": r["opt"].count}


def gap(a, b):
    """The largest difference of each kind between two states: losses
    relative to their size, n_p absolute, every trainable leaf and moment
    relative to its tensor's largest magnitude, the count; 0 in each
    where they are equal bit for bit, NaN where either holds one."""
    ma, mb = a["metrics"], b["metrics"]

    def rel(xs, ys):
        return max(float((x - y).abs().max())
                   / max(float(y.abs().max()), 1e-30)
                   for x, y in zip(xs, ys))
    if ma.shape != mb.shape:
        return {"metrics": math.nan}
    return {"loss": float((np.abs(ma[:, 0] - mb[:, 0])
                           / np.abs(mb[:, 0])).max()),
            "n_p": float(np.abs(ma[:, 1] - mb[:, 1]).max()),
            "leaves": rel(a["leaves"], b["leaves"]),
            "moments": rel(a["moments"], b["moments"]),
            "count": abs(a["count"] - b["count"])}


def profiled(run, steps):
    """``steps`` calls of ``run()`` under torch.profiler: busy ms a step
    (the device's own time), runtime calls a step, the NCCL kernels' {name:
    (ms, launches)} a step, their summed ms, and the c10d or NCCL host
    events' calls a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    device = [ev for ev in events if ev.device_type == DeviceType.CUDA
              and not getattr(ev, "is_user_annotation", False)]
    nccl = {ev.key: (ev.self_device_time_total / 1e3 / steps,
                     ev.count / steps)
            for ev in device if "nccl" in ev.key.lower()}
    return {"busy_ms": sum(ev.self_device_time_total for ev in device)
            / 1e3 / steps or None,
            "runtime_calls": {ev.key: ev.count / steps for ev in events
                              if ev.key.startswith(("cuda", "cuLaunch"))},
            "nccl_kernels": nccl,
            "nccl_device_ms": sum(ms for ms, _ in nccl.values()),
            "nccl_host_calls": {
                ev.key: ev.count / steps for ev in events
                if ev.device_type != DeviceType.CUDA
                and ("nccl" in ev.key.lower() or "c10d" in ev.key)}}


def mesh_run(mesh, model, batch, cfg, device, steps=STEPS, seed=SEED):
    """On this rank, its cache rows ``model`` = (params, buffers) and its
    rows ``batch`` of the global batch (card tensors), two runs
    (:func:`new_run`), one through ``Trainer`` (graphed: one
    ``GraphedTrainStep`` capture, then replays) and one eager, on the same
    dropout seeds, each 2 + ``steps`` steps across the learning-rate
    drop. Checks: the Trainer's step is graphed; the graphed run equal to
    the eager one bit for bit (losses, n_p, every trainable leaf, the
    moments, the count) after those steps and again after the timed ones;
    finite losses and positive n_p; the launches of K1, K4 and K3 over the
    graphed run's steps (the counters set to 0 just before them and read
    just after) ``STEP_LAUNCHES`` a step. Both timed in one window
    (``WARMUP`` + ``steps``, then ``PROFILE_STEPS`` under torch.profiler):
    mean, median, quartiles, images/s of the global batch, busy ms, idle
    share, runtime calls and the NCCL kernels a step; the graphed step
    must show one ``cudaGraphLaunch``, under 20 kernel launch calls, no
    c10d or NCCL host call and the eager step's NCCL kernels, and, in a
    group of more than one process, at least one NCCL kernel (in a group
    of one NCCL launches none). One graph, whose replays are every step
    after its capture; its capture seconds and pool bytes. -> (record,
    failures, {"first": the graphed run's state after its first update,
    "steps": after 2 + ``steps``})."""
    import torch.distributed as dist

    from ..engine.cuda_graph import GraphedTrainStep
    from ..ops.attention import attention_bwd, fused_attention
    from ..ops.pallas_cache import fused_cache_logits
    wrappers = (fused_attention, attention_bwd, fused_cache_logits)
    failures, states = [], {}
    n = 2 + steps
    runs = {"graphed": new_run(cfg, model, device, mesh),
            "eager": new_run(cfg, model, device, mesh, graphed=False)}
    g, e = runs["graphed"], runs["eager"]
    if not isinstance(g["step"], GraphedTrainStep):
        failures.append(f"Trainer's step is a {type(g['step']).__name__}")
    rank_batch = int(batch["images"].shape[0])
    rec = {"rank_batch": rank_batch, "images": rank_batch * mesh.n_data,
           "h_rows": int(model[0]["upt"]["adapter_H_w"].shape[0])}

    def held(what):
        d = rec[what] = gap(state(g), state(e))
        bad = {k: v for k, v in d.items() if not v <= 0}
        if bad:
            failures.append(f"{what}: graphed differs from eager: {bad}")

    for fn in wrappers:
        fn.launches = 0
    step_once(g, batch, seed)
    states["first"] = state(g)
    while g["done"] < n:
        step_once(g, batch, seed)
    torch.cuda.synchronize()
    rec["launches"] = [fn.launches for fn in wrappers]
    if rec["launches"] != [k * n for k in STEP_LAUNCHES]:
        failures.append(f"launches {rec['launches']} over {n} steps, "
                        f"{STEP_LAUNCHES} a step expected")
    states["steps"] = state(g)
    while e["done"] < n:
        step_once(e, batch, seed)
    held("graphed_vs_eager")
    rec["losses"] = [x for x, _ in e["metrics"]]
    if not (e["opt"].count > LR_DROP and all(
            math.isfinite(x) and x > 1e-3 and n_p > 0
            for x, n_p in e["metrics"])):
        failures.append(f"losses and n_p {e['metrics']}")

    for which in ("eager", "graphed"):
        r, times = runs[which], []
        for _ in range(WARMUP + steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step_once(r, batch, seed)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        ms = np.asarray(times[WARMUP:]) * 1e3
        q1, median, q3 = (float(v) for v in np.percentile(ms, (25, 50, 75)))
        prof = profiled(lambda r=r: step_once(r, batch, seed), PROFILE_STEPS)
        busy = prof["busy_ms"]
        rec[which] = dict(prof, mean_ms=float(ms.mean()), median_ms=median,
                          q1_ms=q1, q3_ms=q3,
                          images_per_s=rec["images"] * len(ms)
                          / (ms.sum() / 1e3),
                          idle_share=None if busy is None
                          else 1 - busy / float(ms.mean()))
    held("timed_graphed_vs_eager")
    gr, er = rec["graphed"], rec["eager"]
    launch_calls = sum(v for k, v in gr["runtime_calls"].items()
                       if "LaunchKernel" in k)
    if not launch_calls < 20 or gr["runtime_calls"].get(
            "cudaGraphLaunch") != 1:
        failures.append(f"graphed runtime calls a step "
                        f"{gr['runtime_calls']}")
    if gr["nccl_host_calls"]:
        failures.append(f"graphed host calls {gr['nccl_host_calls']}")
    if not er["nccl_host_calls"]:
        failures.append("the eager step shows no c10d call: the profile "
                        "missed its collectives")
    if {k: c for k, (_, c) in gr["nccl_kernels"].items()} != {
            k: c for k, (_, c) in er["nccl_kernels"].items()}:
        failures.append(f"NCCL kernels graphed {gr['nccl_kernels']}, "
                        f"eager {er['nccl_kernels']}")
    if dist.get_world_size() > 1 and not gr["nccl_kernels"]:
        failures.append(f"no NCCL kernel in the replay of a step over "
                        f"{dist.get_world_size()} processes")
    graphs = g["step"].records() if isinstance(
        g["step"], GraphedTrainStep) else {}
    rec["graphs"] = list(graphs.values())
    if [(x["captures"], x["replays"]) for x in rec["graphs"]] != \
            [(1, g["done"] - 1)]:
        failures.append(f"graphs {rec['graphs']} over {g['done']} steps")
    rec["capture_s"] = sum(x["capture_s"] for x in rec["graphs"])
    rec["pool_bytes"] = sum(x["pool_bytes"] for x in rec["graphs"])
    return rec, failures, states


def rank_main(cards):
    """One process of the run: every mesh in turn. -> on process 0, the
    records and failures of every rank, by mesh."""
    from ..engine.hoi_model import make_example_batch
    from ..parallel import gather_pyobj, init_distributed, make_mesh, \
        shard_batch, shard_cache_rows
    from ..parallel.distributed import process_index
    init_distributed(device="cuda")
    device = torch.device(f"cuda:{torch.cuda.current_device()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, params, buffers, caches = flagship(device)
    out = {}
    for shape in ((cards, 1), (cards // 2, 2)):
        t0 = time.perf_counter()
        mesh = make_mesh(*shape)
        batch = shard_batch(mesh, make_example_batch(
            cfg, batch_size=RANK_BATCH * mesh.n_data, detr_hw=(800, 1344),
            seed=SEED, device_clip_stream=True,
            object_class_multihot=caches.object_class_multihot))
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        rec, failures, _ = mesh_run(
            mesh, shard_cache_rows(mesh, params, buffers), batch, cfg, device)
        rec["seconds"] = time.perf_counter() - t0
        ranks = gather_pyobj({"rank": process_index(), "record": rec,
                              "failures": failures})
        losses = {tuple(r["record"]["losses"]) for r in ranks}
        if len(losses) != 1:
            ranks[0]["failures"].append(f"the ranks' losses differ: "
                                        f"{losses}")
        out["x".join(map(str, shape))] = ranks
        del batch
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.cards < 2 or args.cards % 2:
        ap.error("--cards must be even: the second mesh has a model axis "
                 "of 2")
    import subprocess

    from ..ops import _build
    from ..parallel import launch
    # by the module's name, which a spawned process imports (not __main__)
    from . import mesh_graph_check
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    _build.build_all()           # once, before the processes load it
    t0 = time.perf_counter()
    out = launch(mesh_graph_check.rank_main, args.cards, args.cards)
    result = {"cards": card, "rank_batch": RANK_BATCH,
              "seconds": time.perf_counter() - t0, "meshes": out}
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    for mesh, ranks in out.items():
        for r in ranks:
            rec = r["record"]
            print(f"mesh {mesh} rank {r['rank']}: batch {rec['rank_batch']} "
                  f"of {rec['images']}, {rec['h_rows']} H rows; graphed "
                  f"{rec['graphed']['mean_ms']:.3f} ms (idle "
                  f"{rec['graphed']['idle_share']}), eager "
                  f"{rec['eager']['mean_ms']:.3f} ms (idle "
                  f"{rec['eager']['idle_share']}); NCCL device ms a step "
                  f"{rec['graphed']['nccl_device_ms']:.4f} graphed, "
                  f"{rec['eager']['nccl_device_ms']:.4f} eager; "
                  f"failures {r['failures'] or 'none'}", flush=True)
    print(line)
    failed = [f for ranks in out.values() for r in ranks
              for f in r["failures"]]
    if failed:
        print("mesh_graph_check: FAILED: " + "; ".join(failed),
              file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
