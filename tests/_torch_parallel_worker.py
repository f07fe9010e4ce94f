"""Worker of the port's multi-process tests (``tests/test_torch_parallel.py``)
and the pieces they share with the single-process runs they are held
against. It imports the port only, never JAX: every worker process (a
subprocess of the test, or a process that ``parallel.launch`` spawns)
imports it.

    python tests/_torch_parallel_worker.py RANK WORLD PORT SPEC_JSON

joins a gloo group of WORLD processes on localhost:PORT and runs the
checks the spec names, each writing ``<out>/<check>_<rank>.npz`` or
printing one JSON line at the end.
"""
import functools
import json
import os
import sys

import numpy as np
import torch

from hoigen_tpu_torch.cli import main_finetune as mf
from hoigen_tpu_torch.data import factory as factory_module
from hoigen_tpu_torch.engine import hoi_model as hm
from hoigen_tpu_torch.engine.partition import named_leaves
from hoigen_tpu_torch.models.cache import random_caches
from hoigen_tpu_torch.models.clip.config import CLIPConfig
from hoigen_tpu_torch.models.detr.config import DETRConfig
from hoigen_tpu_torch.models.proposals import ProposalConfig
from hoigen_tpu_torch.models.upt import UPTConfig
from hoigen_tpu_torch.utils.config import RunConfig

TRANSFORM = dict(eval_min_side=48, max_side=80, train_scales=(40, 48, 56),
                 crop_resize_choices=(56, 64), crop_range=(32, 64))
BUCKETS = ((56, 80), (80, 56), (80, 80))
GLOBAL_BATCH = 4
DETR_HW = (64, 96)


# ------------------------------------------------------------ the CLI's
def tiny_model_config(cfg, device=None):
    """The tiny model of ``tests/test_cli_main.py`` in the port, with its
    dropout off: each data rank draws its own (``engine/train.py``), so
    only a run without dropout can equal one process's."""
    return hm.HOIModelConfig(
        clip=CLIPConfig(image_resolution=32, vision_layers=2,
                        vision_width=64, vision_patch_size=8,
                        transformer_layers=2, transformer_width=64,
                        context_length=77, adapter_layers=(0, 1),
                        adapter_dropout=0.0),
        detr=DETRConfig(hidden_dim=64, nheads=2, enc_layers=2, dec_layers=2,
                        dim_feedforward=128, num_queries=12, num_classes=81),
        upt=UPTConfig(num_classes=cfg.num_classes, num_shot=cfg.num_shot,
                      clip_resolution=32, use_dino=False,
                      use_clip_global=cfg.clip_global,
                      cache_model=cfg.cache_model,
                      proposals=ProposalConfig(max_instances=4),
                      max_gt_pairs=cfg.max_gt_pairs, feat_mask_type=1,
                      generate_feature=False))


def patch_cli():
    """The CLI at the tiny model and transform sizes (as the port's CLI
    tests patch it)."""
    mf.make_model_config = tiny_model_config
    mf.DataFactory = functools.partial(
        factory_module.DataFactory, clip_resolution=32,
        transform_kwargs=TRANSFORM)
    factory_module.DEFAULT_BUCKETS = BUCKETS


def cli_common(data, paths, out):
    return dict(data_root=data, output_dir=out, batch_size=2, num_workers=2,
                num_classes=600, dino=False, generate_feature=False,
                max_gt_pairs=4, print_interval=100, epochs=1, seed=3,
                clip_model_path=paths["clip"], pretrained_detr=paths["detr"],
                file1=paths["pairs"])


def mat_digest(cache_dir):
    """(rows, sum) of every official .mat file: 80 x 2."""
    import scipy.io as sio
    out = []
    for obj in range(1, 81):
        m = sio.loadmat(os.path.join(cache_dir, f"detections_{obj:02d}.mat"))
        cells = [c for c in np.asarray(m["all_boxes"]).ravel() if c.size]
        out.append([int(sum(c.shape[0] for c in cells)),
                    float(sum(np.float64(c).sum() for c in cells))])
    return out


def cli_runs(data, paths, out):
    """Train an epoch, then --eval and --cache resumed from it, through
    ``main`` on the CPU. -> (training summary, eval result, .mat digest on
    process 0 else None)."""
    common = cli_common(data, paths, out)
    trainer = mf.main(RunConfig(**common), device="cpu")
    train = {"iteration": trainer.iteration, "losses": list(trainer._losses)}
    result = mf.main(RunConfig(**common, eval=True, resume=out), device="cpu")
    cache = os.path.join(out, "cache_out")
    mf.main(RunConfig(**dict(common, output_dir=cache), cache=True,
                      resume=out), device="cpu")
    from hoigen_tpu_torch.parallel import process_index
    return train, result, (mat_digest(cache) if process_index() == 0
                           else None)


# two threads a worker: the pair shares the machine's cores with each
# other (and with the tests' other processes), and the tiny model gains
# nothing from more, while gloo's waits under oversubscribed cores cost
# several times the steps' own time
WORKER_THREADS = 2


def main_in_spawned_process(cfg, device):
    """What ``--devices N`` runs in each process, at the tiny model."""
    torch.set_num_threads(WORKER_THREADS)
    patch_cli()
    return mf._main_in_process(cfg, device)


# ------------------------------------------------- the training step's
def train_configs(la=True):
    return hm.HOIModelConfig(
        clip=CLIPConfig(image_resolution=32, vision_layers=2,
                        vision_width=64, vision_patch_size=8,
                        adapter_layers=(0, 1)),
        detr=DETRConfig(hidden_dim=64, nheads=2, enc_layers=2, dec_layers=2,
                        dim_feedforward=128, num_queries=12, num_classes=2),
        upt=UPTConfig(num_classes=24, num_shot=2, clip_resolution=32,
                      use_dino=True, cache_model="gen_feat",
                      use_pallas_cache=True, generate_feature=True, LA=la,
                      proposals=ProposalConfig(max_instances=4)),
        dtype="float32")


def tiny_flagship(seed=0, la=True):
    """(cfg, params, buffers) on the CPU from ``seed``, the DETR box head
    spread so that pairs form."""
    cfg = train_configs(la)
    caches = random_caches(24, 2, num_objects=10, seed=seed)
    params, buffers = hm.init_hoi_model(torch.Generator().manual_seed(seed),
                                        cfg, caches, device="cpu")
    last = params["detr"]["bbox_embed"][-1]
    with torch.no_grad():
        last["w"].mul_(6.0)
        last["b"].add_(torch.as_tensor(np.random.default_rng(0).normal(
            0, 1.0, tuple(last["b"].shape)), dtype=torch.float32))
    return cfg, params, buffers


def global_batches(cfg, buffers, n=3):
    return [hm.make_example_batch(
        cfg, batch_size=GLOBAL_BATCH, detr_hw=DETR_HW, seed=100 + s,
        device_clip_stream=True,
        object_class_multihot=buffers["object_class_multihot"].numpy())
        for s in range(n)]


def train_steps(mesh, n=3, la=True):
    """``n`` AdamW steps of the tiny flagship on the global batches, each
    rank on its rows, the cache rows sharded over the model axis
    (``mesh`` None: one process, the whole batch). -> (losses, {path:
    trainable leaf} after the steps, {path: the clipped gradient of the
    first step}, as numpy; sharded leaves gathered whole over the model
    group)."""
    from hoigen_tpu_torch.parallel import shard_batch, shard_cache_rows
    cfg, params, buffers = tiny_flagship(la=la)
    if mesh is not None:
        params, buffers = shard_cache_rows(mesh, params, buffers)
    opt = hm.make_optimizer(lr_drop_step=2, mesh=mesh)(params)
    step = hm.make_train_step(cfg, opt, "cpu", mesh=mesh)
    losses = []
    for batch in global_batches(cfg, buffers, n):
        if mesh is not None:
            batch = shard_batch(mesh, batch)
        losses.append(float(step(params, buffers, batch)["loss"]))
        if len(losses) == 1:
            first_grads = trainable_numpy(params, mesh, lambda t: t.grad)
    return losses, trainable_numpy(params, mesh, lambda t: t.detach()), \
        first_grads


def trainable_numpy(params, mesh, fn):
    """{path: fn(leaf) as numpy} over the trainable leaves; on a model
    axis above 1 the sharded leaves' gathered whole over the model group
    (every process: the meshes here are (1, 2) or (2, 1))."""
    from hoigen_tpu_torch.parallel import gather_pyobj, is_cache_row_leaf
    from hoigen_tpu_torch.parallel.mesh import _CACHE_ROW_LEAVES
    out = {}
    for p, t in named_leaves(params):
        if not t.requires_grad:
            continue
        a = fn(t).numpy().copy()
        if mesh is not None and mesh.n_model > 1 and is_cache_row_leaf(p):
            a = np.concatenate(gather_pyobj(a), axis=_CACHE_ROW_LEAVES[p[-1]])
        out["/".join(map(str, p))] = a
    return out


# the graph check's steps: 2 + 2 across the learning-rate drop at update 2
GRAPH_STEPS, GRAPH_LR_DROP, GRAPH_SEED = 4, 2, 5


def tree_state(params, opt):
    """Every trainable leaf, moment and the count, in a fixed order."""
    from hoigen_tpu_torch.engine.partition import trainable_leaves
    return ([t.detach().clone() for _, t in trainable_leaves(params)]
            + [t.clone() for g in opt.param_groups
               for t in g["mu"] + g["nu"]] + [opt._count.clone()])


def old_norm(opt, group, params):
    """A group's norm as ``GroupedAdamW._norm`` made it before its
    row-group mask was a device tensor: the mask built from a host list at
    every call."""
    from hoigen_tpu_torch.engine.partition import trainable_leaves
    from hoigen_tpu_torch.parallel import all_reduce, is_cache_row_leaf
    sharded = {id(t) for p, t in trainable_leaves(params)
               if is_cache_row_leaf(p)}
    sq = torch.stack(torch._foreach_norm(
        [t.grad for t in group["params"]])) ** 2
    mask = torch.as_tensor([id(t) in sharded for t in group["params"]])
    rows = all_reduce(torch.where(mask, sq, 0.0).sum(), opt.row_group)
    return torch.sqrt(torch.where(mask, 0.0, sq).sum() + rows)


def graph_steps(mesh):
    """The mesh step of the tiny flagship (the language-aware term on,
    dropout from a generator) as ``Trainer`` wraps it: without a
    capturable mesh (gloo) the step itself; then, with the capturability
    predicate patched to true and the ``torch.cuda`` calls on the CPU
    stand-ins of ``torch_graph_tools.py``, a ``GraphedTrainStep`` whose
    replays run the taped capture (its collectives included) again. Each
    of ``GRAPH_STEPS`` steps runs on the graphed copy through the Trainer
    and on an eager copy from the same weights, dropout seeds and batch;
    the eager copy's second step runs under ``UnsafeOps``. -> {"trainer":
    the type of the Trainer's step under gloo, "unsafe": the ops found,
    "losses": [(graphed, eager)], "equal": [every trainable leaf, moment
    and the count bit for bit, a step], "records": the graphs' records,
    "count": the updates made, "norm_equal": on a model axis, each
    group's norm against the one from a host-built mask, bit for bit}."""
    import pytest

    from torch_graph_tools import TapedCapture, TapedGraph, UnsafeOps, \
        stand_in_cuda

    from hoigen_tpu_torch.engine import cuda_graph as cg
    from hoigen_tpu_torch.engine import train as train_module
    from hoigen_tpu_torch.parallel import shard_batch, shard_cache_rows

    def copy():
        cfg, params, buffers = tiny_flagship()
        params, buffers = shard_cache_rows(mesh, params, buffers)
        opt = hm.make_optimizer(lr_drop_step=GRAPH_LR_DROP,
                                mesh=mesh)(params)
        return cfg, params, buffers, opt, hm.make_train_step(
            cfg, opt, "cpu", mesh=mesh)

    cfg, params, buffers, opt, step = copy()
    _, eparams, ebuffers, eopt, estep = copy()
    batches = [{k: torch.as_tensor(v) for k, v in
                shard_batch(mesh, b).items()}
               for b in global_batches(cfg, buffers, GRAPH_STEPS)]
    out = {"trainer": type(train_module.Trainer(
        step, opt, params, buffers).step_fn).__name__}
    with pytest.MonkeyPatch.context() as mp:
        capture = TapedCapture(lambda: cg.tensor_leaves((params, buffers))
                               + cg.tensor_leaves(opt.state_tensors()))
        stand_in_cuda(mp, capture, TapedGraph)
        mp.setattr(train_module, "capturable", lambda mesh: True)
        trainer = train_module.Trainer(step, opt, params, buffers,
                                       checkpoint_every_epoch=False,
                                       data_rank=mesh.data_index)
        out.update(graphed=type(trainer.step_fn).__name__, losses=[],
                   equal=[])
        for i, batch in enumerate(batches):
            got = trainer.run_epoch([batch], seed=GRAPH_SEED)
            gen = torch.Generator().manual_seed(
                GRAPH_SEED * 1_000_003 + i + (mesh.data_index << 40))
            if i == 1:
                with UnsafeOps() as mode:
                    want = estep(eparams, ebuffers, batch, gen)
                out["unsafe"] = mode.found
            else:
                want = estep(eparams, ebuffers, batch, gen)
            out["losses"].append((got, float(want["loss"])))
            out["equal"].append(all(map(torch.equal, tree_state(params, opt),
                                        tree_state(eparams, eopt))))
        out["records"] = list(trainer.step_fn.records().values())
    out["count"] = opt.count
    if opt.row_group is not None:
        out["norm_equal"] = [
            bool(torch.equal(eopt._norm(g), old_norm(eopt, g, eparams)))
            for g in eopt.param_groups]
    return out


# ------------------------------------------------------------ the worker
def collectives(rank, world):
    from hoigen_tpu_torch.parallel import all_reduce, gather_pyobj, \
        local_batch_indices, local_n_real, process_allgather, \
        process_allgather_ragged
    batches = local_batch_indices(10, 4, shuffle=False, pad_tail=True)
    out = {"local_rows": [i.tolist() for i, _ in batches],
           "n_reals": [n for _, n in batches],
           "local_n_real": [local_n_real(n, 4) for _, n in batches]}
    g = process_allgather({"v": np.full(3, rank, np.int64),
                           "s": np.asarray(rank + 0.5)})
    out["allgather"] = {"v": g["v"].tolist(), "s": g["s"].tolist()}
    r = process_allgather_ragged(
        {"scores": np.arange(2 + rank, dtype=np.float64) + 10 * rank})
    out["ragged"] = r["scores"].tolist()
    parts = gather_pyobj([{"pid": rank, "rows": list(range(rank + 1))}]
                         * (rank + 2))
    out["pyobj"] = [[len(p), p[0]["pid"], p[0]["rows"]] for p in parts]
    # SGD on a mean-squared loss over the global batch: each process its
    # rows, the gradients summed
    data = torch.arange(40, dtype=torch.float64).reshape(10, 4)
    y = torch.arange(10, dtype=torch.float64)
    w = torch.tensor([0.5, -0.25, 1.0, 2.0], dtype=torch.float64,
                     requires_grad=True)
    losses = []
    for idx, _ in batches:
        idx = torch.as_tensor(idx)
        err = data[idx] @ w - y[idx]
        loss = (err ** 2).sum() / 4
        loss.backward()
        with torch.no_grad():
            all_reduce(w.grad)
            w -= 0.1 * w.grad
            w.grad.zero_()
        losses.append(float(all_reduce(loss.detach().clone())))
    out.update(sgd_losses=losses, sgd_params=w.detach().tolist())
    return out


def main():
    rank, world, port = (int(a) for a in sys.argv[1:4])
    spec = json.loads(sys.argv[4])
    torch.set_num_threads(WORKER_THREADS)
    from hoigen_tpu_torch.parallel import init_distributed, make_mesh
    assert init_distributed(f"localhost:{port}", world, rank, device="cpu")
    result = {"rank": rank}
    if "collectives" in spec["checks"]:
        result["collectives"] = collectives(rank, world)
    for name, shape in (("dp", (world, 1)), ("tp", (1, world))):
        # three steps on the (2, 1) mesh, one on the (1, 2)
        if name in spec["checks"]:
            losses, leaves, grads = train_steps(make_mesh(*shape),
                                                n=3 if name == "dp" else 1)
            result[f"{name}_losses"] = losses
            np.savez(os.path.join(spec["out"], f"{name}_{rank}.npz"),
                     **leaves)
            np.savez(os.path.join(spec["out"], f"first_{name}_{rank}.npz"),
                     **grads)
    if "graph" in spec["checks"]:
        result["graph"] = {name: graph_steps(make_mesh(*shape))
                           for name, shape in (("dp", (world, 1)),
                                               ("tp", (1, world)))}
    if "cli" in spec["checks"]:
        patch_cli()
        cwd = os.path.join(spec["out"], "cwd")
        os.makedirs(cwd, exist_ok=True)
        os.chdir(cwd)
        train, res, digest = cli_runs(spec["data"], spec["paths"],
                                      os.path.join(spec["out"], "cli"))
        result["cli"] = {"train": train, "mAP": res["mAP"],
                         "ap": np.asarray(res["ap"], np.float64).tolist(),
                         "mat_digest": digest}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
