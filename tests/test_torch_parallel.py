"""The port's data and cache-row parallelism (``hoigen_tpu_torch/
parallel/``) on the CPU over gloo, against one process.

The sampler's streams are the JAX package's. One pair of worker processes
(``tests/_torch_parallel_worker.py``, which imports no JAX) runs every
multi-process check once: the collectives and an SGD over the global
batch (as ``tests/test_distributed.py``), three data-parallel AdamW steps
of the tiny flagship with the language-aware term on (on a (2, 1) mesh),
one step on a (1, 2) mesh with the cache rows sharded, and the CLI's
train -> --eval -> --cache (as ``tests/test_cli_main.py``), and the
mesh steps as ``Trainer`` graphs them on the CPU stand-ins of a CUDA
graph (capture safety, replays against eager steps bit for bit). The
same steps and CLI runs in this process are the single-process
reference, whose first step is held against the JAX package's
``make_train_step``.
Tolerances are the JAX package's: losses and parameters rtol 1e-5
(``tests/test_engine.py``), APs rtol 1e-6 and the .mat digests' counts
equal (``tests/test_cli_main.py``), the sharded loss within 1e-4.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tools.make_fixture as make_fixture
from hoigen_tpu.parallel import distributed as jdist

import _torch_parallel_worker as worker
from hoigen_tpu_torch.cli import main_finetune as tmf
from hoigen_tpu_torch.parallel import distributed as tdist
from hoigen_tpu_torch.parallel import Mesh, all_reduce, gather_pyobj, \
    init_distributed, make_mesh, process_allgather, \
    process_allgather_ragged, shard_batch, shard_cache_rows
from hoigen_tpu_torch.tools import make_checkpoints
from hoigen_tpu_torch.utils.config import RunConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT = 180


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("shuffle", [False, True])
def test_local_batch_indices_match_jax(monkeypatch, p, shuffle):
    """Every process's rows and real counts of every global batch, for
    process counts 1, 2 and 4, equal the JAX sampler's."""
    for k in range(p):
        monkeypatch.setattr(jax, "process_count", lambda: p)
        monkeypatch.setattr(jax, "process_index", lambda: k)
        monkeypatch.setattr(tdist, "process_count", lambda: p)
        monkeypatch.setattr(tdist, "process_index", lambda: k)
        for n in (10, 17):
            want = jdist.local_batch_indices(n, 4, shuffle, seed=3,
                                             pad_tail=True,
                                             return_global=True)
            got = tdist.local_batch_indices(n, 4, shuffle, seed=3,
                                            pad_tail=True, return_global=True)
            assert len(got) == len(want)
            for (g, lo, nr), (jg, jlo, jnr) in zip(got, want):
                np.testing.assert_array_equal(g, jg)
                np.testing.assert_array_equal(lo, jlo)
                assert nr == jnr
                assert tdist.local_n_real(nr, 4) == jdist.local_n_real(jnr, 4)


def test_single_process_degenerates():
    """Without a coordinator: init is a no-op, the gathers add the process
    axis or pass through, a collective is the identity, the mesh is
    (1, 1) and a larger one raises."""
    assert "COORDINATOR_ADDRESS" not in os.environ
    assert init_distributed() is False
    np.testing.assert_array_equal(
        process_allgather({"a": np.arange(3)})["a"], np.arange(3)[None])
    np.testing.assert_array_equal(
        process_allgather_ragged({"a": [1, 2]})["a"], [1, 2])
    assert gather_pyobj({"x": 1}) == [{"x": 1}]
    t = torch.arange(3.0)
    assert torch.equal(all_reduce(t.clone()), t)
    assert make_mesh() == Mesh(1, 1)
    with pytest.raises(ValueError, match="needs 2 processes"):
        make_mesh(n_data=2)


def test_shard_cache_rows_and_batch_slices():
    """Model rank 1 of a (1, 2) mesh holds the second half of every
    cache-row leaf on its row axis (trainable leaves still trainable),
    nothing else changes; data rank 1 of (2, 1) the second half of the
    batch; rows that do not divide raise."""
    w = torch.arange(8.0).reshape(4, 2).requires_grad_()
    keys = torch.arange(12.0).reshape(3, 4).requires_grad_()
    params = {"upt": {"adapter_H_w": w, "global_cache": keys,
                      "text_w": torch.ones(2, 2)}, "detr": {}}
    buffers = {"one_hots_H": torch.eye(4), "sample_lens_H": torch.ones(4)}
    mesh = Mesh(1, 2, 0, 1)
    p, b = shard_cache_rows(mesh, params, buffers)
    assert torch.equal(p["upt"]["adapter_H_w"], w[2:])
    assert torch.equal(p["upt"]["global_cache"], keys[:, 2:])
    assert p["upt"]["adapter_H_w"].requires_grad
    assert p["upt"]["text_w"] is params["upt"]["text_w"]
    assert torch.equal(b["one_hots_H"], torch.eye(4)[2:])
    assert b["sample_lens_H"] is buffers["sample_lens_H"]
    assert shard_cache_rows(Mesh(2, 1, 1, 0), params, buffers) == \
        (params, buffers)
    got = shard_batch(Mesh(2, 1, 1, 0), {"x": np.arange(4)})
    np.testing.assert_array_equal(got["x"], [2, 3])
    with pytest.raises(ValueError, match="do not divide"):
        shard_cache_rows(Mesh(1, 3, 0, 0), params, buffers)


# ------------------------------------------------------ the worker pair
@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("par")
    data = make_fixture.build(str(root / "data"), n_images=5, seed=1)
    cfg = worker.tiny_model_config(RunConfig())
    paths = make_checkpoints.write_checkpoints(
        str(root / "ckpt"), cfg.clip, cfg.detr, seed=0,
        image_names=[f"im_{i}.jpg" for i in range(5)], dino=False,
        spread=100.0)
    return root, data, paths


@pytest.fixture(scope="module")
def two_processes(cli_files):
    """One gloo pair runs every multi-process check. -> (results by rank,
    output directory)."""
    root, data, paths = cli_files
    out = str(root / "pair")
    os.makedirs(out)
    spec = json.dumps({"checks": ["collectives", "dp", "tp", "graph",
                                  "cli"],
                       "out": out, "data": data, "paths": paths})
    env = dict(os.environ)
    env.pop("COORDINATOR_ADDRESS", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, os.path.join(REPO, "tests")]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    port = tdist.free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "_torch_parallel_worker.py"),
         str(rank), "2", str(port), spec], env=env, cwd=out,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    results = {}
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=WORKER_TIMEOUT)
            assert p.returncode == 0, f"worker failed:\n{stdout}\n{stderr}"
            res = json.loads(stdout.strip().splitlines()[-1])
            results[res["rank"]] = res
    finally:
        for p in procs:
            p.kill()
    assert set(results) == {0, 1}
    return results, out


def test_two_process_collectives(two_processes):
    """The sampler's rows (the streams of tests/test_distributed.py), the
    gathers (stacked, ragged, pickled objects of different lengths)."""
    results, _ = two_processes
    c = {r: results[r]["collectives"] for r in (0, 1)}
    assert c[0]["local_rows"] == [[0, 1], [4, 5], [8, 9]]
    assert c[1]["local_rows"] == [[2, 3], [6, 7], [9, 9]]
    assert c[0]["n_reals"] == c[1]["n_reals"] == [4, 4, 2]
    assert c[0]["local_n_real"] == [2, 2, 2]
    assert c[1]["local_n_real"] == [2, 2, 0]
    for r in (0, 1):
        assert c[r]["allgather"] == {"v": [[0] * 3, [1] * 3],
                                     "s": [0.5, 1.5]}
        assert c[r]["ragged"] == [0.0, 1.0, 10.0, 11.0, 12.0]
        assert c[r]["pyobj"] == [[2, 0, [0]], [3, 1, [0, 1]]]


def test_two_process_sgd_matches_one_process(two_processes):
    """SGD over the cluster, each process its rows and the gradients
    summed, equals numpy's SGD over the global batches (float64)."""
    results, _ = two_processes
    data = np.arange(40, dtype=np.float64).reshape(10, 4)
    y = np.arange(10, dtype=np.float64)
    params = np.asarray([0.5, -0.25, 1.0, 2.0])
    losses = []
    for idx in ([0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 9, 9]):
        err = data[idx] @ params - y[idx]
        losses.append(float(np.mean(err ** 2)))
        params = params - 0.1 * (2.0 / len(idx)) * (data[idx].T @ err)
    for r in (0, 1):
        c = results[r]["collectives"]
        np.testing.assert_allclose(c["sgd_losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(c["sgd_params"], params, rtol=1e-5)


@pytest.fixture(scope="module")
def one_process_steps():
    return worker.train_steps(None)


def _jax_split(tree, trainable):
    """The port's merged parameter tree as the JAX package's ``trainable``
    (``trainable=True``) or ``frozen["upt"]``: one tree shape, None where
    a leaf belongs to the other (``bridge.py``'s inverse)."""
    if isinstance(tree, dict):
        return {k: _jax_split(v, trainable) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_jax_split(v, trainable) for v in tree)
    if tree is None or tree.requires_grad != trainable:
        return None
    return jnp.asarray(tree.detach().numpy())


def _flat(tree, path):
    """(path, leaf) of a nested dict/list, None leaves left out."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        if tree is not None:
            yield path, tree
        return
    for k, v in items:
        yield from _flat(v, f"{path}/{k}")


def test_one_process_step_matches_jax(one_process_steps):
    """The other end of the chain: the one-process reference above
    (``train_steps(None)``, whose first step the data-parallel and
    sharded runs are held to) against the JAX package's
    ``make_train_step`` (optax, under jit) from the same weights and
    global batch, the language-aware term on. The first step's loss
    rtol 1e-5 and every trainable leaf after it rtol 1e-5, atol 1e-6
    (f32 on both sides, sums in another order). One step: on the CPU the
    parameters after it agree within 6e-7, yet the next two steps' losses
    part by 2e-4 and 5e-4, too far apart to hold the port to anything."""
    from hoigen_tpu.engine import hoi_model as jhm
    from hoigen_tpu.models.clip.config import CLIPConfig as JCLIPConfig
    from hoigen_tpu.models.detr import DETRConfig as JDETRConfig
    from hoigen_tpu.models.proposals import ProposalConfig as JProposals
    from hoigen_tpu.models.upt import UPTConfig as JUPTConfig
    from hoigen_tpu_torch import bridge
    cfg, params, buffers = worker.tiny_flagship()
    jcfg = jhm.HOIModelConfig(
        clip=JCLIPConfig(**{f: getattr(cfg.clip, f) for f in (
            "image_resolution", "vision_layers", "vision_width",
            "vision_patch_size", "adapter_layers")}),
        detr=JDETRConfig(**{f: getattr(cfg.detr, f) for f in (
            "hidden_dim", "nheads", "enc_layers", "dec_layers",
            "dim_feedforward", "num_queries", "num_classes")}),
        upt=JUPTConfig(proposals=JProposals(max_instances=4),
                       **{f: getattr(cfg.upt, f) for f in (
                           "num_classes", "num_shot", "clip_resolution",
                           "use_dino", "cache_model", "use_pallas_cache",
                           "generate_feature", "LA")}),
        dtype=cfg.dtype)
    trainable = _jax_split(params["upt"], True)
    frozen = {"upt": _jax_split(params["upt"], False),
              **{k: jax.tree.map(jnp.asarray, bridge.to_numpy(params[k]))
                 for k in ("detr", "dino")}}
    opt = jhm.make_optimizer(lr_drop_step=2)(trainable)
    trainable, _, metrics = jax.jit(jhm.make_train_step(jcfg, opt))(
        trainable, opt.init(trainable), frozen,
        jax.tree.map(jnp.asarray, bridge.to_numpy(buffers)),
        worker.global_batches(cfg, buffers, 1)[0], None)

    losses, leaves, _ = worker.train_steps(None, n=1)
    assert losses[0] == one_process_steps[0][0]
    np.testing.assert_allclose(losses[0], float(metrics["loss"]), rtol=1e-5)
    want = dict(_flat(jax.tree.map(np.asarray, trainable), "upt"))
    assert set(want) == set(leaves)
    for k, w in want.items():
        np.testing.assert_allclose(leaves[k], w, rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_dp_training_matches_one_process(two_processes, one_process_steps):
    """Three AdamW steps of the tiny flagship (gen_feat caches, generated
    pairs, DINO, the language-aware term), two processes of two rows each
    against one process of the four: losses rtol 1e-5, every trainable
    leaf after the steps rtol 1e-5, atol 1e-6, on both ranks."""
    results, out = two_processes
    losses, leaves, _ = one_process_steps
    assert all(np.isfinite(losses)) and losses[0] > 1e-3
    for r in (0, 1):
        np.testing.assert_allclose(results[r]["dp_losses"], losses,
                                   rtol=1e-5)
        got = np.load(os.path.join(out, f"dp_{r}.npz"))
        assert set(got.files) == set(leaves)
        for k, want in leaves.items():
            np.testing.assert_allclose(got[k], want, rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_la_term_counted_once(two_processes, one_process_steps):
    """The language-aware term enters the data-parallel loss once: the
    first step's loss equals one process's within rtol 1e-5, where
    counting it on each rank would add the term again; so does the loss
    on a (1, 2) mesh, where both ranks are data rank 0."""
    results, _ = two_processes
    from hoigen_tpu_torch.models.upt import language_aware_loss
    _, params, buffers = worker.tiny_flagship()
    la = float(language_aware_loss(params["upt"],
                                   buffers["origin_text_embeddings"], 0.6))
    want = one_process_steps[0][0]
    assert la > 1e-5 * want * 10
    for r in (0, 1):
        got = results[r]["dp_losses"][0]
        assert abs(got - want) <= 1e-5 * want < la
        assert results[r]["tp_losses"][0] == pytest.approx(want, rel=1e-5)


def test_cache_row_sharding_matches_dp(two_processes):
    """One step on a (1, 2) mesh, each rank half of every cache branch's
    rows and the whole batch, against a (2, 1) mesh on the same global
    batch: loss within 1e-4, and every gradient after the clip (the
    sharded leaves gathered whole) within 1e-4 of its leaf's scale."""
    results, out = two_processes
    for r in (0, 1):
        assert abs(results[r]["tp_losses"][0]
                   - results[r]["dp_losses"][0]) < 1e-4
    dp = np.load(os.path.join(out, "first_dp_0.npz"))
    for r in (0, 1):
        tp = np.load(os.path.join(out, f"first_tp_{r}.npz"))
        assert set(tp.files) == set(dp.files)
        assert "upt/adapter_H_w" in tp.files and "upt/dino_cache" in tp.files
        for k in dp.files:
            scale = max(float(np.abs(dp[k]).max()), 1e-30)
            np.testing.assert_allclose(tp[k], dp[k], rtol=0,
                                       atol=1e-4 * scale, err_msg=k)


@pytest.mark.parametrize("mesh", ["dp", "tp"])
def test_mesh_step_is_capture_safe(two_processes, mesh):
    """On a (2, 1) and a (1, 2) gloo pair, after a warm-up step, the mesh
    step (the language-aware term on, dropout from a generator, its
    collectives) makes no op that a CUDA graph could not hold, on either
    rank. Before the optimizer's row-group mask was made once, the (1, 2)
    step built it from a host list (``aten.lift_fresh``) at every call."""
    results, _ = two_processes
    for r in (0, 1):
        assert results[r]["graph"][mesh]["unsafe"] == []


@pytest.mark.parametrize("mesh", ["dp", "tp"])
def test_mesh_replays_are_the_eager_steps(two_processes, mesh):
    """The mesh step through ``Trainer`` with its collectives capturable
    (the predicate patched to true on the gloo pair) is a
    ``GraphedTrainStep``; on the stand-ins, its first call warms up and
    captures the collectives with the rest of the step, and its 3 replays
    run them again. 2 + 2 steps across the learning-rate drop, dropout on:
    the losses, every trainable leaf, the moments and the count equal the
    eager mesh steps' bit for bit after every step, on both ranks."""
    results, _ = two_processes
    for r in (0, 1):
        g = results[r]["graph"][mesh]
        assert g["graphed"] == "GraphedTrainStep"
        assert g["equal"] == [True] * worker.GRAPH_STEPS
        got, want = zip(*g["losses"])
        assert got == want and len(set(got)) == len(got)
        assert all(x > 1e-3 for x in got)
        assert g["count"] == worker.GRAPH_STEPS > worker.GRAPH_LR_DROP
        assert [(rec["captures"], rec["replays"]) for rec in g["records"]] \
            == [(1, worker.GRAPH_STEPS - 1)]
    assert results[0]["graph"][mesh]["losses"] == \
        results[1]["graph"][mesh]["losses"]


def test_row_group_norm_is_the_host_built_mask_norm(two_processes):
    """The optimizer's norm on a (1, 2) gloo pair, from its row-group mask
    made once at construction, equals bit for bit the norm from the mask
    built from a host list at every call, in each learning-rate group;
    so does it on a mesh whose model group is a group of one (no process
    group: the collective is the identity)."""
    results, _ = two_processes
    for r in (0, 1):
        assert results[r]["graph"]["tp"]["norm_equal"] == [True, True]
    from hoigen_tpu_torch.engine import hoi_model as thm
    from hoigen_tpu_torch.engine.partition import trainable_leaves
    gen = torch.Generator().manual_seed(0)
    params = {"upt": {
        "adapter_H_w": torch.randn(6, 4, generator=gen).requires_grad_(),
        "text_w": torch.randn(5, generator=gen).requires_grad_(),
        "clip": {"w": torch.randn(3, 3, generator=gen).requires_grad_()},
        "dino_cache": torch.randn(4, 6, generator=gen).requires_grad_()}}
    opt = thm.make_optimizer(mesh=Mesh(1, 2, model_group="one"))(params)
    for _, t in trainable_leaves(params):
        t.grad = torch.randn(t.shape, generator=gen)
    masks = [g["sharded"].tolist() for g in opt.param_groups]
    assert masks == [[False], [True, False, True]]
    for g in opt.param_groups:
        assert torch.equal(opt._norm(g), worker.old_norm(opt, g, params))


def test_trainer_graphs_a_mesh_step_whose_groups_are_nccl(two_processes,
                                                          monkeypatch):
    """``Trainer`` wraps a step over a mesh in ``GraphedTrainStep`` when
    every group it reduces over is NCCL (``capturable``: the data group,
    and the model group where it shards the cache rows), and keeps it
    eager when one is gloo, as on the gloo pair; a step without a mesh,
    or over a mesh without groups, is wrapped. On the CPU the wrapper runs
    the eager step (``test_torch_train_graph.py``)."""
    from hoigen_tpu_torch.engine import cuda_graph as cg
    from hoigen_tpu_torch.engine.train import Trainer
    results, _ = two_processes
    for r in (0, 1):
        for mesh in ("dp", "tp"):
            assert results[r]["graph"][mesh]["trainer"] == "function"
    monkeypatch.setattr(tdist.dist, "get_backend", lambda group: group)

    def routed(mesh):
        """-> the Trainer's step: the wrapper's type, or "eager"."""
        def step(params, buffers, batch, generator=None):
            pass
        step.mesh = mesh
        got = Trainer(step, None, {}, {}).step_fn
        return "eager" if got is step else type(got)
    assert routed(None) is cg.GraphedTrainStep
    assert routed(Mesh(1, 1)) is cg.GraphedTrainStep
    assert routed(Mesh(2, 1, data_group="nccl")) is cg.GraphedTrainStep
    assert routed(Mesh(1, 2, data_group="nccl", model_group="nccl")) \
        is cg.GraphedTrainStep
    assert routed(Mesh(1, 1, data_group="nccl", model_group="gloo")) \
        is cg.GraphedTrainStep            # no model axis: no row group
    for mesh in (Mesh(2, 1, data_group="gloo"),
                 Mesh(1, 2, data_group="nccl", model_group="gloo"),
                 Mesh(1, 2, data_group="gloo", model_group="nccl")):
        assert routed(mesh) == "eager"


def test_gloo_collective_of_a_card_tensor_raises_inside_a_capture(
        monkeypatch):
    """A gloo collective of a CUDA tensor runs on a host copy, which no
    CUDA graph can hold: ``all_reduce`` raises inside a capture (and
    never copies)."""
    class CardTensor:
        is_cuda = True

        def cpu(self):
            raise AssertionError("copied to the host inside a capture")
    monkeypatch.setattr(tdist, "_initialized", lambda: True)
    monkeypatch.setattr(tdist.dist, "get_backend", lambda group: "gloo")
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="cannot capture"):
        all_reduce(CardTensor())


@pytest.fixture(scope="module")
def one_process_cli(cli_files):
    root, data, paths = cli_files
    cwd = os.getcwd()
    os.makedirs(root / "single_cwd")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmf, "make_model_config", worker.tiny_model_config)
        mp.setattr(tmf, "DataFactory", worker.functools.partial(
            worker.factory_module.DataFactory, clip_resolution=32,
            transform_kwargs=worker.TRANSFORM))
        mp.setattr(worker.factory_module, "DEFAULT_BUCKETS", worker.BUCKETS)
        try:
            os.chdir(root / "single_cwd")
            return worker.cli_runs(data, paths, str(root / "single"))
        finally:
            os.chdir(cwd)


def test_two_process_cli_matches_one_process(two_processes,
                                             one_process_cli):
    """The CLI's epoch of training, --eval and --cache in two processes
    against one: the same losses, both ranks the same merged AP vector
    within rtol 1e-6 of one process's, and the .mat files' row counts
    equal and sums within 1e-6."""
    results, _ = two_processes
    train, result, digest = one_process_cli
    ap = np.asarray(result["ap"], np.float64)
    for r in (0, 1):
        cli = results[r]["cli"]
        assert cli["train"]["iteration"] == train["iteration"] == 2
        np.testing.assert_allclose(cli["train"]["losses"], train["losses"],
                                   rtol=1e-5)
        np.testing.assert_allclose(cli["ap"], ap, rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(cli["mAP"], result["mAP"], rtol=1e-6)
    assert results[0]["cli"]["ap"] == results[1]["cli"]["ap"]
    assert results[1]["cli"]["mat_digest"] is None
    got = np.asarray(results[0]["cli"]["mat_digest"])
    want = np.asarray(digest)
    assert got.shape == want.shape == (80, 2) and want[:, 0].sum() > 0
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-6, atol=1e-6)


def test_devices_2_spawns_one_process_a_device(cli_files, one_process_cli,
                                               monkeypatch, tmp_path):
    """``--devices 2`` on the CPU: main starts two processes through the
    spawn launcher, which evaluate as the two-process run does and return
    process 0's result, the one-process AP vector within rtol 1e-6."""
    root, data, paths = cli_files
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tmf, "_main_in_process",
                        worker.main_in_spawned_process)
    cfg = RunConfig(**dict(worker.cli_common(data, paths,
                                             str(tmp_path / "o")),
                           devices=2, eval=True,
                           resume=str(root / "single")))
    result = tmf.main(cfg, device="cpu")
    np.testing.assert_allclose(result["ap"], one_process_cli[1]["ap"],
                               rtol=1e-6, atol=1e-9)
