"""The comparison's control and faults at a tiny size on the CPU: a sound
run passes the cell's limits, the reference in lower precision standing
in for the program fails them (a CPU has no TF32: the fp8 detector
weights alone), and so does the run with the timed path broken
underneath, once for each fault the cell can have."""
import time

import pytest
import torch

from hoibench import cells as C, compare, control
from hoibench.tests.conftest import tiny_run


def judged(run, cell, numbers):
    return compare.judge(numbers, cell.limits)[0]


def train_run():
    run, cell = tiny_run("hico-rfuc-train-b32")
    return cell, run, C.check_train(run, *C.train_ready(
        run, time.perf_counter()))


def eval_run():
    run, cell = tiny_run("vcoco-eval-b32")
    return cell, run, C.check_eval(run, *C.eval_ready(
        run, time.perf_counter()))


def test_sound_runs_pass(small_sizes):
    cell, run, numbers = train_run()
    assert judged(run, cell, numbers), numbers
    cell, run, numbers = eval_run()
    assert judged(run, cell, numbers), numbers


@pytest.mark.parametrize("workload, fault", [
    ("hico-rfuc-train-b32", "precision"),
    ("hico-rfuc-train-b32", "half_batch"),
    ("vcoco-eval-b32", "precision"),
    ("vcoco-eval-b32", "half_batch"),
    ("vcoco-eval-b32", "altered_answer"),
])
def test_control_and_faults_fail(small_sizes, workload, fault):
    run, cell = tiny_run(workload)
    assert not judged(run, cell, control.control_numbers(run, fault))


def test_state_left_unchanged_fails(small_sizes, monkeypatch):
    from hoigen_tpu_torch.engine.hoi_model import GroupedAdamW
    monkeypatch.setattr(GroupedAdamW, "step", lambda self: None)
    cell, run, numbers = train_run()
    assert numbers["change_gap"] == pytest.approx(1.0)
    assert not judged(run, cell, numbers)


def test_half_batch_in_the_step_fails(small_sizes, monkeypatch):
    from hoigen_tpu_torch.engine import hoi_model
    made = hoi_model.make_train_step

    def halved(cfg, optimizer, device=None, mesh=None):
        step = made(cfg, optimizer, device, mesh)

        def run(params, buffers, batch, generator=None):
            half = {k: v[:len(v) // 2] for k, v in batch.items()}
            return step(params, buffers, half, generator)
        run.mesh = mesh
        return run
    monkeypatch.setattr(hoi_model, "make_train_step", halved)
    cell, run, numbers = train_run()
    assert not judged(run, cell, numbers)


def test_altered_answer_fails(small_sizes, monkeypatch):
    from hoigen_tpu_torch.engine import hoi_model
    made = hoi_model.make_eval_step

    def altered(cfg, device=None):
        step = made(cfg, device)

        def run(params, buffers, batch):
            out = dict(step(params, buffers, batch))
            out["objects"] = out["objects"] + 1
            return out
        return run
    monkeypatch.setattr(hoi_model, "make_eval_step", altered)
    cell, run, numbers = eval_run()
    assert not judged(run, cell, numbers)


def test_half_the_eval_batch_fails(small_sizes, monkeypatch):
    from hoigen_tpu_torch.engine import hoi_model
    made = hoi_model.make_eval_step

    def halved(cfg, device=None):
        step = made(cfg, device)

        def run(params, buffers, batch):
            out = dict(step(params, buffers, batch))
            half = len(out["pair_valid"]) // 2
            return {k: torch.cat([v[:half], torch.zeros_like(v[half:])])
                    for k, v in out.items()}
        return run
    monkeypatch.setattr(hoi_model, "make_eval_step", halved)
    cell, run, numbers = eval_run()
    assert not judged(run, cell, numbers)
