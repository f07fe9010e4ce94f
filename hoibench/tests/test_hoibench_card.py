"""On the card: each cell end to end for a few seconds (correct, its
metrics, one process), and each cell's control at the cell's own size
(not correct). Skipped without a CUDA card; run with

    python -m pytest hoibench/tests -m hoibench_card
"""
import json
import pathlib
import subprocess
import sys

import pytest

from hoibench import spec

ROOT = pathlib.Path(__file__).resolve().parents[2]
WORKLOADS = [w["name"] for w in spec.benchmark()["workloads"]]


def card(chips=1):
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA card(s)")


@pytest.mark.hoibench_card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_correct(workload):
    card(spec.Cell(workload).chips)
    out = subprocess.run(
        [sys.executable, "hoibench/run.py", "--workload", workload, "--seed",
         str(2 ** 31 + 101), "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["compared"]
    assert {m["name"] for m in spec.Cell(workload).end_to_end} == set(
        line["metrics"])


@pytest.mark.hoibench_card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload):
    card()
    out = subprocess.run(
        [sys.executable, "hoibench/control.py", "--workload", workload,
         "--seeds", str(2 ** 31 + 103)], cwd=ROOT, capture_output=True,
        text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    for line in out.stdout.strip().splitlines():
        assert not json.loads(line)["correct"]
