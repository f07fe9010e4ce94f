"""Without a card the benchmark exits non-zero and prints no result; in a
directory that holds only BENCHMARK.json and the benchmark's files it
does the same."""
import pathlib
import shutil
import subprocess
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def run(cwd):
    return subprocess.run(
        [sys.executable, "hoibench/run.py", "--workload",
         "hico-rfuc-train-b32", "--seed", str(2 ** 31 + 17), "--seconds",
         "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300)


def test_without_a_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = run(ROOT)
    assert out.returncode != 0
    assert '"device"' not in out.stdout and '"correct"' not in out.stdout


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copytree(HERE, tmp_path / "hoibench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = run(tmp_path)
    assert out.returncode != 0
    assert '"device"' not in out.stdout and '"correct"' not in out.stdout
