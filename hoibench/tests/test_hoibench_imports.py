"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port either: top-level module names
(before the first dot) compared whole, since the port's name begins with
the JAX package's."""
import ast
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent
JAX_SIDE = {"jax", "jaxlib", "flax", "hoigen_tpu"}


def top_levels(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def harness_files():
    return [p for p in HERE.rglob("*.py") if "tests" not in p.parts]


def test_no_source_names_the_jax_side():
    for path in harness_files():
        assert not top_levels(path) & JAX_SIDE, path


def test_reference_sources_name_no_program():
    for path in (HERE / "reference").rglob("*.py"):
        assert not top_levels(path) & (JAX_SIDE | {"hoigen_tpu_torch"}), \
            path


def loaded_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_the_harness_loads_no_jax_side_module():
    """A whole tiny run of each kind of cell on the CPU (set-up, window,
    comparison), every metric reader and every feed, then the loaded
    modules."""
    code = """
import time
from hoibench import cells as C, spec, run
from hoibench.tests import conftest as T
import pytest
mp = pytest.MonkeyPatch()
T.small_sizes.__wrapped__(mp)
r, cell = T.tiny_run("hico-rfuc-train-b32")
C.check_train(r, *C.train_ready(r, time.perf_counter()))
r, cell = T.tiny_run("vcoco-eval-b32")
C.check_eval(r, *C.eval_ready(r, time.perf_counter()))
for w in spec.benchmark()["workloads"]:
    c = spec.Cell(w["name"])
    [c.reader(m["name"]) for m in c.per_layer + c.end_to_end]
    spec.feed_of(c.traffic)
"""
    loaded = loaded_after(code)
    assert "hoigen_tpu_torch" in loaded
    assert not loaded & JAX_SIDE


def test_the_reference_loads_no_program_module():
    mods = [p.relative_to(ROOT).with_suffix("").as_posix().replace("/", ".")
            for p in (HERE / "reference").rglob("*.py")
            if p.name != "__init__.py"]
    loaded = loaded_after("\n".join(f"import {m}" for m in mods))
    assert not loaded & (JAX_SIDE | {"hoigen_tpu_torch"})
