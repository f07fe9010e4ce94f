"""hoigen_tpu_torch stands alone: it imports neither JAX nor the JAX package.

In a fresh interpreter where ``import jax``, ``import hoigen_tpu``,
``import triton``, ``import regex`` and ``import matplotlib`` raise, every
module of the port and ``chip_smoke.py`` import, no module of JAX, of the
JAX package, of Triton, of ``regex`` or of matplotlib appears in
``sys.modules``, and the port's CLIs print their help.
"""
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in (REPO / "hoigen_tpu_torch").rglob("*.py"))

_PROBE = """
import importlib, sys

class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "hoigen_tpu", "triton",
                                  "regex", "matplotlib"):
            raise ImportError(f"{name} must not be imported by the port")
        return None

sys.meta_path.insert(0, _Refuse())
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "hoigen_tpu", "triton",
                                    "regex", "matplotlib"))
assert not bad, bad
print("ok", len(sys.argv) - 1)
"""


def _probe(*modules):
    return subprocess.run(
        [sys.executable, "-c", _PROBE, *modules], cwd=REPO,
        capture_output=True, text=True, timeout=120)


def test_the_probe_refuses_jax():
    """The guard works: importing the JAX package under it fails."""
    res = _probe("hoigen_tpu.ops.boxes")
    assert res.returncode != 0
    assert "must not be imported by the port" in res.stderr


@pytest.mark.parametrize("modules", [PORT_MODULES, ["chip_smoke"]],
                         ids=["package", "chip_smoke"])
def test_port_imports_without_jax(modules):
    assert {"hoigen_tpu_torch.ops.attention", "hoigen_tpu_torch.ops.focal",
            "hoigen_tpu_torch.engine.partition",
            "hoigen_tpu_torch.engine.checkpoint",
            "hoigen_tpu_torch.engine.train",
            "hoigen_tpu_torch.engine.cuda_graph",
            "hoigen_tpu_torch.labels.vcoco",
            # host evaluation and the data pipeline
            "hoigen_tpu_torch.labels", "hoigen_tpu_torch.labels.hico",
            "hoigen_tpu_torch.eval", "hoigen_tpu_torch.eval.ap",
            "hoigen_tpu_torch.eval.association",
            "hoigen_tpu_torch.eval.vcoco_ap", "hoigen_tpu_torch.engine.eval",
            "hoigen_tpu_torch.data", "hoigen_tpu_torch.data.hicodet",
            "hoigen_tpu_torch.data.vcoco", "hoigen_tpu_torch.data.transforms",
            "hoigen_tpu_torch.data.factory", "hoigen_tpu_torch.data.samplers",
            "hoigen_tpu_torch.data.loader", "hoigen_tpu_torch.data.detections",
            "hoigen_tpu_torch.utils.config",
            "hoigen_tpu_torch.cli.main_finetune",
            "hoigen_tpu_torch.tools.make_hicodet",
            # the CLI's checkpoint import, text path and cache building
            "hoigen_tpu_torch.models.clip.tokenizer",
            "hoigen_tpu_torch.models.clip.convert",
            "hoigen_tpu_torch.models.detr.convert",
            "hoigen_tpu_torch.models.convert_upt",
            "hoigen_tpu_torch.models.generator",
            "hoigen_tpu_torch.tools.make_checkpoints",
            "hoigen_tpu_torch.tools.make_vcoco",
            # the generator pipeline and the DETR offline finetune
            "hoigen_tpu_torch.data.crops", "hoigen_tpu_torch.ops.resize",
            "hoigen_tpu_torch.ops.matching",
            "hoigen_tpu_torch.cli.prepare_data",
            "hoigen_tpu_torch.cli.main_vae",
            "hoigen_tpu_torch.cli.finetune_ship",
            "hoigen_tpu_torch.cli.train_detr",
            "hoigen_tpu_torch.cli.detections",
            # parallelism, the inference CLI, profiling and the remainder
            "hoigen_tpu_torch.parallel",
            "hoigen_tpu_torch.parallel.distributed",
            "hoigen_tpu_torch.parallel.mesh",
            "hoigen_tpu_torch.tools.mesh_graph_check",
            "hoigen_tpu_torch.cli.inference",
            "hoigen_tpu_torch.engine.profiling",
            "hoigen_tpu_torch.models.clip.resnet",
            "hoigen_tpu_torch.models.interaction_head",
            "hoigen_tpu_torch.ops.spatial",
            "hoigen_tpu_torch.ops.masks"} <= set(PORT_MODULES)
    res = _probe(*modules)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == f"ok {len(modules)}"


def _help_probe(cli):
    return _PROBE.replace("for name in sys.argv[1:]:", f"""import runpy
from hoigen_tpu_torch.models.clip.tokenizer import tokenize
assert tokenize(["a photo of a person riding a bicycle."])[0, 1] > 0
sys.argv = ["{cli}", "--help"]
try:
    runpy.run_module("hoigen_tpu_torch.cli.{cli}", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
for name in []:""").replace('print("ok", len(sys.argv) - 1)', 'print("ok")')


def test_port_cli_prints_its_help_without_jax():
    """``python -m hoigen_tpu_torch.cli.main_finetune --help`` under the
    same guard, and the text path tokenizes there (stdlib ``re``)."""
    res = subprocess.run([sys.executable, "-c", _help_probe("main_finetune")],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert "--gen-rounds" in res.stdout and "--resume" in res.stdout
    assert res.stdout.strip().endswith("ok")


@pytest.mark.parametrize("cli,flags", [
    ("prepare_data", ["--host-crops", "vcoco-annotations"]),
    ("main_vae", ["--ctx-init", "--split-json"]),
    ("finetune_ship", ["--vae-ckpt", "--gt-features"]),
    ("train_detr", ["--lr-backbone", "--no-aux-loss"]),
    ("detections", ["--label-map", "--score-thresh"]),
    ("inference", ["--action-score-thresh", "--failure"])])
def test_generator_and_detr_clis_print_their_help_without_jax(cli, flags):
    """The same for the generator pipeline's and the DETR finetune's
    CLIs."""
    res = subprocess.run([sys.executable, "-c", _help_probe(cli)], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert all(f in res.stdout for f in flags), res.stdout
    assert res.stdout.strip().endswith("ok")
