"""hoigen_tpu_torch stands alone: it imports neither JAX nor the JAX package.

In a fresh interpreter where ``import jax`` (and ``import hoigen_tpu``)
raise, every module of the port and ``chip_smoke.py`` import, and no module
of JAX or of the JAX package appears in ``sys.modules``.
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
        if name.split(".")[0] in ("jax", "jaxlib", "hoigen_tpu"):
            raise ImportError(f"{name} must not be imported by the port")
        return None

sys.meta_path.insert(0, _Refuse())
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "hoigen_tpu"))
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
            "hoigen_tpu_torch.labels.vcoco"} <= set(PORT_MODULES)
    res = _probe(*modules)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == f"ok {len(modules)}"
