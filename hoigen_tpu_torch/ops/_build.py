"""Build and load the hand-written Hopper kernels in ``hoigen_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library under ``hoigen_tpu_torch/_build``
(listed in ``.gitignore``), then loaded with ``ctypes``. The library name
carries a hash of the source, so an edited kernel is rebuilt and a stale
library is never loaded. Nothing is compiled at import: the first wrapper
call (or :func:`build_all`) builds, all sources in parallel.
"""
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

SOURCES = ("attention", "fused_resnet", "cache_logits", "conv_epilogue")
CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs = {}
# ptxas report (registers, shared memory, spills) of each build, by source
build_logs = {}


def _nvcc():
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found at {path}: the CUDA kernels "
                           "build only on a machine with the CUDA toolkit")
    return str(path)


def _target(name):
    src = CSRC / f"{name}.cu"
    h = hashlib.sha1(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=SOURCES):
    """Compile every missing library, one ``nvcc`` per source, all started
    together. Raises with the compiler's output if any build fails."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in names:
            src, out = _target(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            build_logs[name] = log
            if proc.returncode != 0:
                failed.append(f"--- {name} (nvcc rc={proc.returncode})\n{log}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def library(name):
    """The loaded ctypes library of ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is None:
        _, out = _target(name)
        if not out.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
    return lib


def function(name, symbol, argtypes):
    """The C launcher ``symbol`` of ``csrc/<name>.cu`` with its argument
    types declared (pointers and the stream as ``c_void_p``, so that
    ctypes does not cut them to 32 bits); it returns a cudaError_t."""
    fn = getattr(library(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(rc, name):
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
