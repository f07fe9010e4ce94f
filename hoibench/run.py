"""One run of one cell of the benchmark of ``hoigen_tpu_torch`` (the
PyTorch and CUDA port) on NVIDIA cards:

    python3 hoibench/run.py --workload <name> --seed <n> --seconds <s>
                            --trace <0|1>

from the root of a checkout. It builds the cell's configuration through
the port's own path from random weights made from ``--seed``, runs the
cell's traffic for ``--seconds`` (after a set-up that warms up and
captures every batch signature the window uses), with ``--trace 1``
profiles a few more steps, then holds what the timed path produced
against the plain reference (``hoibench/reference/``), and prints one JSON
line: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``, with the numbers compared and their
limits under ``compared``, last. It exits non-zero, printing no result,
without enough CUDA cards, when the configuration's ``widths`` are not
the model the port builds (``model.check_widths``), and when ``jax``,
``jaxlib``, ``flax`` or ``hoigen_tpu`` (the JAX package) was imported.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CACHE = ROOT / ".hoibench_cache"
# every cache of the run at a fixed place inside the checkout
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "hoigen_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit():
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30)
        return float(res.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_cell(cell, args):
    """Set-up, window, trace and comparison, by the cell's feed
    (``feeds/<mode>_<feed>.py``). -> the Run, ``numbers`` filled in."""
    import torch

    from hoibench import cells as C, spec
    device = f"cuda:{torch.cuda.current_device()}"
    run = C.Run(seed=args.seed % (1 << 63), seconds=args.seconds,
                trace=bool(args.trace), config=cell.config,
                traffic=cell.traffic, device=device)
    torch.cuda.reset_peak_memory_stats(device)
    run.numbers = spec.feed_of(cell.traffic, ROOT).run(run, T_START)
    return run


def read_metrics(cell, metrics, runs):
    """Each metric's value from its reader; one with nothing to read is
    left out."""
    out = {}
    for m in metrics:
        value = cell.reader(m["name"])(runs)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(cell, runs, args):
    import torch

    from hoibench import compare
    correct, compared = compare.judge(runs[0].numbers, cell.limits)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": max(r.memory_peak_bytes for r in runs),
              "power_limit_w": power_limit()}
    line = {"correct": correct, "attempted": runs[0].steps, "failed": 0,
            "metrics": read_metrics(cell, cell.per_layer if args.trace
                                    else cell.end_to_end, runs),
            "device": device}
    if args.trace:
        traced = [r.traced for r in runs if r.traced is not None]
        if traced:
            device["busy_s"] = sum(t["busy_s"] for t in traced) / len(traced)
            device["window_s"] = max(t["window_s"] for t in traced)
            worst = max(traced, key=lambda t: 1 - t["busy_s"] / t["window_s"])
            line["breakdown"] = {"device_ops": worst["device_ops"],
                                 "idle_gaps": worst["idle_gaps"]}
    line["compared"] = compared
    return line


def main(argv=None):
    args = parse(argv)
    import torch

    from hoibench import model as M, spec
    cell = spec.Cell(args.workload, ROOT)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"hoibench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); {have} visible", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    try:
        runs = [run_cell(cell, args)]
    except M.WidthsMismatch as e:
        print(f"hoibench: {e}", file=sys.stderr)
        return 4
    found = forbidden_modules()
    if found:
        print("hoibench: the JAX side was imported: " + ", ".join(found),
              file=sys.stderr)
        return 3
    line = result_line(cell, runs, args)
    for note in runs[0].notes:
        print("note " + note, file=sys.stderr)
    shapes = {}
    for hw in runs[0].window_hw:
        shapes[hw] = shapes.get(hw, 0) + 1
    print(f"note window steps by padded shape {shapes}", file=sys.stderr)
    for name, value in sorted(runs[0].numbers.items()):
        print(f"reading {name} {value!r}", file=sys.stderr)
    for name, c in line["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
