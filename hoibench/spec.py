"""``BENCHMARK.json`` read by name: a cell's configuration file, traffic
mix, limits and metrics, and the readers of its per-layer metrics. Every
piece is a file of its own found by the name the benchmark gives it, so a
cell, a mix, a configuration or a metric is added by adding files and
entries, with no edit to a file that is there:

- ``configs/<config>.json`` (the ``file`` of its entry), the configuration;
- ``traffic/<traffic>.json``, the mix's parameters;
- ``feeds/<mode>_<feed>.py``, the run of a kind of mix (the mix's
  ``mode`` and ``feed``): ``run(run, t_start)`` makes the set-up, the
  window, the trace and the comparison and returns the numbers compared;
  ``inputs(run, rc, cfg, caches)`` gives the control the batches the
  comparison takes and, in training, ``run_seed(run, rc)`` the seed of
  the steps' dropout draws;
- ``limits/<workload>.json``, the limits of the numbers compared;
- ``metrics/<metric>.py``, a metric's reader, end-to-end or per-layer:
  ``read(runs)`` over the run of every rank, returning a number or None
  (nothing to read: the metric is left out of the line).
"""
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(pathlib.Path(root) / "BENCHMARK.json")


class Cell:
    """One workload of the benchmark with everything found by its
    names."""

    def __init__(self, name, root=ROOT):
        root = pathlib.Path(root)
        here = root / HERE.name
        bench = benchmark(root)
        matches = [w for w in bench["workloads"] if w["name"] == name]
        if not matches:
            raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
        self.workload = matches[0]
        self.name = name
        self.chips = int(self.workload["chips"])
        conf = [c for c in bench["configs"]
                if c["name"] == self.workload["config"]][0]
        self.config = load_json(root / conf["file"])
        self.traffic = load_json(here / "traffic"
                                 / f"{self.workload['traffic']}.json")
        self.limits = load_json(here / "limits" / f"{name}.json")["limits"]
        self.end_to_end = [m for m in bench["end_to_end"] if applies(m, name)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if applies(m, name) and m["moves"] in reported]
        self.here = here

    def reader(self, metric):
        """The ``read`` function of ``metrics/<metric>.py``."""
        return load_module(self.here / "metrics" / f"{metric}.py",
                           "hoibench_metric_").read


def feed_of(traffic, root=ROOT):
    """The module of ``feeds/<mode>_<feed>.py`` for a mix."""
    name = f"{traffic['mode']}_{traffic['feed']}"
    return load_module(pathlib.Path(root) / HERE.name / "feeds"
                       / f"{name}.py", "hoibench_feed_")


def load_module(path, prefix):
    spec = importlib.util.spec_from_file_location(
        prefix + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric, workload):
    return "workloads" not in metric or workload in metric["workloads"]
