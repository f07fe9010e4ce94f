"""A configuration, a traffic mix of a new kind (its feed), an end-to-end
metric and a per-layer metric are added as new files and BENCHMARK.json
entries, in a copy of the benchmark, and found by name with no edit to a
file that was there."""
import hashlib
import json
import pathlib
import shutil

from hoibench import spec

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha1(
        p.read_bytes()).hexdigest() for p in root.rglob("*") if p.is_file()}


def test_new_cell_config_mix_and_metric_are_found_by_name(tmp_path):
    shutil.copytree(HERE, tmp_path / "hoibench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = digests(tmp_path / "hoibench")
    b = tmp_path / "hoibench"

    config = json.loads((b / "configs" / "hoigen-vitb16-vcoco.json")
                        .read_text())
    config["name"] = "hoigen-vitb16-vcoco-big"
    (b / "configs" / "hoigen-vitb16-vcoco-big.json").write_text(
        json.dumps(config))
    mix = json.loads((b / "traffic" / "eval-ready.json").read_text())
    mix["pool"] = 4
    mix["feed"] = "files"
    (b / "traffic" / "eval-small-pool.json").write_text(json.dumps(mix))
    (b / "feeds" / "eval_files.py").write_text(
        "def run(run, t_start):\n    return {'score_gap': 0.25}\n")
    (b / "metrics" / "eval_files_per_s.py").write_text(
        "def read(runs):\n    return 7.0\n")
    (b / "limits" / "vcoco-big-eval.json").write_text(
        json.dumps({"limits": {"score_gap": 0.5}}))
    (b / "metrics" / "host_ms.new.py").write_text(
        "def read(runs):\n    return 4.0\n")
    bench["configs"].append(dict(bench["configs"][-1],
                                 name="hoigen-vitb16-vcoco-big",
                                 file="hoibench/configs/"
                                      "hoigen-vitb16-vcoco-big.json"))
    bench["workloads"].append({
        "name": "vcoco-big-eval", "config": "hoigen-vitb16-vcoco-big",
        "traffic": "eval-small-pool", "chips": 1, "why": "a test"})
    bench["per_layer"].append({
        "name": "host_ms.new", "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "eval step",
        "moves": "eval_files_per_s", "workloads": ["vcoco-big-eval"]})
    bench["end_to_end"].insert(0, {
        "name": "eval_files_per_s", "unit": "images/s", "better": "higher",
        "bound": 0.05, "source": "host_clock",
        "workloads": ["vcoco-big-eval"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.Cell("vcoco-big-eval", root=tmp_path)
    assert cell.config["name"] == "hoigen-vitb16-vcoco-big"
    assert cell.traffic["pool"] == 4
    assert cell.limits == {"score_gap": 0.5}
    names = [m["name"] for m in cell.per_layer]
    assert "host_ms.new" in names
    assert cell.reader("host_ms.new")([]) == 4.0
    assert [m["name"] for m in cell.end_to_end] == ["eval_files_per_s",
                                                     "setup_s"]
    assert cell.reader("eval_files_per_s")([]) == 7.0
    assert spec.feed_of(cell.traffic, tmp_path).run(None, 0.0) == {
        "score_gap": 0.25}
    after = digests(tmp_path / "hoibench")
    assert all(after[k] == v for k, v in before.items())
