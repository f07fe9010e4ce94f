"""A configuration, a traffic mix of a new kind (its feed), an end-to-end
metric and a per-layer metric are added as new files and BENCHMARK.json
entries, in a copy of the benchmark, and found by name with no edit to a
file that was there."""
import hashlib
import json
import pathlib
import shutil

import pytest

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


def test_a_vit_l14_336_configuration_is_found_and_followed(tmp_path):
    """A configuration at another CLIP tower's widths, and its cell, come
    as a new file and new entries; its caches, its step's FLOPs, its CLIP
    attention's shape and its check against the port follow its widths."""
    from hoibench import cells as C, model as M, readers, roofline as R, \
        traffic as T
    from hoibench.tests.conftest import vitl14_336
    shutil.copytree(HERE, tmp_path / "hoibench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = tmp_path / "hoibench"
    before = digests(b)

    config = vitl14_336(json.loads(
        (b / "configs" / "hoigen-vitb16-hicodet-rfuc.json").read_text()))
    name = config["name"]
    assert name == "hoigen-vitl14-336-hicodet-rfuc"
    (b / "configs" / f"{name}.json").write_text(json.dumps(config))
    (b / "limits" / "hico-rfuc-vitl-train-b32.json").write_text(
        (b / "limits" / "hico-rfuc-train-b32.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name=name,
                                 file=f"hoibench/configs/{name}.json"))
    bench["workloads"].append({
        "name": "hico-rfuc-vitl-train-b32", "config": name,
        "traffic": "train-ready", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "hico-rfuc-train-b32" in m.get("workloads", ()):
            m["workloads"].append("hico-rfuc-vitl-train-b32")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.Cell("hico-rfuc-vitl-train-b32", root=tmp_path)
    w = cell.config["widths"]
    assert (w["clip_vision_width"], w["clip_resolution"],
            w["clip_embed_dim"]) == (1024, 336, 768)
    assert "step_mfu.train" in [m["name"] for m in cell.per_layer]

    caches = T.make_caches(2 ** 31 + 11, cell.config, 117, 2)
    assert caches["cache_h"].shape == (234, 768)
    assert caches["origin_text_embeddings"].shape == (117, 768)

    run = C.Run(seed=1, seconds=1.0, trace=False, config=cell.config,
                traffic=cell.traffic, device="cpu", window_s=1.0,
                window_hw=[(1344, 1344)])
    flops = R.step_flops(32, (1344, 1344), True, 117, 2, w)
    assert cell.reader("step_mfu.train")([run]) == 100.0 * \
        R.least_seconds(flops)
    dense, attn = R.clip_flops(1024, 24, 14, 336, 768, 64,
                               adapter_layers=24)
    vitb = spec.Cell("hico-rfuc-train-b32", root=tmp_path).config["widths"]
    gap = {p: flops[p] - R.step_flops(32, (1344, 1344), True, 117, 2,
                                      vitb)[p] for p in flops}
    small = R.clip_flops()
    head_l = R.head_flops(117, 234, dim=768, prior_in=773)
    head_b = R.head_flops(117, 234)
    dino = R.resnet50_flops(336, 336)[0] - R.resnet50_flops(224, 224)[0]
    assert gap["float32"] == 32 * (2 * (dense - small[0])
                                   + 3 * (head_l[1] - head_b[1]))
    assert gap["bfloat16"] == 32 * (dino + 3 * (attn - small[1])
                                    + 3 * (head_l[0] - head_b[0]))
    assert readers.clip_shape(run) == (32, 16, 577, 64)

    # today's port builds ViT-B/16 from these flags
    with pytest.raises(M.WidthsMismatch, match="clip_vision_width: 1024"):
        M.model_config(cell.config, M.run_config(cell.config, cell.traffic),
                       "cpu")
    after = digests(b)
    assert all(after[k] == v for k, v in before.items())
