"""A configuration's ``widths`` held to the model the port builds from its
flags (``model.check_widths``): both accepted configurations pass, a copy
with one CLIP width changed is refused with the key named, and the
refusal comes before anything is built, in the timed program's path, in
the control's and in ``run.py``, which then prints no result."""
import copy
import json
import shutil

import pytest

from hoibench import control, model as M, run as R, spec
from hoibench.tests.conftest import ROOT, shrink, tiny_run, vitl14_336

WORKLOADS = ("hico-rfuc-train-b32", "vcoco-eval-b32")


def port_model(cell):
    """The port's model config of a cell, as ``make_model_config`` returns
    it (full widths; a dataclass, nothing drawn)."""
    from hoigen_tpu_torch.cli.main_finetune import make_model_config
    return make_model_config(M.run_config(cell.config, cell.traffic), "cpu")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_accepted_configurations_pass(workload):
    cell = spec.Cell(workload)
    cfg = M.model_config(cell.config, M.run_config(cell.config,
                                                   cell.traffic), "cpu")
    M.check_widths(cell.config, cfg)
    assert set(M.port_widths(cfg)) == set(cell.config["widths"]) - {
        "dino_backbone"}


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("key, value, places", [
    ("clip_resolution", 336, ("clip.image_resolution",
                              "upt.clip_resolution")),
    ("clip_embed_dim", 768, ("clip.embed_dim", "upt.visual_output_dim")),
    ("clip_vision_layers", 24, ("clip.vision_layers",)),
])
def test_one_width_changed_is_refused(workload, key, value, places):
    cell = spec.Cell(workload)
    bad = copy.deepcopy(cell.config)
    bad["widths"][key] = value
    with pytest.raises(M.WidthsMismatch) as e:
        M.check_widths(bad, port_model(cell))
    msg = str(e.value)
    assert f"{key}: {value!r} in the file" in msg
    for where in places:
        assert where in msg
    assert msg.count(" in the file") == len(places)


def test_a_key_missing_or_unknown_is_refused():
    cell = spec.Cell("hico-rfuc-train-b32")
    cfg = port_model(cell)
    bad = copy.deepcopy(cell.config)
    del bad["widths"]["adapter_bottleneck"]
    bad["widths"]["clip_heads"] = 12
    with pytest.raises(M.WidthsMismatch) as e:
        M.check_widths(bad, cfg)
    assert "adapter_bottleneck: missing from the file" in str(e.value)
    assert "clip_heads: 12 in the file, no counterpart" in str(e.value)
    # the DINO tower is the port's one ResNet-50 whatever the key says
    doc = copy.deepcopy(cell.config)
    doc["widths"]["dino_backbone"] = "vit_b16"
    M.check_widths(doc, cfg)


def test_vit_l14_336_widths_are_refused_by_todays_port():
    cell = spec.Cell("hico-rfuc-train-b32")
    with pytest.raises(M.WidthsMismatch) as e:
        M.check_widths(vitl14_336(cell.config), port_model(cell))
    assert "clip_vision_width: 1024 in the file, the port builds " \
        "clip.vision_width 768" in str(e.value)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_program_and_control_check_before_the_shrink(workload):
    """The check holds the full-width model, before the CPU tests'
    ``shrink``, in the program's set-up and in the control's."""
    run, _ = tiny_run(workload)
    run.config = copy.deepcopy(run.config)
    run.config["widths"]["clip_embed_dim"] = 768
    with pytest.raises(M.WidthsMismatch, match="clip_embed_dim"):
        M.build_program(run.seed, run.config, run.traffic, "cpu", shrink)
    with pytest.raises(M.WidthsMismatch, match="clip_embed_dim"):
        control.control_numbers(run)


def test_run_exits_non_zero_naming_the_key(tmp_path, monkeypatch, capsys):
    """``run.py`` on a copy whose configuration has one width changed:
    a non-zero exit, the key on standard error, no JSON line. The card's
    part of the run is stood in for by the program's set-up on the CPU."""
    shutil.copytree(ROOT / "hoibench", tmp_path / "hoibench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    path = tmp_path / "hoibench" / "configs" / "hoigen-vitb16-vcoco.json"
    config = json.loads(path.read_text())
    config["widths"]["clip_resolution"] = 336
    path.write_text(json.dumps(config))
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(R, "ROOT", tmp_path)
    monkeypatch.setattr(R, "run_cell", lambda cell, args: M.build_program(
        args.seed, cell.config, cell.traffic, "cpu", shrink))
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    rc = R.main(["--workload", "vcoco-eval-b32", "--seed",
                 str(2 ** 33 + 1), "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0
    assert "clip_resolution: 336 in the file" in out.err
    assert "{" not in out.out
