"""The port's inference CLI (``hoigen_tpu_torch/cli/inference.py``)
against the JAX CLI's, on the CPU, on the 5-image fixture and the tiny
model of ``tests/test_torch_cli.py`` with the same weights (the leaves
each package draws from its own generator handed over from the JAX run,
as ``tests/test_torch_cli.py`` hands them over for ``--eval``).

In all three modes (the default listing, ``--action K`` and ``--action K
--failure``) the printed listing equals the JAX CLI's line for line, and
the figures are written under the JAX CLI's names: PNGs of the original
image's size (Pillow draws them where the JAX CLI uses matplotlib).
"""
import os

import numpy as np
import pytest
from PIL import Image

from hoigen_tpu.cli import inference as jinf
from hoigen_tpu.cli import main_finetune as jmf
from hoigen_tpu.data import factory as jfactory
from hoigen_tpu.engine import hoi_model as jhm
from hoigen_tpu.labels import HICO

from hoigen_tpu_torch.cli import inference as tinf
from hoigen_tpu_torch.cli import main_finetune as tmf
from hoigen_tpu_torch.data import factory as tfactory
from hoigen_tpu_torch.engine import hoi_model as thm

from test_torch_cli import BUCKETS, TRANSFORM, _hand_over, \
    _jax_tiny_model_config, _patch_port, files  # noqa: F401

_LISTING = ("=> Action", "(", "saved ")


def _listing(text, out_dir):
    """The lines of the pair listing and the saved-file lines, with the
    run's output directory cut out."""
    return [line.replace(out_dir, "<out>") for line in text.splitlines()
            if line.startswith(_LISTING)]


@pytest.fixture
def both_clis(files, tmp_path, monkeypatch):
    """-> run(extra argv) -> (JAX listing, port listing, port output
    directory), the two CLIs at the tiny model on the same weights."""
    import functools
    monkeypatch.chdir(tmp_path)
    _patch_port(monkeypatch)
    monkeypatch.setattr(jmf, "make_model_config", _jax_tiny_model_config)
    monkeypatch.setattr(jfactory, "DataFactory", functools.partial(
        jfactory.DataFactory, clip_resolution=32,
        transform_kwargs=TRANSFORM))
    monkeypatch.setattr(jfactory, "DEFAULT_BUCKETS", BUCKETS)
    # the inference CLIs take DataFactory from data/factory.py
    monkeypatch.setattr(tfactory, "DataFactory", tmf.DataFactory)
    _hand_over(monkeypatch)
    # the inference CLIs take init_hoi_model from engine/hoi_model.py
    monkeypatch.setattr(jhm, "init_hoi_model", jmf.init_hoi_model)
    monkeypatch.setattr(thm, "init_hoi_model", tmf.init_hoi_model)
    data, paths = files
    common = ["--data-root", data, "--num-classes", "117", "--dino",
              "false", "--generate-feature", "false", "--max-gt-pairs", "4",
              "--index", "1", "--action-score-thresh", "0.0",
              "--clip-model-path", paths["clip"], "--pretrained-detr",
              paths["detr"], "--file1", paths["pairs"]]
    def run(extra, capture):
        jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
        jinf.main(common + ["--output-dir", jout] + extra)
        want = _listing(capture.readouterr().out, jout)
        tinf.main(common + ["--output-dir", tout] + extra, device="cpu")
        got = _listing(capture.readouterr().out, tout)
        return want, got, tout
    return run


def _png(path, size):
    assert os.path.isfile(path), path
    with Image.open(path) as im:
        assert im.format == "PNG" and im.size == size


def test_inference_listing_and_figures_match_jax(both_clis, files, capsys):
    """Default mode on the fixture's second image (the first gives the
    tiny random model no pair), then --action K and --action K --failure
    for the first listed action: the listing line for line, the figures
    at the JAX CLI's names."""
    data, _ = files
    want, got, out = both_clis([], capsys)
    assert got == want
    actions = [line for line in got if line.startswith("=> Action")]
    pairs = [line for line in got if line.startswith("(")]
    assert actions and pairs and got[-1].startswith("saved ")
    size = tmf.DataFactory("hicodet", "test2015", data,
                           training=False).dataset.load_image(1).size
    _png(os.path.join(out, "vis_000001.png"), size)
    _png(os.path.join(out, "vis_000001_boxes.png"), size)

    k = HICO.verbs_sentence.index(actions[0].split(": ", 1)[1])
    for failure in ([], ["--failure"]):
        want, got, out = both_clis(["--action", str(k)] + failure, capsys)
        assert got == want and len(got) == 1
        name = f"vis_000001_action_{k:03d}{'_failure' if failure else ''}"
        _png(os.path.join(out, name + ".png"), size)


def test_draw_functions_draw_at_the_given_coordinates(tmp_path):
    """Each figure keeps the image's size and paints the box outlines in
    the JAX CLI's colours where the boxes are."""
    image = Image.new("RGB", (64, 48))
    p = tinf.draw_action_pairs(image, [[4, 4, 30, 40]], [[34, 8, 60, 20]],
                               [0.5], str(tmp_path / "a.png"))
    with Image.open(p) as im:
        assert im.size == (64, 48)
        assert im.getpixel((4, 20)) == tinf.BLUE
        assert im.getpixel((60, 14)) == tinf.RED
    p = tinf.draw_boxes(image, np.asarray([[10.0, 10.0, 50.0, 40.0]]),
                        str(tmp_path / "b.png"))
    with Image.open(p) as im:
        assert im.getpixel((50, 30)) == tinf.WHITE
    p = tinf.draw_box_pairs(image, [[4, 20, 30, 40]], [[34, 24, 60, 40]],
                            np.asarray([0.7]), np.asarray([3]),
                            str(tmp_path / "c.png"))
    with Image.open(p) as im:
        assert im.getpixel((60, 30)) == tinf.RED
