"""The benchmark's own tests. Tests that need a CUDA card carry the
``hoibench_card`` marker and decide inside the test whether one is there;
the rest run on the CPU at tiny sizes."""
import dataclasses
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


# OpenAI CLIP ViT-L/14@336px (arXiv:2103.00020) as the adapter-CLIP tower,
# adapters on all of its blocks: the widths a configuration of it gives
VITL14_336 = {"clip_vision_width": 1024, "clip_vision_layers": 24,
              "clip_patch": 14, "clip_resolution": 336,
              "clip_embed_dim": 768, "adapter_layers": 24}


def vitl14_336(config):
    """A copy of a configuration at ViT-L/14@336px widths."""
    return dict(config, name=config["name"].replace("vitb16", "vitl14-336"),
                widths=dict(config["widths"], **VITL14_336))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "hoibench_card: needs a CUDA card (skips without one)")


def shrink(cfg):
    """A tiny model of the same structure: two CLIP blocks of width 64,
    a two-layer DETR of width 64 with 12 queries, 4 instances a group."""
    from hoigen_tpu_torch.models.proposals import ProposalConfig
    return dataclasses.replace(
        cfg,
        clip=dataclasses.replace(cfg.clip, image_resolution=32,
                                 vision_layers=2, vision_width=64,
                                 vision_patch_size=8, adapter_layers=(0, 1)),
        detr=dataclasses.replace(cfg.detr, hidden_dim=64, nheads=2,
                                 enc_layers=2, dec_layers=2,
                                 dim_feedforward=128, num_queries=12),
        upt=dataclasses.replace(cfg.upt, clip_resolution=32,
                                proposals=ProposalConfig(max_instances=4)))


@pytest.fixture
def small_sizes(monkeypatch):
    """The traffic generator's buckets and scales cut to tiny images."""
    from hoibench import traffic as T
    monkeypatch.setattr(T, "BUCKETS", ((64, 96), (96, 64), (96, 96)))
    monkeypatch.setattr(T, "TRAIN_SCALES", (48, 56, 64))
    monkeypatch.setattr(T, "EVAL_MIN_SIDE", 64)
    monkeypatch.setattr(T, "MAX_SIDE", 96)
    monkeypatch.setattr(T, "CROP_RESIZE", (48, 64))
    monkeypatch.setattr(T, "CROP_RANGE", (40, 48))


def tiny_run(workload, seed=2 ** 31 + 5, **over):
    """A cells.Run of ``workload`` on the CPU at a tiny size (batch 2, a
    pool of 4, small images)."""
    from hoibench import spec
    cell = spec.Cell(workload)
    return tiny_mix(cell.config, cell.traffic, seed, **over), cell


def tiny_mix(config, traffic, seed=2 ** 31 + 5, **over):
    """A cells.Run of a configuration and a mix (their dicts, or the names
    of their files) that no cell pairs yet, at the same tiny size."""
    from hoibench import cells as C, spec
    if isinstance(config, str):
        config = spec.load_json(spec.HERE / "configs" / f"{config}.json")
    if isinstance(traffic, str):
        traffic = spec.load_json(spec.HERE / "traffic" / f"{traffic}.json")
    over.setdefault("shrink", shrink)
    return C.Run(seed=seed, seconds=0.5, trace=False,
                 config=dict(config, orientations=[[0.7, 96, 64],
                                                   [0.3, 64, 96]]),
                 traffic=dict(traffic, batch=2, pool=4), device="cpu",
                 **over)
