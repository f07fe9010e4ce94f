"""The cell ``hico-rfuc-vitl14-train-b32`` and its configuration
``hoigen-vitl14-336-hicodet-rfuc``: CLIP ViT-L/14@336px through the port's
``--clip-model``. The file's widths are the model the port builds from its
flags, and are refused without the flag; the step's FLOPs agree with a
count by hand; the caches are drawn at the tower's 768-wide embedding; the
K1/K4 shape its readers take is the tower's."""
import copy

import pytest

from hoibench import cells as C, model as M, readers, roofline as R, spec, \
    traffic as T

CELL = "hico-rfuc-vitl14-train-b32"


def test_the_configuration_is_the_model_the_port_builds():
    cell = spec.Cell(CELL)
    assert cell.config["name"] == "hoigen-vitl14-336-hicodet-rfuc"
    assert cell.config["flags"][-2:] == ["--clip-model", "ViT-L/14@336px"]
    assert cell.config["reduced"] == []
    cfg = M.model_config(cell.config, M.run_config(cell.config,
                                                   cell.traffic), "cpu")
    assert (cfg.clip.vision_width, cfg.clip.vision_layers,
            cfg.clip.vision_patch_size, cfg.upt.clip_resolution,
            cfg.upt.visual_output_dim) == (1024, 24, 14, 336, 768)
    assert set(M.port_widths(cfg)) == set(cell.config["widths"]) - {
        "dino_backbone"}
    # the reference takes the port's settings, the ViT-L tower included
    ref = M.reference_config(cfg)
    assert (ref.clip.vision_heads, ref.clip.grid_size) == (16, 24)


def test_without_the_flag_it_is_refused_naming_the_width():
    cell = spec.Cell(CELL)
    bad = copy.deepcopy(cell.config)
    i = bad["flags"].index("--clip-model")
    del bad["flags"][i:i + 2]
    with pytest.raises(M.WidthsMismatch) as e:
        M.model_config(bad, M.run_config(bad, cell.traffic), "cpu")
    assert "clip_vision_width: 1024 in the file, the port builds " \
        "clip.vision_width 768" in str(e.value)


def test_step_flops_match_a_count_by_hand():
    """The training step at 32 images of (1344, 1344): CLIP's f32 work
    forward and backward (input gradients) and the head's f32 work three
    times, counted here product by product: 22.70 TFLOP."""
    w = spec.Cell(CELL).config["widths"]
    tokens, width, patch, embed = 577, 1024, 14, 768

    def mha(lq, lk, d):                 # projections and two products
        return 2 * lq * d * d + 4 * lk * d * d + 2 * lq * d * d \
            + 4 * lq * lk * d
    patch_embed = 2 * 576 * 3 * patch * patch * width
    # qkv (3), out (1) and the MLP's two 4x products (8): 12 width^2
    block = 2 * tokens * 12 * width * width
    adapter = (2 * tokens * width * 64 * 2 + mha(tokens, 30, 64)
               + 4 * tokens * 64 * 128)
    proj = 2 * tokens * width * embed
    clip = patch_embed + 24 * (block + adapter) + proj
    rows = 117 * 2
    head = (2 * 450 * embed * 117 + 2 * embed * rows + 2 * rows * 117
            + 2 * 2048 * rows + 2 * rows * 117
            + 2 * 30 * ((embed + 5) * 128 + 128 * 128 + 128 * 64))
    hand = 32 * (2 * clip + 3 * head)
    got = R.step_flops(32, (1344, 1344), True, 117, 2, w)["float32"]
    assert hand == pytest.approx(22.70e12, rel=5e-3)
    assert got == pytest.approx(hand, rel=5e-3)


def test_caches_and_kernel_shapes_follow_the_tower():
    cell = spec.Cell(CELL)
    caches = T.make_caches(2 ** 31 + 3, cell.config, 117, 2)
    for k in ("cache_h", "cache_o", "cache_u", "object_embedding",
              "origin_text_embeddings"):
        assert caches[k].shape[1] == 768, k
    assert caches["clip_global_keys"].shape == (768, 234)
    run = C.Run(seed=1, seconds=1.0, trace=False, config=cell.config,
                traffic=cell.traffic, device="cpu")
    assert readers.clip_shape(run) == (32, 16, 577, 64)
    assert [m["name"] for m in cell.end_to_end] == ["train_images_per_s",
                                                     "setup_s"]
    assert {m["name"] for m in cell.per_layer} == {
        "train_call_host_ms", "graph_captures.train", "idle_share.train",
        "step_mfu.train", "k1_clip_roofline.train", "k4_roofline.train"}
