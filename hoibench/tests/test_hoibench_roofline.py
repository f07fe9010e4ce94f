"""The yardstick's counts against hand counts, and the bound times of the
kernel table in PERF.md section 6 worked out again."""
import pytest

from hoibench import roofline as R, spec
from hoibench.tests.conftest import VITL14_336, vitl14_336

CONFIGS = ("hoigen-vitb16-hicodet-rfuc", "hoigen-vitb16-vcoco")


def widths_of(name):
    return spec.load_json(spec.HERE / "configs" / f"{name}.json")["widths"]


def test_k1_hand_count():
    # b=1, h=1, 2 queries, 2 keys, d=4, f32: q, k, v, out of 8 values each
    t, by = R.k1(1, 1, 2, 2, 4, 4)
    assert t == pytest.approx(max(4 * 4 * 8 / R.HBM_BYTES_PER_S,
                                  4 * 4 * 4 / R.BF16_FLOPS,
                                  4 / (16 * 132 * 1.98e9)))


def test_k2_hand_count():
    t, _ = R.k2(1, 1, 1, c=2, m=1, blocks=1)
    flops = 2 * 1 * (2 * 2 * 1 + 9 * 1)
    nbytes = 2 * 2 * 2 + 2 * (2 + 9 + 2) + 4 * 2 * (1 + 1 + 2)
    assert t == pytest.approx(max(nbytes / R.HBM_BYTES_PER_S,
                                  flops / R.BF16_FLOPS))


def test_resnet50_and_vit_counts():
    # ResNet-50 at 224: 4.09 G multiply-adds; ViT-B/16: 17.6 G
    assert R.resnet50_flops(224, 224)[0] / 2e9 == pytest.approx(4.09, 0.01)
    dense, attn = R.clip_flops(adapter_layers=0)
    assert (dense + attn - 2 * 197 * 768 * 512) / 2e9 == pytest.approx(
        17.6, rel=0.01)


@pytest.mark.parametrize("bound_ms, got", [
    (0.00844, lambda: R.k1(4, 8, 1050, 1050, 32, 2, key_bias=True)),
    (0.00289, lambda: R.k1(4, 12, 197, 197, 64, 4)),
    (0.1850, lambda: R.k1(256, 12, 197, 197, 64, 4)),
    (0.00580, lambda: R.k4(4, 12, 197, 64, 4)),
    (0.0822, lambda: R.k2(4, 200, 336)),
    (0.0206, lambda: R.k2(1, 200, 336)),
])
def test_perf_md_kernel_table_bounds(bound_ms, got):
    t, _ = got()
    assert t * 1e3 == pytest.approx(bound_ms, rel=0.01)


def test_vit_l14_336_count():
    # ViT-L/14@336px without adapters or projection: 191.0 G multiply-adds,
    # within 1% of the CLIP paper's 190.7
    w = VITL14_336
    dense, attn = R.clip_flops(w["clip_vision_width"],
                               w["clip_vision_layers"], w["clip_patch"],
                               w["clip_resolution"], w["clip_embed_dim"],
                               adapter_layers=0)
    gmacs = (dense + attn - 2 * 577 * 1024 * 768) / 2e9
    assert gmacs == pytest.approx(191.0, abs=0.05)
    assert gmacs == pytest.approx(190.7, rel=0.01)


def test_step_least_time_is_below_any_step():
    train = R.least_seconds(R.step_flops(
        32, (1344, 1344), True, 117, 2,
        widths_of("hoigen-vitb16-hicodet-rfuc")))
    evals = R.least_seconds(R.step_flops(
        32, (1344, 1344), False, 24, 2, widths_of("hoigen-vitb16-vcoco")))
    assert 0.02 < evals < train < 0.08


# step_flops(32, hw, training, ...) at each accepted configuration's own
# widths, classes and shots, as the counts stood before every width was
# read from the configuration: a step's FLOPs, and so step_mfu, stay put
PINNED = {
    ("hoigen-vitb16-hicodet-rfuc", True, (1344, 1344)):
        (11599323078912, 2210971036416),
    ("hoigen-vitb16-hicodet-rfuc", True, (800, 1344)):
        (6959452135680, 2210971036416),
    ("hoigen-vitb16-hicodet-rfuc", False, (1344, 1344)):
        (11436546460416, 1150295816448),
    ("hoigen-vitb16-hicodet-rfuc", False, (800, 1344)):
        (6796675517184, 1150295816448),
    ("hoigen-vitb16-vcoco", True, (1344, 1344)):
        (11567949299712, 2206755520512),
    ("hoigen-vitb16-vcoco", True, (800, 1344)):
        (6928078356480, 2206755520512),
    ("hoigen-vitb16-vcoco", False, (1344, 1344)):
        (11426160623616, 1148890644480),
    ("hoigen-vitb16-vcoco", False, (800, 1344)):
        (6786289680384, 1148890644480),
}


@pytest.mark.parametrize("name, training, hw", sorted(PINNED))
def test_step_flops_of_the_accepted_configurations_are_pinned(name, training,
                                                              hw):
    w = widths_of(name)
    got = R.step_flops(32, hw, training, w["num_classes"], w["num_shot"], w)
    assert got == dict(zip(("bfloat16", "float32"), PINNED[name, training,
                                                            hw]))


@pytest.mark.parametrize("training", [True, False])
def test_step_flops_follow_a_vit_l14_336_configuration(training):
    """Every CLIP width, DINO's frame and the head's width are read from
    the configuration: at ViT-L/14@336px a step counts 354.5 GFLOP of dense
    CLIP work and 32.7 of attention products an image (34.5 and 1.4 at
    ViT-B/16), DINO at 18.7 (8.2) and the head at 768 wide."""
    base = widths_of("hoigen-vitb16-hicodet-rfuc")
    big = vitl14_336({"name": "hoigen-vitb16-hicodet-rfuc",
                      "widths": base})["widths"]
    dense, attn = R.clip_flops(1024, 24, 14, 336, 768, 64,
                               adapter_layers=24)
    assert (round(dense / 1e9, 1), round(attn / 1e9, 1)) == (354.5, 32.7)
    small = R.clip_flops()
    assert (round(small[0] / 1e9, 1), round(small[1] / 1e9, 1)) == (34.5,
                                                                    1.4)
    dino = R.resnet50_flops(336, 336)[0]
    assert round(dino / 1e9, 1) == 18.7
    assert round(R.resnet50_flops(224, 224)[0] / 1e9, 1) == 8.2
    hw, rows = (1344, 1344), 117 * 2
    cache, head = R.head_flops(117, rows, dim=768, prior_in=773)
    bf16 = R.detr_flops(*hw, classes=81) + dino + cache
    f32 = dense + head
    if training:
        f32 += dense + 2 * head
        bf16 += 2 * cache + 3 * attn
    else:
        f32 += attn
    assert R.step_flops(1, hw, training, 117, 2, big) == {
        "bfloat16": bf16, "float32": f32}
    if training:
        # the repro batch's f32 work: about 2.2 TFLOP at ViT-B/16, 23 here
        f32s = [R.step_flops(32, hw, True, 117, 2, w)["float32"] / 1e12
                for w in (base, big)]
        assert [round(f, 1) for f in f32s] == [2.2, 22.7]
