"""The yardstick's counts against hand counts, and the bound times of the
kernel table in PERF.md section 6 worked out again."""
import pytest

from hoibench import roofline as R


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


def test_step_least_time_is_below_any_step():
    w = {"clip_vision_width": 768, "clip_vision_layers": 12,
         "detr_classes": 81}
    train = R.least_seconds(R.step_flops(32, (1344, 1344), True, 117, 2, w))
    evals = R.least_seconds(R.step_flops(32, (1344, 1344), False, 24, 2, w))
    assert 0.02 < evals < train < 0.08
