"""The traffic generator: the same batches for the same seed, others for
another seed, the same signatures at the same steps for every seed, each
at its share of the mix's batches, and the port's own plan, bucket and
padding rules."""
import collections
import hashlib

import numpy as np
import pytest

from hoibench import spec, traffic as T
from hoibench.model import Caches
from hoibench.tests.conftest import vitl14_336


def pools(seed, workload="hico-rfuc-train-b32", batch=2, pool=2):
    cell = spec.Cell(workload)
    traffic = dict(cell.traffic, batch=batch, pool=pool)
    caches = Caches(**T.make_caches(seed, cell.config, 117, 2))
    return T.make_batches(seed, cell.config, traffic, 117, caches=caches)


def same(a, b):
    return all(a[k].shape == b[k].shape and np.array_equal(a[k], b[k])
               for k in a) and a.keys() == b.keys()


def test_same_seed_same_pool_other_seed_other_pool():
    (a, sa), (b, sb), (c, sc) = (pools(2 ** 31 + 11), pools(2 ** 31 + 11),
                                 pools(2 ** 31 + 12))
    assert all(same(x, y) for x, y in zip(a, b))
    assert not any(same(x, y) for x, y in zip(a, c))
    assert sa == sb == sc
    assert [a[i]["images"].shape for i in sa] == \
        [c[i]["images"].shape for i in sc]


@pytest.mark.parametrize("workload", ["hico-rfuc-train-b32",
                                      "vcoco-eval-b32"])
def test_each_signature_takes_its_share_of_the_epoch(workload):
    cell = spec.Cell(workload)
    traffic = dict(cell.traffic, pool=2)
    shares = T.signature_shares(cell.config, traffic)
    assert sum(shares.values()) == pytest.approx(1.0)
    pool, steps = T.make_batches(2 ** 31 + 3, cell.config,
                                 dict(traffic, batch=traffic["batch"]), 117)
    n = T.epoch_steps(cell.config, traffic)
    assert len(steps) == n
    hws = [T.padded_hw([tuple(s) for s in pool[i]["image_sizes"]])
           for i in steps]
    assert hws == [pool[i]["images"].shape[2:] for i in steps]
    count = collections.Counter(hws)
    main = max(shares, key=shares.get)
    for sig, share in shares.items():
        if sig != main:
            assert count[sig] == round(share * n)
    if workload.startswith("hico"):
        # HICO-DET's training mix: about 0.7% of batches hold no portrait
        # and pad to (800, 1344), the first at half their spacing
        assert 0.004 < shares[(800, 1344)] < 0.01
        at = [i for i, hw in enumerate(hws) if hw == (800, 1344)]
        assert len(at) == round(shares[(800, 1344)] * n) >= 5
        gaps = np.diff(at)
        assert gaps.max() - gaps.min() <= 1
        assert abs(at[0] - gaps[0] / 2) <= 1


def test_shares_follow_batches_drawn_one_by_one(small_sizes):
    """The exact shares against batches drawn by the sequential plan, at
    tiny buckets where every signature is common."""
    cell = spec.Cell("hico-rfuc-train-b32")
    config = dict(cell.config, orientations=[[0.7, 96, 64], [0.3, 64, 96]])
    traffic = dict(cell.traffic, batch=3)
    shares = T.signature_shares(config, traffic)
    rng = np.random.default_rng(9)
    drawn = collections.Counter()
    for _ in range(4000):
        sizes = T.original_sizes(rng, 3, config["orientations"],
                                 config["size_jitter"])
        drawn[T.padded_hw([T.out_hw(w, h, True, rng)
                           for w, h in sizes])] += 1
    assert set(drawn) <= set(shares)
    for sig, share in shares.items():
        assert abs(drawn[sig] / 4000 - share) < 0.03, (sig, share, drawn)


@pytest.mark.parametrize("training", [True, False])
def test_sizes_follow_the_ports_plan_and_buckets(training):
    from hoigen_tpu_torch.data.factory import pick_bucket
    from hoigen_tpu_torch.data.transforms import DualStreamTransform
    plan = DualStreamTransform(training, seed=3)
    rng = np.random.default_rng(5)
    for _ in range(300):
        w, h = (int(x) for x in rng.integers(200, 1400, size=2))
        seed = int(rng.integers(1 << 30))
        want = plan.plan(w, h, rng=np.random.default_rng(seed))["out_hw"]
        got = T.out_hw(w, h, training, np.random.default_rng(seed))
        assert got == tuple(want)
        assert T.pick_bucket(*got) == pick_bucket(*got)
        assert T.BUCKETS[int(T.bucket_index(np.asarray([got[0]]),
                                            np.asarray([got[1]]))[0])] \
            == pick_bucket(*got)


def test_sizes_over_arrays_are_the_plans_sizes():
    rng = np.random.default_rng(11)
    w = rng.integers(40, 2000, 2000)
    h = rng.integers(40, 2000, 2000)
    for size, cap in ((800, 1333), (480, 1333), (500, None)):
        gh, gw = T.aspect_sizes(w, h, size, cap)
        want = [T.aspect_size(int(a), int(b), size, cap)
                for a, b in zip(w, h)]
        assert list(zip(gh.tolist(), gw.tolist())) == want


def test_padding_is_the_element_wise_max_of_buckets():
    from hoigen_tpu_torch.data.factory import pick_bucket
    rng = np.random.default_rng(7)
    for _ in range(50):
        hws = [tuple(int(x) for x in rng.integers(300, 1334, size=2))
               for _ in range(6)]
        buckets = [pick_bucket(h, w) for h, w in hws]
        assert T.padded_hw(hws) == (max(b[0] for b in buckets),
                                    max(b[1] for b in buckets))


def test_pool_pixels_are_zero_in_the_padding():
    for b in pools(2 ** 31 + 13)[0]:
        for img, (h, w) in zip(b["images"], b["image_sizes"]):
            assert not img[:, h:, :].any() and not img[:, :, w:].any()
            assert img[:, :h, :w].any()


def digest(arrays):
    """sha256 over each array's name, dtype, shape and bytes, by name."""
    h = hashlib.sha256()
    for k in sorted(arrays):
        a = np.ascontiguousarray(arrays[k])
        for part in (k, str(a.dtype), str(a.shape)):
            h.update(part.encode())
        h.update(a.tobytes())
    return h.hexdigest()


# make_caches' arrays as they stood while the width was the constant 512
CACHE_DIGESTS = {
    ("hoigen-vitb16-hicodet-rfuc", 2 ** 31 + 11):
        "39fb5e5ac4ed1a03972a8af180432741f7ac4876357451f5301580c678c5467a",
    ("hoigen-vitb16-hicodet-rfuc", 7 * 2 ** 40 + 3):
        "812a9b738fc091822f67d8891bb1e45b6051eacb4f5703f3006ca3c0347fcf86",
    ("hoigen-vitb16-vcoco", 2 ** 31 + 11):
        "858a67dd692dc8dced42e48adf56ab284d22e7abbd2673a0e85c86a61b6a060d",
    ("hoigen-vitb16-vcoco", 7 * 2 ** 40 + 3):
        "720be503cd2cf821ba8127e156a55a49d369db334b37ea7225ef2ce752d12bfe",
}
FEATURES = ("cache_h", "cache_o", "cache_u", "object_embedding",
            "origin_text_embeddings")


@pytest.mark.parametrize("name, seed", sorted(CACHE_DIGESTS))
def test_caches_at_512_are_unchanged(name, seed):
    config = spec.load_json(spec.HERE / "configs" / f"{name}.json")
    w = config["widths"]
    caches = T.make_caches(seed, config, w["num_classes"], w["num_shot"])
    assert caches["cache_h"].shape[1] == w["clip_embed_dim"] == 512
    assert digest(caches) == CACHE_DIGESTS[name, seed]


def test_caches_follow_the_configurations_embedding_width():
    config = vitl14_336(spec.load_json(
        spec.HERE / "configs" / "hoigen-vitb16-hicodet-rfuc.json"))
    caches = T.make_caches(2 ** 31 + 11, config, 117, 2)
    for k in FEATURES:
        assert caches[k].shape[1] == 768, k
        np.testing.assert_allclose(np.linalg.norm(caches[k], axis=1), 1.0,
                                   rtol=1e-5)
    keys = caches["clip_global_keys"]
    assert keys.shape == (768, 234)
    np.testing.assert_allclose(np.linalg.norm(keys, axis=0), 1.0, rtol=1e-5)
    assert caches["dino_keys"].shape == (2048, 234)
