"""CLIP ViT-L/14@336px as the port's adapter-CLIP tower (``--clip-model``):
the preset's published widths and the UPT head's ties to them, ViT-B/16
left as it was, a ViT-L-shaped tower and training step against the plain
reference (``hoibench/reference/``) on the CPU, the converter's refusal of
a checkpoint of another tower, the CLIs' data at the tower's frame, and
the traced run's record of its tower. No JAX: the reference is the
benchmark's plain copy."""
import dataclasses
import random

import numpy as np
import pytest
import torch

from hoigen_tpu_torch.cli import main_finetune as mf
from hoigen_tpu_torch.engine import profiling
from hoigen_tpu_torch.models.clip import model as tclip
from hoigen_tpu_torch.models.clip.config import CLIP_MODELS, CLIPConfig, \
    VIT_B16, VIT_L14_336, tower_name
from hoigen_tpu_torch.models.upt import UPTConfig
from hoigen_tpu_torch.utils.config import RunConfig, parse_config

VITL = "ViT-L/14@336px"


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread while a test here runs: its tensors are tiny,
    and beside the other test workers more threads only contend (about 35
    s against 1.5 s for the training step under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
RFUC = ["--batch-size", "32", "--num-classes", "117", "--use-multi-hot",
        "true", "--dtype", "bfloat16", "--zs", "true", "--zs-type",
        "rare_first"]


def test_vit_l14_336_has_the_published_widths_and_ties():
    """CLIP (arXiv:2103.00020) Table 20: 24 blocks of 1024 in 16 heads,
    patch 14 at 336 (577 tokens), embedding 768; text 12 blocks of 768 in
    12 heads. The UPT head takes the frame and the embedding."""
    cfg = mf.make_model_config(parse_config(RFUC + ["--clip-model", VITL]),
                               "cpu")
    c = cfg.clip
    assert c == VIT_L14_336 and c.adapter_layers == tuple(range(24))
    assert (c.vision_width, c.vision_layers, c.vision_patch_size,
            c.image_resolution, c.embed_dim) == (1024, 24, 14, 336, 768)
    assert (c.vision_heads, c.grid_size ** 2 + 1) == (16, 577)
    assert (c.transformer_width, c.transformer_heads,
            c.transformer_layers, c.context_length) == (768, 12, 12, 77)
    assert c.use_adapter and c.adapter_bottleneck == 64
    assert (cfg.upt.clip_resolution, cfg.upt.visual_output_dim,
            cfg.upt.priors_initial_dim) == (336, 768, 773)
    assert tower_name(c) == VITL and CLIP_MODELS[VITL] is VIT_L14_336
    half = mf.make_model_config(RunConfig(clip_model=VITL,
                                          adapter_pos="end"), "cpu")
    assert half.clip.adapter_layers == tuple(range(12, 24))
    with pytest.raises(ValueError, match="--clip-model 'ViT-L/14'"):
        mf.make_model_config(RunConfig(clip_model="ViT-L/14"), "cpu")


@pytest.mark.parametrize("flags", [
    {}, {"dataset": "vcoco", "num_classes": 24},
    {"adapter_pos": "random", "adapter_num_layers": 2, "seed": 5},
    {"use_insadapter": False, "eval": True}])
def test_vit_b16_is_the_model_it_was(flags):
    """ViT-B/16, named or by default, is the configuration the CLI built
    before the flag, field for field: CLIPConfig's defaults with the
    adapters placed over its 12 blocks, the head at 224 and 512."""
    rc = RunConfig(**flags)
    got = mf.make_model_config(rc, "cpu")
    assert mf.make_model_config(RunConfig(**flags, clip_model="ViT-B/16"),
                                "cpu") == got
    want = CLIPConfig(
        adapter_layers=CLIPConfig.adapter_layer_ids(
            rc.adapter_pos, 12, rng=random.Random(rc.seed)),
        adapter_num_layers=rc.adapter_num_layers) if rc.use_insadapter \
        else CLIPConfig(use_adapter=False)
    assert got.clip == want and VIT_B16 == CLIPConfig()
    for f in dataclasses.fields(got.clip):
        assert getattr(got.clip, f.name) == getattr(want, f.name), f.name
    assert (got.upt.clip_resolution, got.upt.visual_output_dim) == (
        UPTConfig.clip_resolution, UPTConfig.visual_output_dim) == (224, 512)
    assert tower_name(got.clip) == "ViT-B/16"


# a ViT-L-shaped tower cut to the CPU: patch 14 and heads of 64 (two), an
# embedding wider than the tower and not 512, a frame other than 224
SMALL_L = dict(vision_width=128, vision_layers=2, vision_patch_size=14,
               image_resolution=42, embed_dim=96, adapter_layers=(0, 1))


def _grads(loss, leaves):
    return torch.autograd.grad(loss, leaves, allow_unused=True)


def _leaves(tree, out=None):
    out = [] if out is None else out
    for v in (tree.values() if isinstance(tree, dict) else tree):
        if isinstance(v, torch.Tensor):
            out.append(v)
        else:
            _leaves(v, out)
    return out


def test_small_l_tower_forward_and_gradients_match_the_reference():
    """``encode_image`` of the port and of the reference on the same
    seeded weights, images and prior tokens: the global and local features
    and every leaf's gradient. Both run the plain attention (the CPU's
    fused path keeps f32 products where the reference rounds them to bf16,
    as the card does), so only the order of f32 sums differs: 1e-5 of
    each tensor's largest value."""
    from hoibench.reference.models.clip import config as rconfig
    from hoibench.reference.models.clip import model as rclip
    cfg = dataclasses.replace(VIT_L14_336, fused_attention=False, **SMALL_L)
    rcfg = rconfig.CLIPConfig(**dataclasses.asdict(cfg))
    assert (cfg.vision_heads, cfg.grid_size ** 2 + 1) == (2, 10)
    params = tclip.init_clip_params(torch.Generator().manual_seed(3), cfg)
    # the adapters' up-projections start at zero: give them weight, so
    # that their gradients reach the blocks below
    with torch.no_grad():
        for blk in params["visual"]["blocks"]:
            blk["adapter"]["up_w"].normal_(0, 0.1)
            blk["adapter"]["scale"].fill_(0.5)
    gen = torch.Generator().manual_seed(4)
    images = torch.randn((2, 3, 42, 42), generator=gen)
    prior = torch.randn((2, 5, 64), generator=gen)
    mask = torch.tensor([[False] * 5, [False] * 3 + [True] * 2])
    out_g = torch.randn((2, 96), generator=gen)
    out_l = torch.randn((2, 3, 3, 96), generator=gen)
    results = []
    for encode, c in ((tclip.encode_image, cfg),
                      (rclip.encode_image, rcfg)):
        p = {k: v for k, v in params.items()}
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in _leaves(params["visual"])]
        it = iter(leaves)

        def rebuild(tree):
            if isinstance(tree, dict):
                return {k: rebuild(v) for k, v in tree.items()}
            if isinstance(tree, list):
                return [rebuild(v) for v in tree]
            return next(it)
        p["visual"] = rebuild(params["visual"])
        g, loc = encode(p, images, c, prior=prior, prior_mask=mask)
        assert g.shape == (2, 96) and loc.shape == (2, 3, 3, 96)
        loss = (g * out_g).sum() + (loc * out_l).sum()
        results.append((g, loc, _grads(loss, leaves)))
    (g1, l1, d1), (g2, l2, d2) = results
    for a, b in [(g1, g2), (l1, l2)] + list(zip(d1, d2)):
        assert (a is None) == (b is None)
        if a is not None:
            scale = float(b.detach().abs().max())
            assert scale > 0
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * scale)


@pytest.fixture
def small_traffic(monkeypatch):
    """The traffic generator's buckets and scales cut to tiny images."""
    from hoibench import traffic as T
    monkeypatch.setattr(T, "BUCKETS", ((64, 96), (96, 64), (96, 96)))
    monkeypatch.setattr(T, "TRAIN_SCALES", (48, 56, 64))
    monkeypatch.setattr(T, "EVAL_MIN_SIDE", 64)
    monkeypatch.setattr(T, "MAX_SIDE", 96)
    monkeypatch.setattr(T, "CROP_RESIZE", (48, 64))
    monkeypatch.setattr(T, "CROP_RANGE", (40, 48))


def _shrink_l(cfg):
    """The cell's model cut to the CPU: the ViT-L-shaped tower above at
    the configuration's 768-wide embedding (the caches' width), the plain
    attention in CLIP (see the test above); a two-layer DETR of width 64
    with 12 queries in f32 (bf16 convolutions crawl on the CPU), 4
    instances a group, no DINO."""
    from hoigen_tpu_torch.models.proposals import ProposalConfig
    small = dict(SMALL_L, embed_dim=cfg.clip.embed_dim)
    return dataclasses.replace(
        cfg, clip=dataclasses.replace(cfg.clip, fused_attention=False,
                                      **small),
        detr=dataclasses.replace(cfg.detr, hidden_dim=64, nheads=2,
                                 enc_layers=2, dec_layers=2,
                                 dim_feedforward=128, num_queries=12),
        upt=dataclasses.replace(cfg.upt, clip_resolution=42, use_dino=False,
                                proposals=ProposalConfig(max_instances=4)),
        dtype="float32")


def test_small_l_training_step_matches_the_reference(small_traffic):
    """One training step of the port's HOI model built from the cell's
    configuration file (``--clip-model ViT-L/14@336px``, the widths held
    to the port by ``check_widths``) and cut by :func:`_shrink_l`, against
    the reference's step from the same weights, caches, batch and dropout
    draws: the loss to 1e-6 and every trainable leaf to 1e-5 relative
    (f32 sums in another order; the hoibench tests' tolerances)."""
    from hoibench import cells as C, model as M, spec, traffic as T
    from hoigen_tpu_torch.engine.hoi_model import make_optimizer, \
        make_train_step
    from hoigen_tpu_torch.engine.partition import trainable_leaves
    config = spec.load_json(spec.HERE / "configs"
                            / "hoigen-vitl14-336-hicodet-rfuc.json")
    traffic = spec.load_json(spec.HERE / "traffic" / "train-ready.json")
    run = C.Run(seed=2 ** 31 + 7, seconds=0, trace=False,
                config=dict(config, orientations=[[0.7, 96, 64],
                                                  [0.3, 64, 96]]),
                traffic=dict(traffic, batch=2, pool=1), device="cpu",
                shrink=_shrink_l)
    rc, cfg, params, buffers = M.build_program(
        run.seed, run.config, run.traffic, "cpu", _shrink_l)
    assert params["upt"]["priors_downproj"][0]["w"].shape[1] == 773
    caches = M.Caches(**T.make_caches(run.seed, run.config,
                                      cfg.upt.num_classes, cfg.upt.num_shot))
    assert caches.cache_h.shape[1] == 768
    pool, _ = T.make_batches(run.seed, run.config, run.traffic,
                             cfg.upt.num_classes, caches=caches,
                             clip_resolution=cfg.upt.clip_resolution)
    batch = pool[0]
    assert float(batch["clip_sizes"][0, 0]) == 42.0
    opt = make_optimizer(rc.lr_vit, rc.lr_head, rc.weight_decay,
                         rc.lr_drop * C.steps_per_epoch(run.config,
                                                        run.traffic),
                         rc.clip_max_norm)(params)
    seed = M.dropout_seed(run.seed)
    gen = torch.Generator().manual_seed(M.step_generator_seed(seed, 0))
    p0 = {p: t.detach().clone() for p, t in trainable_leaves(params)}
    loss = float(make_train_step(cfg, opt, "cpu")(params, buffers, batch,
                                                  gen)["loss"])
    detr = [C.program_detector(params, cfg, batch, "cpu")]
    ref = C.reference_train(run, cfg, [batch], detr, seed, rc)
    assert loss == pytest.approx(ref["losses"][0], rel=1e-6)
    moved = 0
    for p, t in trainable_leaves(params):
        np.testing.assert_allclose(t.detach().numpy(), ref["p3"][p].numpy(),
                                   rtol=1e-5, atol=1e-7)
        moved += not torch.equal(t.detach(), p0[p])
    assert moved > 0


def _shapes_only(cfg):
    """A state dict of ``cfg``'s shapes whose arrays take no memory: the
    keys and shapes ``infer_config`` reads."""
    def z(*shape):
        return np.broadcast_to(np.float32(0), shape)
    w, tw = cfg.vision_width, cfg.transformer_width
    sd = {"visual.conv1.weight": z(w, 3, cfg.vision_patch_size,
                                   cfg.vision_patch_size),
          "visual.positional_embedding": z(cfg.grid_size ** 2 + 1, w),
          "visual.proj": z(w, cfg.embed_dim),
          "text_projection": z(tw, cfg.embed_dim),
          "ln_final.weight": z(tw),
          "positional_embedding": z(cfg.context_length, tw),
          "token_embedding.weight": z(cfg.vocab_size, tw)}
    for i in range(cfg.vision_layers):
        sd[f"visual.transformer.resblocks.{i}.attn.in_proj_weight"] = \
            z(3 * w, w)
    for i in range(cfg.transformer_layers):
        sd[f"transformer.resblocks.{i}.attn.in_proj_weight"] = z(3 * tw, tw)
    return sd


def test_a_vit_b16_checkpoint_is_refused_for_the_l_preset(tmp_path,
                                                          monkeypatch):
    """The CLI reads ``--clip-model-path`` as ``--clip-model`` asks, for
    the towers and for a reference checkpoint's resume alike: a ViT-B/16
    checkpoint for ViT-L/14@336px raises naming the flag, the
    checkpoint's tower and every size that differs."""
    from hoigen_tpu_torch.models.clip.convert import check_shapes, \
        infer_config
    path = tmp_path / "ViT-B-16.pt"
    path.write_bytes(b"")
    monkeypatch.setattr(mf, "load_torch_file",
                        lambda p: _shapes_only(VIT_B16))
    rc = RunConfig(clip_model=VITL, clip_model_path=str(path),
                   pretrained_detr="", dino=False)
    model_cfg = mf.make_model_config(rc, "cpu")
    with pytest.raises(ValueError) as e:
        mf.load_pretrained(rc, model_cfg, torch.Generator().manual_seed(0))
    msg = str(e.value)
    with pytest.raises(ValueError) as resumed:
        mf._import_reference(rc, model_cfg, {}, {}, None, "cpu")
    assert str(resumed.value) == msg
    assert msg.startswith(f"--clip-model {VITL}: {path}: the checkpoint "
                          "holds ViT-B/16, not ViT-L/14@336px")
    for size in ("embed_dim 512 (wanted 768)", "vision_layers 12 (wanted 24)",
                 "vision_width 768 (wanted 1024)",
                 "vision_patch_size 16 (wanted 14)",
                 "transformer_width 512 (wanted 768)"):
        assert size in msg
    # its own shapes pass, at another resolution too (the positions are
    # resized to it)
    check_shapes(infer_config(_shapes_only(VIT_L14_336)), VIT_L14_336)
    check_shapes(infer_config(_shapes_only(VIT_B16)),
                 dataclasses.replace(VIT_B16, image_resolution=336))


def test_trace_summary_names_the_tower(tmp_path):
    """A traced run's summary names the tower ``--clip-model`` gives, its
    blocks and its tokens a step (the batch times the tower's sequence);
    a reset clears it."""
    import json
    for name, layers, seq in ((VITL, 24, 577), ("ViT-B/16", 12, 197)):
        out = tmp_path / name.replace("/", "_")
        rc = RunConfig(clip_model=name, batch_size=32, trace_dir=str(out))
        with mf.traced(rc, torch.device("cpu")):
            assert profiling.snapshot()["tower"]["name"] == name
        got = json.loads((out / "program_trace_summary.json").read_text())
        assert got["tower"] == {"name": name, "layers": layers,
                                "tokens_per_step": 32 * seq}
    profiling.reset()
    assert profiling.snapshot()["tower"] is None


class _Built(Exception):
    pass


@pytest.mark.parametrize("cli", ["main_finetune", "inference"])
def test_the_clis_feed_the_tower_its_frame(cli, tmp_path, monkeypatch):
    """Each CLI that builds the model from ``--clip-model`` builds its data
    at that tower's frame: the training and test factories of
    ``main_finetune`` and the inference CLI's, 336 for ViT-L/14@336px
    (a 224 stream would reach the 577-token tower, or RoI-align would
    scale the boxes by 24/336 on a 224 frame)."""
    from hoigen_tpu_torch.cli import inference

    def factory(*args, **kw):
        raise _Built(kw["clip_resolution"])
    monkeypatch.setattr(mf, "DataFactory", factory)
    argv = ["--clip-model", VITL, "--output-dir", str(tmp_path),
            "--dino", "false"]
    with pytest.raises(_Built) as built:
        if cli == "inference":
            inference.main(argv, device="cpu")
        else:
            mf.main(parse_config(argv), device="cpu")
    assert built.value.args == (336,)
