"""Smoke run of the PyTorch/CUDA port (hoigen_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--batch 4] [--warmup 2] [--steps 40]
                          [--profile-steps 5] [--train-steps 20]
                          [--train-profile-steps 3] [--seed 0]

Phases, each of which ends the run with a non-zero exit if it fails:

1. print the card's name and power limit (nvidia-smi);
2. build the hand-written kernels from ``hoigen_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together);
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes the HICO-DET eval step and training step give it (the attention
   backward through its autograd.Function, all four gradients), and time
   the kernel, the plain version and one library call computing the same
   function;
4. check the port's eval step on a small input against the same step on
   the CPU;
5. drive the full-width eval step (DETR-R50 and DINO-R50 in bf16, the
   adapter-CLIP ViT-B/16 in f32, the UPT head with 600 classes, gen_feat
   caches, an 800x1344 uint8 feed) from random weights made from
   ``--seed``, with the launch counters set to 0 just before it, and check
   the outputs and that every kernel of the path launched;
6. check a small training step's loss and gradients on the card against
   the CPU, then drive the full-width training step (f32 towers, 117
   classes, one generated pair per image, the fused cache and CLIP's fused
   attention on, dropout on) through ``Trainer`` with the counters set to
   0 just before it, and check the launches, the loss, that every frozen
   tensor is unchanged and that the trained ones moved.

The last two lines of standard output are one JSON object of kernel
numbers and one naming the device. Exits non-zero when no CUDA device is
present or the repository is not beside the script.
"""
import argparse
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOPS = 989e12
EXP_PER_SM_PER_CLOCK = 16        # special-function units
# two bf16 ulps of the output's scale: the kernel and its plain version
# round to bf16 at the same points, and another f32 summation order can
# move a rounded intermediate by one ulp
KERNEL_TOL = 2.0 ** -6


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def nvidia_smi(query, units=True):
    fmt = "csv,noheader" + ("" if units else ",nounits")
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          f"--format={fmt}"], capture_output=True, text=True,
                         timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi --query-gpu={query}: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def tree_clone(tree):
    """A copy of a nested dict/list of tensors."""
    if isinstance(tree, dict):
        return {k: tree_clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_clone(v) for v in tree)
    return tree.detach().clone()


def snapshot_frozen(params):
    """Copies of every leaf that does not require grad, by path."""
    from hoigen_tpu_torch.engine.partition import named_leaves
    return {p: t.detach().clone() for p, t in named_leaves(params)
            if not t.requires_grad}


def cuda_ms(fn, iters):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, after
    two warm-up calls, from CUDA events."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, op_times):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the slowest operation class over its peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(op_times)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


# ----------------------------------------------------------------- kernels
def check_kernels(model, batch, cfg, train_model, train_cfg, clock_hz):
    """Phase 3: each kernel against its plain version at the main path's
    shapes and weights. Returns the kernel records without ``launches``."""
    import torch
    import torch.nn.functional as F

    from hoigen_tpu_torch.models.detr.model import downsample_mask
    from hoigen_tpu_torch.models.detr.resnet import _bottleneck_nhwc
    from hoigen_tpu_torch.ops.attention import attention_reference, \
        fused_attention
    from hoigen_tpu_torch.ops.fused_resnet import \
        bottleneck_chain_reference, fused_bottleneck_chain
    from hoigen_tpu_torch.ops.pallas_cache import cache_logits_reference, \
        fused_cache_logits
    from hoigen_tpu_torch.ops.pixels import pad_mask_from_sizes

    params, buffers = model
    dev = batch["images"].device
    gen = torch.Generator().manual_seed(1)
    bf16 = torch.bfloat16
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    b, _, hi, wi = batch["images"].shape
    records = []

    def check(name, got, want):
        """Max abs error of got against want (tensors, or tuples of
        tensors each held to its own scale); fails beyond the tolerance."""
        if not isinstance(got, (tuple, list)):
            got, want = (got,), (want,)
        worst = 0.0
        for i, (g, w) in enumerate(zip(got, want)):
            err = (g.float() - w.float()).abs().max().item()
            scale = w.float().abs().max().item()
            tol = KERNEL_TOL * max(scale, 1e-30)
            ok = math.isfinite(err) and err <= tol
            part = f"[{i}]" if len(got) > 1 else ""
            log(f"kernel {name}{part}: max_abs_err {err:.3e} (output scale "
                f"{scale:.3e}, tolerance {tol:.3e}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"{name}{part} disagrees with its plain version")
            worst = max(worst, err)
        return worst

    def record(name, source, replaces, got, want, fn, plain, library,
               nbytes_, op_times, iters):
        err = check(name, got, want)
        ms = cuda_ms(fn, iters)
        plain_ms = cuda_ms(plain, max(1, iters // 4))
        library_ms = cuda_ms(library, iters)
        bound_ms, bound_by = bound(nbytes_, op_times)
        log(f"kernel {name}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
            f"library_ms {library_ms:.4f} bound {bound_ms * 1e3:.2f} us "
            f"({bound_by})")
        records.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "status": "ported, checked",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms})

    # K1: the DETR encoder's self-attention, (B, 8, 25*42, 32) bf16, with
    # the key bias of the batch's padding at the C5 stride
    hd = cfg.detr.hidden_dim // cfg.detr.nheads
    fh, fw = -(-hi // 32), -(-wi // 32)
    length = fh * fw
    q, k, v = (torch.randn((b, cfg.detr.nheads, length, hd), generator=gen)
               .to(dev, bf16) for _ in range(3))
    fmask = downsample_mask(pad_mask_from_sizes(batch["image_sizes"], hi, wi),
                            fh, fw).reshape(b, length)
    kbias = torch.where(fmask, -1e9, 0.0).float()
    mask_bf16 = kbias.to(bf16)[:, None, None, :]
    record("attention_fwd", "hoigen_tpu_torch/csrc/attention.cu",
           "hoigen_tpu/ops/attention.py:48",
           fused_attention(q, k, v, kbias),
           attention_reference(q, k, v, kbias),
           lambda: fused_attention(q, k, v, kbias),
           lambda: attention_reference(q, k, v, kbias),
           lambda: F.scaled_dot_product_attention(q, k, v,
                                                  attn_mask=mask_bf16),
           nbytes(q, k, v, kbias, q),
           (4 * q.numel() * length / BF16_TC_FLOPS,
            b * cfg.detr.nheads * length * length
            / (EXP_PER_SM_PER_CLOCK * n_sm * clock_hz)),
           iters=50)

    # K2: layer1 blocks 1-2 of the DETR backbone, (B, H/4, W/4, 256) bf16,
    # on the main path's conv weights. Their random frozen BN is the
    # identity (scale 1, bias 0), which would hide a swapped or dropped
    # epilogue operand and a missing SAME-padding zero (relu(0 * s + 0) is
    # 0 anyway), so the check draws per-channel scales around 1 and
    # nonzero biases from the seed
    def varied_bn(conv):
        n = conv["scale"].shape[0]
        return {"w": conv["w"],
                "scale": (1 + 0.1 * torch.randn(n, generator=gen)).to(dev),
                "bias": (0.1 * torch.randn(n, generator=gen)).to(dev)}

    blocks = [{n: varied_bn(c) for n, c in bp.items()}
              for bp in params["detr"]["backbone"]["layers"][0][1:]]
    x = torch.relu(torch.randn((b, hi // 4, wi // 4, 256), generator=gen)
                   ).to(dev, bf16)
    flops = 0
    for bp in blocks:
        m = bp["conv1"]["w"].shape[0]
        flops += 2 * x.numel() // 256 * (256 * m + 9 * m * m + m * 256)

    def unfused():
        y = x
        for bp in blocks:
            y = _bottleneck_nhwc(y, bp, 1)
        return y

    # the kernel reads its weights in bf16 and its scales and biases in f32
    weight_bytes = sum(c["w"].numel() * 2 + nbytes(c["scale"], c["bias"])
                       for bp in blocks for c in bp.values())
    record("bottleneck_chain_fwd", "hoigen_tpu_torch/csrc/fused_resnet.cu",
           "hoigen_tpu/ops/fused_resnet.py:47",
           fused_bottleneck_chain(x, blocks),
           bottleneck_chain_reference(x, blocks),
           lambda: fused_bottleneck_chain(x, blocks),
           lambda: bottleneck_chain_reference(x, blocks), unfused,
           nbytes(x, x) + weight_bytes, (flops / BF16_TC_FLOPS,), iters=20)

    # K3: the H cache branch, (B, 450, 512) f32 pair features against the
    # (1200, 512) cache keys and (1200, 600) label matrix
    upt = params["upt"]
    n_pairs = cfg.upt.proposals.n_pairs
    feats = torch.randn((b, n_pairs, 512), generator=gen)
    feats = (feats / feats.norm(dim=-1, keepdim=True)).to(dev)
    w, bb = upt["adapter_H_w"], upt["adapter_H_b"]
    lab, s = buffers["one_hots_H"], buffers["sample_lens_H"]
    w16, lab16 = w.to(bf16), lab.to(bf16)

    def two_matmuls():
        phi = torch.matmul(feats.to(bf16), w16.t()).float() + bb
        return torch.matmul(phi.to(bf16), lab16).float() / s

    rows = b * n_pairs
    record("cache_logits_fwd", "hoigen_tpu_torch/csrc/cache_logits.cu",
           "hoigen_tpu/ops/pallas_cache.py:44",
           fused_cache_logits(feats, w, bb, lab, s),
           cache_logits_reference(feats, w, bb, lab, s, bf16),
           lambda: fused_cache_logits(feats, w, bb, lab, s),
           lambda: cache_logits_reference(feats, w, bb, lab, s, bf16),
           two_matmuls,
           # the kernel reads W and L as bf16 (cast once by the wrapper)
           nbytes(feats, w16, bb, lab16, s) + rows * lab.shape[1] * 4,
           (2 * rows * w.shape[0] * (w.shape[1] + lab.shape[1])
            / BF16_TC_FLOPS,), iters=50)
    check_training_kernels(train_model, train_cfg, b, n_sm, clock_hz, check,
                           record)
    return records


def check_training_kernels(model, cfg, b, n_sm, clock_hz, check, record):
    """Phase 3, the training step's kernels: K1 and K4 at the CLIP tower's
    shapes, (B, 12, 197, 64) f32 (K4 through the autograd.Function, so
    that a gradient in the wrong slot fails), and K3 at 117 classes."""
    import torch
    import torch.nn.functional as F

    from hoigen_tpu_torch.ops.attention import attention_bwd, \
        attention_bwd_reference, attention_reference, fused_attention
    from hoigen_tpu_torch.ops.pallas_cache import cache_logits_reference, \
        fused_cache_logits, kernel_operands

    params, buffers = model
    gen = torch.Generator().manual_seed(2)
    bf16 = torch.bfloat16
    heads = cfg.clip.vision_heads
    length = cfg.clip.grid_size ** 2 + 1
    hd = cfg.clip.vision_width // heads
    shape = (b, heads, length, hd)
    q, k, v, dout = (torch.randn(shape, generator=gen).cuda()
                     for _ in range(4))
    n_scores = b * heads * length * length
    t_exp = n_scores / (EXP_PER_SM_PER_CLOCK * n_sm * clock_hz)
    t_mm = 2 * n_scores * hd / BF16_TC_FLOPS       # one of the products
    q16, k16, v16 = (t.to(bf16) for t in (q, k, v))
    out = fused_attention(q, k, v)
    record("attention_fwd_clip_f32", "hoigen_tpu_torch/csrc/attention.cu",
           "hoigen_tpu/ops/attention.py:48", out,
           attention_reference(q, k, v, compute_dtype=bf16),
           lambda: fused_attention(q, k, v),
           lambda: attention_reference(q, k, v, compute_dtype=bf16),
           lambda: F.scaled_dot_product_attention(q16, k16, v16),
           nbytes(q, k, v, out), (2 * t_mm, t_exp), iters=50)

    # K4 through the autograd.Function, with a nonzero key bias, against
    # the plain backward (bf16 products) from the plain forward
    kbias = (0.5 * torch.randn((b, length), generator=gen)).cuda()
    kbias[:, -7:] = -1e9
    ins = [t.clone().requires_grad_() for t in (q, k, v, kbias)]
    got = torch.autograd.grad(fused_attention(*ins), ins, dout)
    want = attention_bwd_reference(
        q, k, v, kbias, attention_reference(q, k, v, kbias,
                                            compute_dtype=bf16),
        dout, compute_dtype=bf16)
    check("attention_bwd_bias", got, want)
    # ... and off the main path's shape: bf16, head dim 32, Lq != Lk, both
    # ragged against the tiles
    qc, gc = (torch.randn((2, 3, 70, 32), generator=gen).cuda().to(bf16)
              for _ in range(2))
    kc, vc = (torch.randn((2, 3, 150, 32), generator=gen).cuda().to(bf16)
              for _ in range(2))
    bc = (0.5 * torch.randn((2, 150), generator=gen)).cuda()
    ins = [t.clone().requires_grad_() for t in (qc, kc, vc, bc)]
    got = torch.autograd.grad(fused_attention(*ins), ins, gc)
    check("attention_bwd_bf16_cross", got, attention_bwd_reference(
        qc, kc, vc, bc, attention_reference(qc, kc, vc, bc), gc))
    # ... and without a bias, as the CLIP tower calls it, where it is timed
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(fused_attention(*ins, None), ins, dout)
    want = attention_bwd_reference(
        q, k, v, None, attention_reference(q, k, v, compute_dtype=bf16),
        dout, compute_dtype=bf16)[:3]
    q16g, k16g, v16g = (t.clone().requires_grad_() for t in (q16, k16, v16))
    o16 = F.scaled_dot_product_attention(q16g, k16g, v16g)
    do16 = dout.to(bf16)
    record("attention_bwd", "hoigen_tpu_torch/csrc/attention.cu",
           "hoigen_tpu/ops/attention.py:95", got, want,
           lambda: attention_bwd(q, k, v, None, out, dout),
           lambda: attention_bwd_reference(q, k, v, None, out, dout,
                                           compute_dtype=bf16),
           lambda: torch.autograd.grad(o16, (q16g, k16g, v16g), do16,
                                       retain_graph=True),
           nbytes(q, k, v, out, dout, q, k, v), (5 * t_mm, t_exp), iters=50)

    # K3: the H cache branch of the training step, 117 classes
    upt = params["upt"]
    n_pairs = cfg.upt.proposals.n_pairs
    feats = torch.randn((b, n_pairs, 512), generator=gen)
    feats = (feats / feats.norm(dim=-1, keepdim=True)).cuda()
    w, bb = upt["adapter_H_w"].detach(), upt["adapter_H_b"].detach()
    lab, s = buffers["one_hots_H"], buffers["sample_lens_H"]
    w16, lab16, s_pad = kernel_operands(w, lab, s)

    def two_matmuls():
        phi = torch.matmul(feats.to(bf16), w16.t()).float() + bb
        return torch.matmul(phi.to(bf16), lab.to(bf16)).float() / s

    rows = b * n_pairs
    record("cache_logits_fwd_c117", "hoigen_tpu_torch/csrc/cache_logits.cu",
           "hoigen_tpu/ops/pallas_cache.py:44",
           fused_cache_logits(feats, w, bb, lab, s),
           cache_logits_reference(feats, w, bb, lab, s, bf16),
           lambda: fused_cache_logits(feats, w, bb, lab, s),
           lambda: cache_logits_reference(feats, w, bb, lab, s, bf16),
           two_matmuls,
           # the kernel reads W and the padded L as bf16
           nbytes(feats, w16, bb, lab16, s_pad) + rows * lab.shape[1] * 4,
           (2 * rows * w.shape[0] * (w.shape[1] + lab.shape[1])
            / BF16_TC_FLOPS,), iters=50)


# --------------------------------------------------------------- eval step
def spread_detection_heads(params, seed):
    """A random DETR's queries differ by under 1% after the decoder, so
    every query gets the same label and nearly the same box, NMS keeps one
    and no pair forms. Spread the box head's last layer, as the JAX
    package's tiny dry run does (here by 30, which the bf16 tower's
    rounding needs), and favour class 0 (human), so that the head scores
    human-human pairs and the path runs non-trivially."""
    import numpy as np
    import torch
    last = params["detr"]["bbox_embed"][-1]
    noise = np.random.default_rng(seed).normal(0, 1.0, last["b"].shape)
    last["w"] = last["w"] * 30.0
    last["b"] = last["b"] + torch.as_tensor(noise, dtype=last["b"].dtype,
                                            device=last["b"].device)
    params["detr"]["class_embed"]["b"][0] += 10.0


def small_reference_check(seed):
    """Phase 4: the eval step of a tiny float32 configuration on the card
    (plain math: the kernels' gates are closed at f32 and the fused cache
    is off) against the same step on the CPU, from the same weights."""
    import numpy as np
    import torch

    from hoigen_tpu_torch.engine import hoi_model as hm
    from hoigen_tpu_torch.models.cache import random_caches

    cfg = tiny_config()
    caches = random_caches(24, 2, num_objects=10, seed=seed)
    batch = hm.make_example_batch(cfg, batch_size=2, detr_hw=(64, 96),
                                  seed=seed, device_clip_stream=True)
    outs = {}
    for device in ("cpu", "cuda"):
        params, buffers = hm.init_hoi_model(
            torch.Generator().manual_seed(seed), cfg, caches, device=device)
        spread_detection_heads(params, seed)
        out = hm.make_eval_step(cfg, device=device)(params, buffers, batch)
        outs[device] = {k: v.cpu().numpy() for k, v in out.items()}
    cpu, gpu = outs["cpu"], outs["cuda"]
    if not (cpu["detection_scores"] > 0).any():
        fail("small reference: no pair was scored")
    for k in ("pair_valid", "objects", "detection_verbs"):
        if not np.array_equal(cpu[k], gpu[k]):
            fail(f"small reference: {k} differs between card and CPU")
    # f32 on both sides (TF32 off): 2e-4, the transformer tolerance of the
    # JAX package's full-dims suite
    for k in ("boxes", "detection_scores"):
        err = float(np.abs(cpu[k] - gpu[k]).max())
        if not err <= 2e-4 * max(1.0, float(np.abs(cpu[k]).max())):
            fail(f"small reference: {k} differs by {err:.3e}")
        log(f"small reference: {k} max_abs_err {err:.3e} ok")
    log(f"small reference: {int(cpu['pair_valid'].sum())} pairs, indices "
        "equal")


def main_path(model, batch, cfg, warmup, steps):
    """Phase 5: the full-width eval step, counters zeroed just before.
    Returns (launch counts, timed step times in s, outputs of the last
    step). Each step is timed alone, from a synchronised start to its
    synchronised end."""
    import torch

    from hoigen_tpu_torch.engine.hoi_model import make_eval_step
    from hoigen_tpu_torch.ops.attention import fused_attention
    from hoigen_tpu_torch.ops.fused_resnet import fused_bottleneck_chain
    from hoigen_tpu_torch.ops.pallas_cache import fused_cache_logits

    params, buffers = model
    step = make_eval_step(cfg, device=batch["images"].device)
    wrappers = (fused_attention, fused_bottleneck_chain, fused_cache_logits)
    for fn in wrappers:
        fn.launches = 0
    times = []
    for _ in range(warmup + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(params, buffers, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = [fn.launches for fn in wrappers]
    return counts, times[warmup:], out


def profile_steps(run_step, steps):
    """``steps`` more calls of ``run_step()`` under torch.profiler: the
    device time one step keeps busy (the sum of kernel and copy times on
    the one stream, over the steps) and the largest kernels. Returns (busy
    ms per step, [(name, ms per step), ...], runtime calls a step, largest
    host self times); busy is None when the profiler saw no device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()

    # the device-side events only: an operator's own entry repeats the
    # time of the kernels it launched, and a user annotation's device range
    # (the optimizer's "Optimizer.step#AdamW.step") spans kernels counted on
    # their own, as torch's own summary table leaves them out
    events = prof.key_averages()
    rows = sorted(((ev.key, ev.self_device_time_total / 1e3 / steps)
                   for ev in events
                   if ev.device_type == DeviceType.CUDA
                   and not getattr(ev, "is_user_annotation", False)
                   and ev.self_device_time_total > 0),
                  key=lambda r: -r[1])
    busy = sum(ms for _, ms in rows)
    # the host side: CUDA runtime calls a step makes (kernel launches, and
    # the copies and synchronisations that make the host wait for the card)
    # and the operators that take the most host time of their own
    runtime = {ev.key: ev.count / steps for ev in events
               if ev.key.startswith("cuda")}
    host = sorted(((ev.key, ev.self_cpu_time_total / 1e3 / steps,
                    ev.count / steps)
                   for ev in events if ev.key.startswith("aten::")),
                  key=lambda r: -r[1])
    return (busy or None), rows[:10], runtime, host[:8]


def report_profile(what, profiled, n_steps, mean_ms):
    busy_ms, top, runtime, host = profiled
    if busy_ms is None:
        log(f"{what}: device busy time not measured (the profiler saw no "
            "device time)")
    else:
        log(f"{what}: device busy {busy_ms:.3f} ms a step (mean of "
            f"{n_steps} profiled steps) against a {mean_ms:.3f} ms mean "
            f"step: idle share {1 - busy_ms / mean_ms:.3f}; largest device "
            "times a step:")
        for name, t in top:
            log(f"  {t:9.3f} ms  {name[:90]}")
    log(f"{what}: CUDA runtime calls a step: " + ", ".join(
        f"{k} {v:g}" for k, v in sorted(runtime.items(), key=lambda r: -r[1])))
    log(f"{what}: largest host self times a step (profiled):")
    for name, t, n in host:
        log(f"  {t:9.3f} ms  {n:6g} calls  {name}")
    return busy_ms


def step_stats(times_s, batch):
    """(mean, median, q1, q3 ms, images/s over the summed times)."""
    import numpy as np
    ms = np.asarray(times_s) * 1e3
    q1, median, q3 = (float(v) for v in np.percentile(ms, (25, 50, 75)))
    return (float(ms.mean()), median, q1, q3,
            batch * len(ms) / (ms.sum() / 1e3))


# ------------------------------------------------------------ training step
def tiny_config(generate_feature=False):
    """The small float32 configuration of phases 4 and 6, with the kernels'
    gates closed: f32 towers, no fused cache, no fused CLIP attention."""
    from hoigen_tpu_torch.engine import hoi_model as hm
    from hoigen_tpu_torch.models.clip.config import CLIPConfig
    from hoigen_tpu_torch.models.detr.config import DETRConfig
    from hoigen_tpu_torch.models.proposals import ProposalConfig
    from hoigen_tpu_torch.models.upt import UPTConfig

    return hm.HOIModelConfig(
        clip=CLIPConfig(image_resolution=32, vision_layers=2, vision_width=64,
                        vision_patch_size=8, adapter_layers=(0, 1),
                        fused_attention=False),
        detr=DETRConfig(hidden_dim=64, nheads=2, enc_layers=2, dec_layers=2,
                        dim_feedforward=128, num_queries=12, num_classes=2),
        upt=UPTConfig(num_classes=24, num_shot=2, clip_resolution=32,
                      proposals=ProposalConfig(max_instances=4),
                      use_dino=True, cache_model="gen_feat",
                      use_pallas_cache=False,
                      generate_feature=generate_feature),
        dtype="float32")


def small_train_check(seed):
    """Phase 6a: the loss and every gradient of one training step of the
    small f32 configuration on the card against the same on the CPU, from
    the same weights, dropout off. 2e-4 (relative to the loss, and to each
    gradient leaf's largest magnitude): f32 on both sides with TF32 off,
    the transformer tolerance of the JAX package's full-dims suite."""
    import numpy as np
    import torch

    from hoigen_tpu_torch.engine import hoi_model as hm
    from hoigen_tpu_torch.engine.partition import trainable_leaves
    from hoigen_tpu_torch.models.cache import random_caches

    cfg = tiny_config(generate_feature=True)
    caches = random_caches(24, 2, num_objects=10, seed=seed)
    batch = hm.make_example_batch(
        cfg, batch_size=2, detr_hw=(64, 96), seed=seed,
        device_clip_stream=True,
        object_class_multihot=caches.object_class_multihot)
    res = {}
    for device in ("cpu", "cuda"):
        params, buffers = hm.init_hoi_model(
            torch.Generator().manual_seed(seed), cfg, caches, device=device)
        spread_detection_heads(params, seed)
        tb = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        loss, aux = hm.train_loss(params, buffers, tb, cfg)
        loss.backward()
        grads = {p: (torch.zeros_like(t) if t.grad is None else t.grad)
                 .cpu().numpy() for p, t in trainable_leaves(params)}
        res[device] = (loss.item(), aux["n_p"].item(), grads)
    (l_cpu, np_cpu, g_cpu), (l_gpu, np_gpu, g_gpu) = res["cpu"], res["cuda"]
    if not (np_cpu > 0 and np_cpu == np_gpu and l_cpu > 1e-3):
        fail(f"small train step: n_p {np_cpu} / {np_gpu}, loss {l_cpu}")
    if not abs(l_gpu - l_cpu) <= 2e-4 * abs(l_cpu):
        fail(f"small train step: loss {l_gpu} on the card, {l_cpu} on the "
             "CPU")
    worst = 0.0
    for p, want in g_cpu.items():
        err = float(np.abs(g_gpu[p] - want).max())
        scale = max(float(np.abs(want).max()), 1e-30)
        if not err <= 2e-4 * scale:
            fail(f"small train step: gradient {p} differs by {err:.3e} "
                 f"(scale {scale:.3e})")
        worst = max(worst, err / scale)
    log(f"small train step: loss {l_gpu:.6f} (CPU {l_cpu:.6f}), n_p "
        f"{np_gpu:g}; {len(g_cpu)} gradient leaves within {worst:.2e} of "
        "their scale ok")


def train_path(model, batch, cfg, warmup, steps, seed):
    """Phase 6b: the full-width training step through Trainer, counters
    zeroed just before. Returns (launch counts K1, K4, K3, timed step times
    in s, the per-step losses, the Trainer)."""
    import torch

    from hoigen_tpu_torch.engine.hoi_model import make_optimizer, \
        make_train_step
    from hoigen_tpu_torch.engine.train import Trainer
    from hoigen_tpu_torch.ops.attention import attention_bwd, \
        fused_attention
    from hoigen_tpu_torch.ops.pallas_cache import fused_cache_logits

    params, buffers = model
    opt = make_optimizer(lr_drop_step=10)(params)
    trainer = Trainer(make_train_step(cfg, opt), opt, params, buffers,
                      checkpoint_every_epoch=False)
    wrappers = (fused_attention, attention_bwd, fused_cache_logits)
    for fn in wrappers:
        fn.launches = 0
    times, losses = [], []
    for _ in range(warmup + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(trainer.run_epoch([batch], seed=seed))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return ([fn.launches for fn in wrappers], times[warmup:], losses,
            trainer)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--profile-steps", type=int, default=5)
    ap.add_argument("--train-steps", type=int, default=20)
    ap.add_argument("--train-profile-steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.perf_counter()

    if not (ROOT / "hoigen_tpu_torch" / "csrc").is_dir():
        fail(f"hoigen_tpu_torch/csrc is not beside {__file__}")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")

    # phase 1: the card
    card = nvidia_smi("name,power.limit")
    clock_hz = float(nvidia_smi("clocks.max.sm", units=False)) * 1e6
    log(card)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}; max SM clock {clock_hz / 1e6:.0f} MHz")
    # every f32 product in this run is a full-f32 one
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build
    from hoigen_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {len(_build.SOURCES)} kernel sources in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, report in sorted(_build.build_logs.items()):
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # the full-width model and feed of the eval main path (bench.py's
    # setup), and of the training path (the flagship: f32 towers, 117
    # classes, generated pairs; the towers' frozen DETR and DINO weights
    # shared with the eval model, CLIP copied since it trains)
    from hoigen_tpu_torch.engine.hoi_model import HOIModelConfig, \
        init_hoi_model, make_example_batch
    from hoigen_tpu_torch.models.cache import random_caches
    from hoigen_tpu_torch.models.upt import UPTConfig
    cfg = HOIModelConfig(upt=UPTConfig(num_classes=600, num_shot=2,
                                       cache_model="gen_feat",
                                       use_pallas_cache=True),
                         dtype="bfloat16")
    caches = random_caches(600, 2, num_objects=80, seed=args.seed)
    model = init_hoi_model(torch.Generator().manual_seed(args.seed), cfg,
                           caches)
    spread_detection_heads(model[0], args.seed)
    batch = make_example_batch(cfg, batch_size=args.batch,
                               detr_hw=(800, 1344), seed=args.seed,
                               device_clip_stream=True)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}

    train_cfg = HOIModelConfig(upt=UPTConfig(num_classes=117, num_shot=2,
                                             cache_model="gen_feat",
                                             use_pallas_cache=True,
                                             generate_feature=True),
                               dtype="float32")
    train_caches = random_caches(117, 2, num_objects=80, seed=args.seed)
    clip_copy = tree_clone(model[0]["upt"]["clip"])
    train_model = init_hoi_model(
        torch.Generator().manual_seed(args.seed + 1), train_cfg,
        train_caches, clip_params=clip_copy,
        detr_params=model[0]["detr"], dino_params=model[0]["dino"])
    train_batch = make_example_batch(
        train_cfg, batch_size=args.batch, detr_hw=(800, 1344),
        seed=args.seed, device_clip_stream=True,
        object_class_multihot=train_caches.object_class_multihot)
    train_batch = {k: torch.as_tensor(v, device="cuda")
                   for k, v in train_batch.items()}

    # phase 3: kernels against their plain versions
    records = check_kernels(model, batch, cfg, train_model, train_cfg,
                            clock_hz)

    # phase 4: small input, card against CPU
    small_reference_check(args.seed)

    # phase 5: the main path
    counts, times, out = main_path(model, batch, cfg, args.warmup,
                                   args.steps)
    per_step = (6, 1, 3)          # encoder layers, layer1 tail, H/O/U
    n_run = args.warmup + args.steps
    expect = [n * n_run for n in per_step]
    names = ("attention_fwd", "bottleneck_chain_fwd", "cache_logits_fwd")
    log(f"main path: launches {dict(zip(names, counts))} over {n_run} "
        f"steps, expected {expect}")
    if counts != expect:
        fail(f"launch counts {counts} != {expect}")
    launches = dict(zip(names, counts))
    pairs = cfg.upt.proposals.n_pairs
    for k, v in out.items():
        if v.is_floating_point() and not torch.isfinite(v).all():
            fail(f"main path: {k} is not finite")
    scores = out["detection_scores"]
    if scores.shape[:2] != (args.batch, pairs) or \
            out["detection_verbs"].shape != scores.shape or \
            out["pair_valid"].shape != (args.batch, pairs):
        fail(f"main path: shapes {[tuple(v.shape) for v in out.values()]}")
    if not ((scores >= 0) & (scores <= 1)).all():
        fail("main path: detection scores outside [0, 1]")
    if not (scores > 0).any():
        fail("main path: no pair was scored")
    n_valid = int(out["pair_valid"].sum())
    log(f"main path: detection_scores {tuple(scores.shape)}, {n_valid} valid "
        f"pairs, {int((scores > 0).sum())} nonzero scores")
    # the rate is the whole window's: images over the summed step times
    mean_ms, median_ms, q1, q3, images_per_s = step_stats(times, args.batch)
    ms = np.asarray(times) * 1e3
    log(f"main path: eval step over {len(ms)} timed steps after "
        f"{args.warmup} warm-up: mean {mean_ms:.3f} ms, median "
        f"{median_ms:.3f} ms, quartiles {q1:.3f} / {q3:.3f} ms, min "
        f"{ms.min():.3f} ms, max {ms.max():.3f} ms; {images_per_s:.2f} "
        f"images/s at batch {args.batch} on {card}")
    from hoigen_tpu_torch.engine.hoi_model import make_eval_step
    step = make_eval_step(cfg)
    busy_ms = report_profile(
        "main path", profile_steps(lambda: step(*model, batch),
                                   args.profile_steps),
        args.profile_steps, mean_ms)
    eval_step = {"batch": args.batch, "steps": len(ms), "mean_ms": mean_ms,
                 "median_ms": median_ms, "q1_ms": q1, "q3_ms": q3,
                 "images_per_s": images_per_s, "device_busy_ms": busy_ms,
                 "card": card}

    # phase 6: the training step
    t6 = time.perf_counter()
    small_train_check(args.seed)
    frozen = snapshot_frozen(train_model[0])
    blk = train_model[0]["upt"]["clip"]["visual"]["blocks"][0]["adapter"]
    moved = {"adapter down_w": blk["down_w"],
             "adapter_H_w": train_model[0]["upt"]["adapter_H_w"]}
    before = {k: t.detach().clone() for k, t in moved.items()}
    tcounts, ttimes, losses, trainer = train_path(
        train_model, train_batch, train_cfg, args.warmup, args.train_steps,
        args.seed)
    n_run = args.warmup + args.train_steps
    per_step = (12, 12, 6)        # CLIP blocks fwd, bwd; H/O/U x 2
    expect = [n * n_run for n in per_step]
    tnames = ("attention_fwd_clip_f32", "attention_bwd",
              "cache_logits_fwd_c117")
    log(f"train path: launches {dict(zip(tnames, tcounts))} over {n_run} "
        f"steps, expected {expect}")
    if tcounts != expect:
        fail(f"train launch counts {tcounts} != {expect}")
    launches.update(zip(tnames, tcounts))
    if not all(math.isfinite(x) and x > 1e-3 for x in losses):
        fail(f"train path: losses {losses}")
    changed = [p for p, t in snapshot_frozen(train_model[0]).items()
               if not torch.equal(t, frozen[p])]
    if changed or len(frozen) < 100:
        fail(f"train path: frozen tensors changed: {changed[:5]} "
             f"({len(frozen)} frozen)")
    if ("upt", "clip", "visual", "conv1_w") not in frozen:
        fail("train path: CLIP conv1_w is not frozen")
    for k, t in moved.items():
        if torch.equal(t.detach(), before[k]):
            fail(f"train path: trainable {k} did not change")
    log(f"train path: losses {losses[0]:.5f} -> {losses[-1]:.5f} over "
        f"{n_run} steps; {len(frozen)} frozen tensors bit-identical; "
        f"{', '.join(moved)} changed")
    tmean, tmedian, tq1, tq3, timages = step_stats(ttimes, args.batch)
    tms = np.asarray(ttimes) * 1e3
    log(f"train path: training step over {len(tms)} timed steps after "
        f"{args.warmup} warm-up: mean {tmean:.3f} ms, median {tmedian:.3f} "
        f"ms, quartiles {tq1:.3f} / {tq3:.3f} ms, min {tms.min():.3f} ms, "
        f"max {tms.max():.3f} ms; {timages:.2f} images/s at batch "
        f"{args.batch} on {card}")
    tbusy = report_profile(
        "train path", profile_steps(
            lambda: trainer.run_epoch([train_batch], seed=args.seed),
            args.train_profile_steps),
        args.train_profile_steps, tmean)
    log(f"phase 6 took {time.perf_counter() - t6:.1f} s")
    log(f"total {time.perf_counter() - t_start:.1f} s")

    for rec in records:
        rec["launches"] = launches[rec["name"]]
    line = {"kernels": records, "to_port": [],
            "eval_step": eval_step,
            "train_step": {"batch": args.batch, "steps": len(tms),
                           "mean_ms": tmean, "median_ms": tmedian,
                           "q1_ms": tq1, "q3_ms": tq3,
                           "images_per_s": timages, "device_busy_ms": tbusy,
                           "first_loss": losses[0], "last_loss": losses[-1],
                           "card": card}}
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
