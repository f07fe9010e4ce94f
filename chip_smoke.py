"""Smoke run of the PyTorch/CUDA port (hoigen_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--batch 4] [--warmup 2] [--steps 40]
                          [--profile-steps 5] [--train-steps 20]
                          [--train-profile-steps 3] [--seed 0]

Phases, each of which ends the run with a non-zero exit if it fails:

1. print the card's name and power limit (nvidia-smi);
2. build the hand-written kernels from ``hoigen_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together);
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes the HICO-DET eval step and training step give it, and K1 and
   K2 at the padded buckets of phase 7's batches too (the attention
   backward through its autograd.Function, all four gradients; the CLIP
   attention on the (B, H, L, D) views of (B, L, H, D) buffers that its
   call site passes, bit for bit against contiguous copies, two backward
   calls bit for bit, the backward on the forward's saved statistics; one
   CLIP block's attention under the profiler, which must make no copy of
   a (B, L, E)-sized tensor; the cache scoring also launch by launch,
   twice for bit-identity, and at ragged and V-COCO shapes), and time the
   kernel, the plain version and one library call computing the same
   function, each by CUDA events around back-to-back calls and by the
   device time of the call's kernels alone (torch.profiler);
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
   tensor is unchanged and that the trained ones moved;
7. run the HICO-DET evaluation from a dataset on disk to its mAP as the
   CLI runs it (``DataFactory`` -> ``eval_batches``, tail padded -> the
   eval step of phase 5 -> ``evaluate_hico``) on 18 random JPEGs of both
   orientations written to a temporary directory, with the counters set
   to 0 just before it; check the launches per batch, the buckets, the
   AP vector and that no padded row reached the meter; time the whole
   evaluation, the loader alone, the steps and the host AP, and four more
   passes with every batch shape's first call behind them (their spread);
   then run the same tree through phase 4's small configuration on the
   card and on the CPU and compare the detections and the AP vectors.

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


def ptxas_report(log_text):
    """{kernel: (registers, spill store bytes, spill load bytes)} from the
    ``-Xptxas -v`` output of one build; kernels by their demangled-enough
    name (the function and its template arguments)."""
    import re
    out, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            # _ZN <len><id>... I <args> E: the last id before the
            # template arguments, and the integer ones among them
            mangled, pos, ident = m.group(1), 3, m.group(1)
            while pos < len(mangled) and mangled[pos].isdigit():
                n = re.match(r"\d+", mangled[pos:]).group(0)
                ident = mangled[pos + len(n):pos + len(n) + int(n)]
                pos += len(n) + int(n)
            args = re.findall(r"L[ib](\d+)E", mangled[pos:].split("EEv")[0])
            name = ident + (f"<{', '.join(args)}>" if args else "")
            out[name] = [None, None, None]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


# ----------------------------------------------------------------- kernels
def check_kernels(model, batch, cfg, train_model, train_cfg, clock_hz):
    """Phase 3: each kernel against its plain version at the main path's
    shapes and weights. Returns the kernel records without ``launches``."""
    import torch
    import torch.nn.functional as F

    from hoigen_tpu_torch.models.detr.model import downsample_mask
    from hoigen_tpu_torch.ops.attention import attention_reference, \
        fused_attention
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
        runs = ((fn, iters), (plain, max(1, iters // 4)), (library, iters))
        ms, plain_ms, library_ms = (cuda_ms(f, n) for f, n in runs)
        # the event window above also holds whatever host time the calls
        # take; the profiler's sum over the call's own kernels does not
        profiled = [profile_steps(f, n) for f, n in runs]
        dev_ms, plain_dev, library_dev = (p[0] for p in profiled)
        bound_ms, bound_by = bound(nbytes_, op_times)

        def fmt(v):
            return "not measured" if v is None else f"{v:.4f}"
        log(f"kernel {name}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
            f"library_ms {library_ms:.4f}; device only: kernel "
            f"{fmt(dev_ms)} plain {fmt(plain_dev)} library "
            f"{fmt(library_dev)}; bound {bound_ms * 1e3:.2f} us "
            f"({bound_by})")
        for what, p in zip(("kernel", "library"), profiled[::2]):
            log(f"  {what} call, device ms by kernel: " + "; ".join(
                f"{k[:60]} {v:.4f}" for k, v in p[1]))
        records.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "status": "ported, checked",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "kernel_device_ms": dev_ms,
            "plain_device_ms": plain_dev, "library_device_ms": library_dev})

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

    # K1 at the other padded planes of phase 7's evaluation from disk (a
    # portrait batch and batches of both orientations), each with the key
    # bias of that batch's padding
    feeds = {hw: sizes for hw, sizes in eval_feeds(b).items()
             if hw != (hi, wi)}
    for (ph, pw), sizes in feeds.items():
        fh, fw = -(-ph // 32), -(-pw // 32)
        q, k, v = (torch.randn((b, cfg.detr.nheads, fh * fw, hd),
                               generator=gen).to(dev, bf16)
                   for _ in range(3))
        sizes = torch.as_tensor(sizes, device=dev)
        kb = torch.where(downsample_mask(
            pad_mask_from_sizes(sizes, ph, pw), fh, fw)
            .reshape(b, fh * fw), -1e9, 0.0).float()
        check(f"attention_fwd at the ({ph}, {pw}) bucket, "
              f"{fh * fw} keys", fused_attention(q, k, v, kb),
              attention_reference(q, k, v, kb))

    # K2: the four ResNet-50 layer tails of the DETR backbone, and layer1's
    # at phase 7's other planes
    check_chain_kernels(params, b, hi, wi, gen, check, record, feeds)

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
    check_cache_kernel(feats, w, bb, lab, s, check)
    check_training_kernels(train_model, train_cfg, b, n_sm, clock_hz, check,
                           record)
    return records


def check_chain_kernels(params, b, hi, wi, gen, check, record, feeds):
    """Phase 3, K2: the stride-1 tail of each ResNet-50 layer of the DETR
    backbone on the main path's conv weights, at the plane the 800x1344
    bucket gives it (layer1, (B, 200, 336, 256), is the main path's fused
    launch; layers 2-4 run the layered route), each timed against its
    plain version and against the unfused cuDNN blocks; then the layer1
    tail at the planes of the padded buckets ``feeds`` (phase 7's), at a
    ragged plane, a width that takes the padding route (C 200,
    M 50, padded to the fused route's 256 and 64) and one that pads into
    the layered route (C 96, M 24, 3 blocks), and two calls bit for bit.
    The random frozen BN is the identity (scale 1, bias 0), which would
    hide a swapped or dropped epilogue operand and a missing SAME-padding
    zero (relu(0 * s + 0) is 0 anyway), so every check draws per-channel
    scales around 1 and nonzero biases from the seed."""
    import torch

    from hoigen_tpu_torch.models.detr.resnet import _bottleneck_nhwc
    from hoigen_tpu_torch.ops.fused_resnet import _chain_plan, \
        bottleneck_chain_reference, fused_bottleneck_chain

    dev, bf16 = "cuda", torch.bfloat16

    def varied_bn(conv):
        n = conv["scale"].shape[0]
        return {"w": conv["w"],
                "scale": (1 + 0.1 * torch.randn(n, generator=gen)).to(dev),
                "bias": (0.1 * torch.randn(n, generator=gen)).to(dev)}

    def seeded(c, m, k):
        """k blocks of widths c and m with weights drawn from the seed."""
        def conv(o, i, ks):
            w = torch.randn((o, i, ks, ks), generator=gen)
            return varied_bn({"w": (w * math.sqrt(2 / (i * ks * ks)))
                              .to(dev), "scale": torch.ones(o)})
        return [{"conv1": conv(m, c, 1), "conv2": conv(m, m, 3),
                 "conv3": conv(c, m, 1)} for _ in range(k)]

    def inputs(shape):
        return torch.relu(torch.randn(shape, generator=gen)).to(dev, bf16)

    layers = params["detr"]["backbone"]["layers"]
    for li, name in enumerate(("bottleneck_chain_fwd",
                               "bottleneck_chain_fwd_layer2",
                               "bottleneck_chain_fwd_layer3",
                               "bottleneck_chain_fwd_layer4")):
        blocks = [{n: varied_bn(c) for n, c in bp.items()}
                  for bp in layers[li][1:]]
        c = blocks[0]["conv3"]["w"].shape[0]
        m = blocks[0]["conv1"]["w"].shape[0]
        x = inputs((b, hi // 4 >> li, wi // 4 >> li, c))
        plan = _chain_plan(*x.shape[:3], c, m, len(blocks))
        log(f"kernel {name}: {len(blocks)} blocks, C {c}, M {m}, plane "
            f"{tuple(x.shape[:3])}: {plan.route} route, {plan}")
        if (plan.route == "fused") != (li == 0):
            fail(f"{name}: {plan.route} route")
        flops = 2 * x.numel() // c * len(blocks) * (2 * c * m + 9 * m * m)

        def unfused(x=x, blocks=blocks):
            for bp in blocks:
                x = _bottleneck_nhwc(x, bp, 1)
            return x

        # the kernels read the weights in bf16, scales and biases in f32
        weight_bytes = sum(cv["w"].numel() * 2 + nbytes(cv["scale"],
                                                        cv["bias"])
                           for bp in blocks for cv in bp.values())
        record(name, "hoigen_tpu_torch/csrc/fused_resnet.cu",
               "hoigen_tpu/ops/fused_resnet.py:47",
               fused_bottleneck_chain(x, blocks),
               bottleneck_chain_reference(x, blocks),
               lambda x=x, blocks=blocks: fused_bottleneck_chain(x, blocks),
               lambda x=x, blocks=blocks: bottleneck_chain_reference(x,
                                                                     blocks),
               unfused, nbytes(x, x) + weight_bytes,
               (flops / BF16_TC_FLOPS,), iters=20)
        if li == 0:
            same_bits("bottleneck_chain_fwd two calls",
                      (fused_bottleneck_chain(x, blocks),),
                      (fused_bottleneck_chain(x, blocks),))
            main_blocks = blocks

    cases = {f"bottleneck_chain_bucket_{h}x{w}":
             (inputs((b, h // 4, w // 4, 256)), main_blocks, "fused")
             for h, w in feeds}
    cases.update({"bottleneck_chain_ragged": (inputs((2, 37, 45, 256)),
                                              main_blocks, "fused"),
             "bottleneck_chain_padded_fused": (inputs((2, 37, 45, 200)),
                                               seeded(200, 50, 2), "fused"),
             "bottleneck_chain_padded_layered": (inputs((2, 29, 19, 96)),
                                                 seeded(96, 24, 3),
                                                 "layered")})
    for name, (x, blocks, route) in cases.items():
        c, m = x.shape[-1], blocks[0]["conv1"]["w"].shape[0]
        plan = _chain_plan(*x.shape[:3], c, m, len(blocks))
        if plan.route != route:
            fail(f"{name}: {plan.route} route")
        got = fused_bottleneck_chain(x, blocks)
        if got.shape != x.shape:
            fail(f"{name}: output {tuple(got.shape)}")
        check(f"{name} ({plan.route}, C {c} -> {plan.c}, M {m} -> "
              f"{plan.m})", got, bottleneck_chain_reference(x, blocks))


def check_cache_kernel(x, w, b, lab, s, check):
    """Phase 3, K3 beyond its timed check: each of its two launches alone
    against an f32 product (TF32 off) at the eval shapes, two calls bit
    for bit, and the whole against its plain version off the main path's
    shapes: ragged (N 70, D 128, R 150, C 37: N not a multiple of the 64
    rows of a block, R neither of 8 nor of the 64-wide K box, C not of 8),
    where the phi scratch's columns R..RP-1 must be exactly zero, and
    V-COCO's 236 classes (R 472)."""
    import torch

    from hoigen_tpu_torch.ops.pallas_cache import _kernel_forward, \
        cache_logits_reference, kernel_operands

    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        r, c = lab.shape
        out, phi = _kernel_forward(x, w, b, lab, s)
        w16, lt, _ = kernel_operands(w, lab, s)
        x16 = x.reshape(-1, x.shape[-1]).to(bf16).float()
        check("cache_logits_phi_launch", phi[:, :r],
              (torch.matmul(x16, w16.float().t()) + b).to(bf16))
        check("cache_logits_logits_launch", out.reshape(-1, c),
              torch.matmul(phi.float(), lt.float().t())[:, :c] / s)
        if not torch.equal(out, _kernel_forward(x, w, b, lab, s)[0]):
            fail("cache_logits: two calls on the same inputs differ")
        log("kernel cache_logits: two calls on the same inputs are "
            "bit-identical ok")

        shapes = {"cache_logits_ragged": (70, 128, 150, 37),
                  "cache_logits_c236": (1800, 512, 472, 236)}
        for name, (n, d, r, c) in shapes.items():
            xs = torch.randn((n, d), generator=gen)
            ws = torch.randn((r, d), generator=gen)
            xs, ws = (t / t.norm(dim=-1, keepdim=True) for t in (xs, ws))
            bs = 0.1 * torch.randn(r, generator=gen) - 1.0
            ls = (torch.rand((r, c), generator=gen) < 0.05).float()
            ss = ls.sum(0) + 1.0
            xs, ws, bs, ls, ss = (t.cuda() for t in (xs, ws, bs, ls, ss))
            # leave NaN in the block that the scratch is likely to reuse,
            # so that an unwritten column shows
            torch.full((n, -(-r // 8) * 8), math.nan, dtype=bf16,
                       device="cuda")
            got, phi = _kernel_forward(xs, ws, bs, ls, ss)
            check(name, got, cache_logits_reference(xs, ws, bs, ls, ss, bf16))
            if phi.shape[1] > r:
                if phi[:, r:].any():
                    fail(f"{name}: phi scratch columns {r}.."
                         f"{phi.shape[1] - 1} are not zero")
                log(f"kernel {name}: phi scratch columns {r}.."
                    f"{phi.shape[1] - 1} exactly zero ok")


def same_bits(name, got, want):
    """Fails unless each tensor of got equals its counterpart bit for
    bit."""
    import torch
    for i, (g, w) in enumerate(zip(got, want)):
        if not torch.equal(g, w):
            fail(f"{name}[{i}]: differs by "
                 f"{(g.float() - w.float()).abs().max().item():.3e}")
    log(f"kernel {name}: bit-identical ok")


def check_attention_layouts(q, k, v, dout, check):
    """Phase 3, K1 and K4 at the CLIP training shape beyond their timed
    checks: on strided (B, H, L, D) views of (B, L, H, D) buffers against
    the same kernels on contiguous copies, bit for bit (the kernels read
    both through strides); the outputs in the views' layout; two K4 calls
    bit for bit; K4 on the forward's saved statistics against the plain
    backward on the same statistics."""
    import torch

    from hoigen_tpu_torch.ops.attention import attention_bwd, \
        attention_bwd_reference, attention_forward

    bf16 = torch.bfloat16
    with torch.no_grad():
        views = (q, k, v, dout)
        contig = tuple(t.contiguous() for t in views)
        out_v, st_v = attention_forward(*views[:3], return_stats=True)
        out_c, st_c = attention_forward(*contig[:3], return_stats=True)
        if out_v.stride() != q.stride():
            fail(f"attention_fwd: output strides {out_v.stride()}, input "
                 f"view's {q.stride()}")
        same_bits("attention_fwd_clip_f32 strided vs contiguous",
                  (out_v, st_v), (out_c, st_c))
        got = attention_bwd(*views[:3], None, out_v, views[3], stats=st_v)
        want = attention_bwd(*contig[:3], None, out_c, contig[3], stats=st_c)
        for g, like in zip(got[:3], views):
            if g.stride() != like.stride():
                fail(f"attention_bwd: gradient strides {g.stride()}, input "
                     f"view's {like.stride()}")
        same_bits("attention_bwd strided vs contiguous", got[:3], want[:3])
        again = attention_bwd(*views[:3], None, out_v, views[3], stats=st_v)
        same_bits("attention_bwd two calls", got[:3], again[:3])
        check("attention_bwd_saved_stats", got[:3], attention_bwd_reference(
            *views[:3], None, out_v, views[3], compute_dtype=bf16,
            stats=st_v)[:3])


def check_clip_block_layout(params, cfg, b):
    """Phase 3: one CLIP block's self-attention (``_mhsa_fused``), forward
    and backward, at the training shape under torch.profiler: no
    aten::copy_, aten::clone or aten::contiguous may take a tensor of B * L
    * E elements (the kernels read and write the projections' layout)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hoigen_tpu_torch.models.clip.model import _mhsa_fused

    heads = cfg.clip.vision_heads
    length = cfg.clip.grid_size ** 2 + 1
    width = cfg.clip.vision_width
    attn = {n: t.detach().clone().requires_grad_() for n, t in
            params["upt"]["clip"]["visual"]["blocks"][0]["attn"].items()}
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((b, length, width), generator=gen).cuda() \
        .requires_grad_()
    g = torch.randn((b, length, width), generator=gen).cuda()

    def block():
        _mhsa_fused(attn, x, heads).backward(g)

    block()                                       # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        block()
        torch.cuda.synchronize()
    n = b * length * width
    copies = [ev for ev in prof.events()
              if ev.name in ("aten::copy_", "aten::clone", "aten::contiguous")]
    big = [(ev.name, ev.input_shapes) for ev in copies
           if any(s and math.prod(s) == n for s in ev.input_shapes)]
    if big:
        fail(f"CLIP block layout: {len(big)} copies of ({b}, {length}, "
             f"{width})-sized tensors around the attention: {big[:4]}")
    log(f"CLIP block layout: _mhsa_fused forward and backward at ({b}, "
        f"{length}, {width}) make no copy of a {n}-element tensor ok "
        f"({len(copies)} smaller copy ops)")


def check_wide_heads(b, length, gen, n_sm, clock_hz, check, record):
    """Phase 3, K1 and K4 at head dims above 64, which no shipped config
    reaches but the TPU kernels take: the CLIP call site's layout ((B, H,
    L, D) views of (B, L, H, D) buffers) with H = 8 and L = 197, at D =
    80, 128 and 256, in bf16 and f32. The forward's output and saved
    statistics against the plain version's, all four gradients through
    the autograd.Function with a key bias against the plain backward, and
    K4 on the saved statistics against the plain backward on the same
    statistics. D = 128 in f32 is timed beside SDPA on bf16 copies."""
    import torch
    import torch.nn.functional as F

    from hoigen_tpu_torch.ops.attention import attention_bwd, \
        attention_bwd_reference, attention_forward, attention_reference, \
        fused_attention

    bf16, heads = torch.bfloat16, 8
    for d in (80, 128, 256):
        for dtype in (torch.float32, bf16):
            name = f"d{d}_{'f32' if dtype == torch.float32 else 'bf16'}"
            q, k, v, dout = (torch.randn((b, length, heads, d), generator=gen)
                             .cuda().to(dtype).transpose(1, 2)
                             for _ in range(4))
            kbias = (0.5 * torch.randn((b, length), generator=gen)).cuda()
            kbias[:, -7:] = -1e9
            cd = bf16 if dtype == torch.float32 else None
            with torch.no_grad():
                out, stats = attention_forward(q, k, v, kbias,
                                               return_stats=True)
                want, want_stats = attention_reference(
                    q, k, v, kbias, compute_dtype=cd, return_stats=True)
                check(f"attention_fwd_{name}", (out, stats[0], stats[1]),
                      (want, want_stats[0], want_stats[1]))
                check(f"attention_bwd_saved_stats_{name}",
                      attention_bwd(q, k, v, kbias, out, dout, stats=stats),
                      attention_bwd_reference(q, k, v, kbias, out, dout,
                                              compute_dtype=cd, stats=stats))
            ins = [t.clone().requires_grad_() for t in (q, k, v, kbias)]
            got = torch.autograd.grad(fused_attention(*ins), ins, dout)
            check(f"attention_bwd_{name}", got, attention_bwd_reference(
                q, k, v, kbias, want, dout, compute_dtype=cd))

    # D = 128, f32, no bias, as the CLIP tower would call it, timed
    d = 128
    q, k, v, dout = (torch.randn((b, length, heads, d), generator=gen)
                     .cuda().transpose(1, 2) for _ in range(4))
    n_scores = b * heads * length * length
    t_exp = n_scores / (EXP_PER_SM_PER_CLOCK * n_sm * clock_hz)
    t_mm = 2 * n_scores * d / BF16_TC_FLOPS
    q16, k16, v16 = (t.contiguous().to(bf16) for t in (q, k, v))
    out, stats = attention_forward(q, k, v, return_stats=True)
    record("attention_fwd_d128", "hoigen_tpu_torch/csrc/attention.cu",
           "hoigen_tpu/ops/attention.py:48", out,
           attention_reference(q, k, v, compute_dtype=bf16),
           lambda: fused_attention(q, k, v),
           lambda: attention_reference(q, k, v, compute_dtype=bf16),
           lambda: F.scaled_dot_product_attention(q16, k16, v16),
           nbytes(q, k, v, out), (2 * t_mm, t_exp), iters=50)
    q16g, k16g, v16g = (t.clone().requires_grad_() for t in (q16, k16, v16))
    o16 = F.scaled_dot_product_attention(q16g, k16g, v16g)
    do16 = dout.contiguous().to(bf16)
    record("attention_bwd_d128", "hoigen_tpu_torch/csrc/attention.cu",
           "hoigen_tpu/ops/attention.py:95",
           attention_bwd(q, k, v, None, out, dout, stats=stats)[:3],
           attention_bwd_reference(q, k, v, None, out, dout,
                                   compute_dtype=bf16, stats=stats)[:3],
           lambda: attention_bwd(q, k, v, None, out, dout, stats=stats),
           lambda: attention_bwd_reference(q, k, v, None, out, dout,
                                           compute_dtype=bf16),
           lambda: torch.autograd.grad(o16, (q16g, k16g, v16g), do16,
                                       retain_graph=True),
           nbytes(q, k, v, out, dout, stats, q, k, v), (5 * t_mm, t_exp),
           iters=50)


def check_training_kernels(model, cfg, b, n_sm, clock_hz, check, record):
    """Phase 3, the training step's kernels: K1 and K4 at the CLIP tower's
    shapes, (B, 12, 197, 64) f32 (K4 through the autograd.Function, so
    that a gradient in the wrong slot fails), and K3 at 117 classes."""
    import torch
    import torch.nn.functional as F

    from hoigen_tpu_torch.ops.attention import attention_bwd, \
        attention_bwd_reference, attention_forward, attention_reference, \
        fused_attention
    from hoigen_tpu_torch.ops.pallas_cache import cache_logits_reference, \
        fused_cache_logits, kernel_operands

    params, buffers = model
    gen = torch.Generator().manual_seed(2)
    bf16 = torch.bfloat16
    heads = cfg.clip.vision_heads
    length = cfg.clip.grid_size ** 2 + 1
    hd = cfg.clip.vision_width // heads
    # the call site's layout: (B, H, L, D) views of (B, L, H, D) buffers,
    # as models/clip/model.py::_mhsa_fused passes its projections
    q, k, v, dout = (torch.randn((b, length, heads, hd), generator=gen)
                     .cuda().transpose(1, 2) for _ in range(4))
    n_scores = b * heads * length * length
    t_exp = n_scores / (EXP_PER_SM_PER_CLOCK * n_sm * clock_hz)
    t_mm = 2 * n_scores * hd / BF16_TC_FLOPS       # one of the products
    # the SDPA yardsticks on contiguous bf16 copies, as in earlier runs
    q16, k16, v16 = (t.contiguous().to(bf16) for t in (q, k, v))
    out, stats = attention_forward(q, k, v, return_stats=True)
    record("attention_fwd_clip_f32", "hoigen_tpu_torch/csrc/attention.cu",
           "hoigen_tpu/ops/attention.py:48", out,
           attention_reference(q, k, v, compute_dtype=bf16),
           lambda: fused_attention(q, k, v),
           lambda: attention_reference(q, k, v, compute_dtype=bf16),
           lambda: F.scaled_dot_product_attention(q16, k16, v16),
           nbytes(q, k, v, out), (2 * t_mm, t_exp), iters=50)
    check_attention_layouts(q, k, v, dout, check)

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
    with torch.no_grad():
        check("attention_fwd_bf16_cross", fused_attention(qc, kc, vc, bc),
              attention_reference(qc, kc, vc, bc))
    ins = [t.clone().requires_grad_() for t in (qc, kc, vc, bc)]
    got = torch.autograd.grad(fused_attention(*ins), ins, gc)
    check("attention_bwd_bf16_cross", got, attention_bwd_reference(
        qc, kc, vc, bc, attention_reference(qc, kc, vc, bc), gc))
    # ... and at head dim 48, which the wrapper runs at 64 with zero
    # columns, f32 with a bias
    q48, g48 = (torch.randn((2, 3, 70, 48), generator=gen).cuda()
                for _ in range(2))
    k48, v48 = (torch.randn((2, 3, 150, 48), generator=gen).cuda()
                for _ in range(2))
    b48 = (0.5 * torch.randn((2, 150), generator=gen)).cuda()
    with torch.no_grad():
        check("attention_fwd_d48", fused_attention(q48, k48, v48, b48),
              attention_reference(q48, k48, v48, b48, compute_dtype=bf16))
    ins = [t.clone().requires_grad_() for t in (q48, k48, v48, b48)]
    got = torch.autograd.grad(fused_attention(*ins), ins, g48)
    check("attention_bwd_d48", got, attention_bwd_reference(
        q48, k48, v48, b48, attention_reference(q48, k48, v48, b48,
                                                compute_dtype=bf16),
        g48, compute_dtype=bf16))
    # ... and without a bias, as the CLIP tower calls it, where it is timed
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(fused_attention(*ins, None), ins, dout)
    want = attention_bwd_reference(
        q, k, v, None, attention_reference(q, k, v, compute_dtype=bf16),
        dout, compute_dtype=bf16)[:3]
    q16g, k16g, v16g = (t.clone().requires_grad_() for t in (q16, k16, v16))
    o16 = F.scaled_dot_product_attention(q16g, k16g, v16g)
    do16 = dout.contiguous().to(bf16)
    record("attention_bwd", "hoigen_tpu_torch/csrc/attention.cu",
           "hoigen_tpu/ops/attention.py:95", got, want,
           lambda: attention_bwd(q, k, v, None, out, dout, stats=stats),
           lambda: attention_bwd_reference(q, k, v, None, out, dout,
                                           compute_dtype=bf16),
           lambda: torch.autograd.grad(o16, (q16g, k16g, v16g), do16,
                                       retain_graph=True),
           # inputs q, k, v, out, dout and the forward's statistics;
           # outputs dq, dk, dv
           nbytes(q, k, v, out, dout, stats, q, k, v), (5 * t_mm, t_exp),
           iters=50)
    check_clip_block_layout(params, cfg, b)
    check_wide_heads(b, length, gen, n_sm, clock_hz, check, record)

    # K3: the H cache branch of the training step, 117 classes
    upt = params["upt"]
    n_pairs = cfg.upt.proposals.n_pairs
    feats = torch.randn((b, n_pairs, 512), generator=gen)
    feats = (feats / feats.norm(dim=-1, keepdim=True)).cuda()
    w, bb = upt["adapter_H_w"].detach(), upt["adapter_H_b"].detach()
    lab, s = buffers["one_hots_H"], buffers["sample_lens_H"]
    w16, lt16, s_pad = kernel_operands(w, lab, s)
    lab16 = lab.to(bf16)           # cast once, as at C=600

    def two_matmuls():
        phi = torch.matmul(feats.to(bf16), w16.t()).float() + bb
        return torch.matmul(phi.to(bf16), lab16).float() / s

    rows = b * n_pairs
    record("cache_logits_fwd_c117", "hoigen_tpu_torch/csrc/cache_logits.cu",
           "hoigen_tpu/ops/pallas_cache.py:44",
           fused_cache_logits(feats, w, bb, lab, s),
           cache_logits_reference(feats, w, bb, lab, s, bf16),
           lambda: fused_cache_logits(feats, w, bb, lab, s),
           lambda: cache_logits_reference(feats, w, bb, lab, s, bf16),
           two_matmuls,
           # the kernel reads W and the padded L^T as bf16
           nbytes(feats, w16, bb, lt16, s_pad) + rows * lab.shape[1] * 4,
           (2 * rows * w.shape[0] * (w.shape[1] + lab.shape[1])
            / BF16_TC_FLOPS,), iters=50)


# --------------------------------------------------------------- eval step
def spread_detection_heads(params, seed, scale=30.0):
    """A random DETR's queries differ by under 1% after the decoder, so
    every query gets the same label and nearly the same box, NMS keeps one
    and no pair forms. Spread the box head's last layer, as the JAX
    package's tiny dry run does (by default by 30, which the bf16 tower's
    rounding needs), and favour class 0 (human), so that the head scores
    human-human pairs and the path runs non-trivially."""
    import numpy as np
    import torch
    last = params["detr"]["bbox_embed"][-1]
    noise = np.random.default_rng(seed).normal(0, 1.0, last["b"].shape)
    last["w"] = last["w"] * scale
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


# --------------------------------------------------- evaluation from disk
# phase 7's tree: 12 landscape and 6 portrait JPEGs, so that at batch 4
# one batch holds only portrait images and two mix both orientations
EVAL_SIZES = ([(640, 427)] * 4 + [(427, 640)] * 4
              + [(640, 427), (640, 427), (427, 640), (640, 427)] * 2
              + [(640, 427)] * 2)
# phase 7's small configuration: the transform sizes and buckets of the
# port's CPU tests
SMALL_TRANSFORM = dict(eval_min_side=48, max_side=80)
# passes of phase 7's evaluation: the first holds each batch shape's first
# call; the rest give the spread of a pass's rate
EVAL_PASSES = 5
SMALL_BUCKETS = ((56, 80), (80, 56), (80, 80))


def eval_feeds(b):
    """{padded (H, W): the unpadded (h, w) of each row} of the first batch
    of each plane that phase 7's tree gives at batch b, tail padded, as
    the eval transform and ``collate_batch`` size them (no pixel read)."""
    from hoigen_tpu_torch.data.factory import pick_bucket
    from hoigen_tpu_torch.data.transforms import DualStreamTransform
    plan = DualStreamTransform(training=False).plan
    feeds = {}
    for i in range(0, len(EVAL_SIZES), b):
        sizes = [plan(w, h)["out_hw"] for w, h in EVAL_SIZES[i:i + b]]
        sizes += sizes[-1:] * (b - len(sizes))
        hw = tuple(max(d) for d in zip(*(pick_bucket(*s) for s in sizes)))
        feeds.setdefault(hw, sizes)
    return feeds


def hico_factories(root, run_cfg, clip_resolution, transform_kwargs=None):
    """The test and training factories the CLI builds for HICO-DET."""
    from hoigen_tpu_torch.data.factory import DataFactory
    kw = dict(max_gt_pairs=run_cfg.max_gt_pairs,
              host_clip_stream=run_cfg.host_clip_stream,
              clip_resolution=clip_resolution,
              transform_kwargs=transform_kwargs)
    return (DataFactory("hicodet", "test2015", root, training=False, **kw),
            DataFactory("hicodet", "train2015", root, training=True,
                        seed=run_cfg.seed, **kw))


def hico_result(runs, cfg, run_cfg, test, train):
    """``evaluate_hico`` over the (outputs, batch) stream ``runs``, with
    the arguments the CLI passes (the rare split from the training set)."""
    from hoigen_tpu_torch.engine.eval import evaluate_hico
    from hoigen_tpu_torch.labels import HICO
    return evaluate_hico(
        runs, test.dataset, run_cfg.num_classes, cfg.upt.proposals,
        HICO.object_n_verb_to_interaction,
        train_anno_interaction=train.dataset.anno_interaction)


def evaluate_from_disk(step, model, cfg, run_cfg, test, train, on_card):
    """One HICO-DET evaluation as the CLI runs it: ``eval_batches`` (tail
    padded) through ``step``, then ``evaluate_hico``. Returns (result,
    [(outputs, batch)], {the padded shapes, the detections appended to the
    meter and, ``on_card``, the timings in s}). The step is the plain eval
    step: on the card a CUDA event is recorded before and after it (no
    sync), read once the evaluation has ended."""
    import numpy as np
    import torch

    from hoigen_tpu_torch.cli.main_finetune import eval_batches
    from hoigen_tpu_torch.engine import eval as E

    info = {"shapes": [], "events": [], "meter": 0, "wait_s": 0.0}

    def timed_step(params, buffers, d):
        info["shapes"].append(tuple(d["images"].shape[2:]))
        if not on_card:
            return step(params, buffers, d)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        out = step(params, buffers, d)
        end.record()
        info["events"].append((start, end))
        return out

    runs = []

    def timed(gen):
        """The (outputs, batch) stream, with the time the consumer waits
        for it (the loader and the steps) added up; kept for the caller."""
        while True:
            t = time.perf_counter()
            item = next(gen, None)
            info["wait_s"] += time.perf_counter() - t
            if item is None:
                return
            runs.append(item)
            yield item

    class CountingMeter(E.DetectionAPMeter):
        def append(self, scores, classes, labels):
            info["meter"] += len(np.asarray(scores).reshape(-1))
            super().append(scores, classes, labels)

    meter, E.DetectionAPMeter = E.DetectionAPMeter, CountingMeter
    try:
        t0 = time.perf_counter()
        result = hico_result(
            timed(eval_batches(timed_step, *model, test, run_cfg)), cfg,
            run_cfg, test, train)
        info["total_s"] = time.perf_counter() - t0
    finally:
        E.DetectionAPMeter = meter
    if on_card:
        torch.cuda.synchronize()
        info["step_s"] = [s.elapsed_time(e) / 1e3
                          for s, e in info.pop("events")]
    return result, runs, info


def pass_record(info, n_img):
    """The timings of one evaluation from disk, in s and ms."""
    steps_s = float(sum(info["step_s"]))
    return {"total_s": info["total_s"],
            "images_per_s": n_img / info["total_s"],
            "steps_s": steps_s,
            "wait_beyond_steps_s": info["wait_s"] - steps_s,
            "evaluate_hico_s": info["total_s"] - info["wait_s"],
            "step_ms": [t * 1e3 for t in info["step_s"]]}


def eval_from_disk_phase(model, cfg, args, card):
    """Phase 7: the HICO-DET evaluation from disk on the main path's model
    (phase 5's, batch ``args.batch``), then the small configuration's card
    against CPU on the same tree. Returns the ``eval_run`` record."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from hoigen_tpu_torch.cli.main_finetune import batches_from_factory
    from hoigen_tpu_torch.data import factory as factory_module
    from hoigen_tpu_torch.data.factory import slice_batch
    from hoigen_tpu_torch.engine import hoi_model as hm
    from hoigen_tpu_torch.models.cache import random_caches
    from hoigen_tpu_torch.ops.attention import fused_attention
    from hoigen_tpu_torch.ops.fused_resnet import fused_bottleneck_chain
    from hoigen_tpu_torch.ops.pallas_cache import fused_cache_logits
    from hoigen_tpu_torch.tools.make_hicodet import \
        annotate_from_detections, write_hicodet
    from hoigen_tpu_torch.utils.config import RunConfig

    t7 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="hicodet_")
    try:
        write_hicodet(root, EVAL_SIZES, seed=args.seed)
        # the CLI's defaults: host_clip_stream False, 2 workers, 32 pairs
        run_cfg = RunConfig(num_classes=600, batch_size=args.batch,
                            seed=args.seed)
        test, train = hico_factories(root, run_cfg,
                                     cfg.upt.clip_resolution)
        n_img = len(test)
        n_batches = -(-n_img // args.batch)

        wrappers = (fused_attention, fused_bottleneck_chain,
                    fused_cache_logits)
        step = hm.make_eval_step(cfg)
        for fn in wrappers:
            fn.launches = 0
        result, runs, info = evaluate_from_disk(step, model, cfg, run_cfg,
                                                test, train, True)
        counts = [fn.launches for fn in wrappers]
        expect = [n * n_batches for n in (6, 1, 3)]
        log(f"eval from disk: launches {counts} over {n_batches} batches, "
            f"expected {expect}")
        if counts != expect:
            fail(f"eval from disk: launch counts {counts} != {expect}")
        buckets = sorted(set(info["shapes"]))
        log(f"eval from disk: padded feeds {info['shapes']}; buckets "
            f"{buckets}")
        if (800, 1344) not in buckets or not (
                {(1344, 1344), (1344, 800)} & set(buckets)):
            fail(f"eval from disk: buckets {buckets} miss (800, 1344) or a "
                 "portrait-bearing shape")
        ap = np.asarray(result["ap"])
        if ap.shape != (600,) or not np.isfinite(ap).all() or \
                not ((ap >= 0) & (ap <= 1)).all():
            fail(f"eval from disk: ap of shape {ap.shape}, range "
                 f"[{ap.min()}, {ap.max()}]")
        # what the meter saw against the nonzero scores of the yielded
        # outputs, which must hold the real rows only (a padded row that
        # leaks adds its copy's detections)
        real = [min(args.batch, n_img - i * args.batch)
                for i in range(n_batches)]
        rows = [[len(o["detection_scores"]), len(b.indices)]
                for o, b in runs]
        want = sum(int((o["detection_scores"] != 0).sum()) for o, _ in runs)
        if info["meter"] != want or rows != [[n, n] for n in real]:
            fail(f"eval from disk: {info['meter']} detections reached the "
                 f"meter, the yielded outputs hold {want}; rows (outputs, "
                 f"batch) {rows}, real {real}")
        log(f"eval from disk: {info['meter']} detections reached the meter "
            f"({want} nonzero scores in the real rows) ok")

        # more passes over the same tree, each batch shape's first call
        # behind them: the same AP, and the spread of a pass's rate
        passes = [pass_record(info, n_img)]
        for _ in range(EVAL_PASSES - 1):
            again, _, warm = evaluate_from_disk(step, model, cfg, run_cfg,
                                                test, train, True)
            if not np.array_equal(again["ap"], result["ap"]) or \
                    warm["meter"] != info["meter"]:
                fail("eval from disk: another pass gives another AP vector")
            passes.append(pass_record(warm, n_img))

        # the loader alone: one pass of batches_from_factory, no step
        t0 = time.perf_counter()
        for _ in batches_from_factory(test, args.batch, run_cfg,
                                      shuffle=False, pad_tail=True):
            pass
        loader_s = time.perf_counter() - t0
        first = passes[0]
        warm_rates = [p["images_per_s"] for p in passes[1:]]
        record = {
            "images": n_img, "batch": args.batch, "batches": n_batches,
            "buckets": [list(b) for b in buckets],
            "mAP": result["mAP"], "mAP_rare": result["mAP_rare"],
            "mAP_non_rare": result["mAP_non_rare"],
            "detections": info["meter"],
            "total_s": first["total_s"],
            "images_per_s": first["images_per_s"],
            "warm_images_per_s": {
                "median": float(np.median(warm_rates)),
                "min": min(warm_rates), "max": max(warm_rates)},
            "loader_alone_s": loader_s, "steps_s": first["steps_s"],
            "wait_beyond_steps_s": first["wait_beyond_steps_s"],
            "evaluate_hico_s": first["evaluate_hico_s"],
            "step_images_per_s": args.batch * n_batches / first["steps_s"],
            "step_ms": first["step_ms"],
            "passes": passes,
            "launches": dict(zip(("attention_fwd", "bottleneck_chain_fwd",
                                  "cache_logits_fwd"), counts)),
            "card": card}
        log(f"eval from disk: mAP {result['mAP']:.6f}, rare "
            f"{result['mAP_rare']:.6f}, non-rare "
            f"{result['mAP_non_rare']:.6f} (random weights)")
        log(f"eval from disk: loader alone {loader_s:.3f} s a pass; "
            "steps by CUDA events around each (no sync)")
        for i, p in enumerate(passes):
            log(f"eval from disk, pass {i + 1} of {len(passes)}"
                f"{' (first calls of each shape)' if i == 0 else ''}: "
                f"{n_img} images in {p['total_s']:.3f} s, "
                f"{p['images_per_s']:.2f} images/s from the first fetch to "
                f"the result; steps {p['steps_s']:.3f} s (ms "
                f"{', '.join(f'{t:.1f}' for t in p['step_ms'])}); waiting "
                f"beyond the steps {p['wait_beyond_steps_s']:.3f} s; "
                f"evaluate_hico's own time {p['evaluate_hico_s']:.3f} s")
        w = record["warm_images_per_s"]
        log(f"eval from disk: passes 2-{len(passes)} at {w['median']:.2f} "
            f"images/s (median; min {w['min']:.2f}, max {w['max']:.2f}), on "
            f"{card}")
        log(f"eval from disk: the step alone at "
            f"{record['step_images_per_s']:.2f} images/s over {n_batches} "
            f"padded batches of {args.batch} in the first pass (phase 5: "
            "the line 'main path: eval step')")

        # the small configuration, card against CPU, on the same tree
        small = tiny_config()
        caches = random_caches(24, 2, num_objects=10, seed=args.seed)
        small_cfg = RunConfig(num_classes=24, batch_size=args.batch,
                              seed=args.seed)
        saved = factory_module.DEFAULT_BUCKETS
        factory_module.DEFAULT_BUCKETS = SMALL_BUCKETS

        def small_factories():
            return hico_factories(root, small_cfg, small.upt.clip_resolution,
                                  SMALL_TRANSFORM)

        def small_run(device):
            params, buffers = hm.init_hoi_model(
                torch.Generator().manual_seed(args.seed), small, caches,
                device=device)
            # spread by 6, as the port's CPU tests do: at 30 the small
            # f32 DETR's boxes on these images are all zero-height, and no
            # detection could match a ground-truth pair
            spread_detection_heads(params, args.seed, scale=6.0)
            return evaluate_from_disk(
                hm.make_eval_step(small, device=device), (params, buffers),
                small, small_cfg, *small_factories(), device == "cuda")

        try:
            _, cruns, cinfo = small_run("cpu")
            # the CPU run's own detections become the ground truth, so
            # that the AP vectors compared are not zero; its outputs are
            # scored again against the rewritten tree's batches
            annotate_from_detections(root, cruns, small.upt.proposals)
            test_s, train_s = small_factories()
            batches = [slice_batch(b, b.n_real) for _, b in
                       batches_from_factory(test_s, args.batch, small_cfg,
                                            shuffle=False, pad_tail=True)]
            cres = hico_result(zip((o for o, _ in cruns), batches), small,
                               small_cfg, test_s, train_s)
            gres, gruns, ginfo = small_run("cuda")
        finally:
            factory_module.DEFAULT_BUCKETS = saved
        if cinfo["shapes"] != ginfo["shapes"] or \
                not {(80, 80), (80, 56)} & set(ginfo["shapes"]) or \
                not ginfo["meter"] or not np.max(cres["ap"]) > 0:
            fail(f"small eval from disk: padded feeds {ginfo['shapes']}, "
                 f"{ginfo['meter']} detections, max AP "
                 f"{np.max(cres['ap'])}")
        worst = 0.0
        for (co, _), (go, _) in zip(cruns, gruns):
            for k in ("pair_valid", "objects", "detection_verbs"):
                if not np.array_equal(co[k], go[k]):
                    fail(f"small eval from disk: {k} differs between card "
                         "and CPU")
            for k in ("boxes", "detection_scores"):
                err = float(np.abs(co[k] - go[k]).max())
                if not err <= 2e-4 * max(1.0, float(np.abs(co[k]).max())):
                    fail(f"small eval from disk: {k} differs by {err:.3e}")
                worst = max(worst, err)
        ap_err = float(np.abs(np.asarray(gres["ap"])
                              - np.asarray(cres["ap"])).max())
        if not ap_err <= 1e-6:
            fail(f"small eval from disk: AP vectors differ by {ap_err:.3e}")
        log(f"small eval from disk: {len(gruns)} batches, "
            f"{ginfo['meter']} detections, indices equal, boxes and scores "
            f"within {worst:.3e}; AP vectors within {ap_err:.3e} (max AP "
            f"{float(np.max(gres['ap'])):.4f}) ok")
        record["small_detections"] = ginfo["meter"]
        record["small_ap_max_abs_diff"] = ap_err
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"phase 7 took {time.perf_counter() - t7:.1f} s")
    return record


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
    ptxas = {name: ptxas_report(report)
             for name, report in sorted(_build.build_logs.items())}
    for name, kernels in ptxas.items():
        for kernel, (regs, spill_st, spill_ld) in kernels.items():
            log(f"  {name}: {kernel}: {regs} registers, {spill_st} bytes "
                f"spill stores, {spill_ld} bytes spill loads")

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

    # phase 7: the HICO-DET evaluation from disk
    eval_run = eval_from_disk_phase(model, cfg, args, card)
    log(f"total {time.perf_counter() - t_start:.1f} s")

    for rec in records:
        # records off the main path (K2's layer2-4 tails) launched 0 times
        rec["launches"] = launches.get(rec["name"], 0)
        if rec["source"].endswith("fused_resnet.cu"):
            # {kernel: (registers, spill store bytes, spill load bytes)}
            rec["ptxas"] = ptxas.get("fused_resnet", {})
    line = {"kernels": records, "to_port": [],
            "eval_step": eval_step,
            "train_step": {"batch": args.batch, "steps": len(tms),
                           "mean_ms": tmean, "median_ms": tmedian,
                           "q1_ms": tq1, "q3_ms": tq3,
                           "images_per_s": timages, "device_busy_ms": tbusy,
                           "first_loss": losses[0], "last_loss": losses[-1],
                           "card": card},
            "eval_run": eval_run}
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
