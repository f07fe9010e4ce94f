"""Smoke run of the PyTorch/CUDA port (hoigen_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--batch 4] [--warmup 2] [--steps 40]
                          [--profile-steps 5] [--train-steps 20]
                          [--train-profile-steps 3] [--seed 0]

Phases, each of which ends the run with a non-zero exit if it fails:

1. print the card's name and power limit (nvidia-smi);
2. build the hand-written kernels from ``hoigen_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together);
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes the HICO-DET eval step and training step give it, K1 and K2
   at the padded buckets of phase 7's batches too, and K1 in f32 at the
   generator pipeline's crop encodes, batches 256, 64 and 32, K1, K2 and
   K3 at batch 1 (phase 12's one-image step), at phase 11's per-rank
   batch 2 K1 and K2 at phase 7's buckets, the CLIP tower's K1 and K4 and
   K3 at 117 classes, K1 and K4 at the ViT-L/14@336px tower's (32, 16,
   577, 64) and K3 over its 768-wide rows, K3 on half the cache rows
   (phase 11's model axis of 2; 600 and 117 classes), and the frozen-BN
   epilogue at the ResNet-50's sites of a batch of 32 on (1344, 1344)
   planes (bf16 and f32) and of one image, bit for bit (the attention
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
   the outputs and that every kernel of the path launched; the step is
   captured as one CUDA graph per batch shape and replayed
   (``engine/cuda_graph.py``, the counterpart of ``jax.jit``), and the
   counters include the replays;
5b. on phase 5's model and feed, the graphed step against the eager step:
   the outputs (indices exact, scores and boxes within two bf16 ulps),
   both timed in one window with their busy time, idle share and runtime
   calls (the graphed step under 20 kernel launch calls and one graph
   launch a step), the input copy alone, the captures' seconds and pool
   bytes, the epilogue kernel's launches a replay (one an epilogue
   site), the per-call weight check's host time; then a K3 and a K2
   weight written in place and a params tree with replaced tensors
   between replays, each replay against a fresh eager step; then the
   staging of host batches of 32 at (1344, 1344) and (800, 1344): the
   static inputs equal to the source, every load piped (the graph's
   record), the mean ``graph.stage`` host time over 20 loads with the
   staging pool's threads and the CPUs visible;
6. check a small training step's loss and gradients on the card against
   the CPU, then drive the full-width training step (f32 towers, 117
   classes, one generated pair per image, the fused cache and CLIP's fused
   attention on, dropout on) through ``Trainer`` with the counters set to
   0 just before it, and check the launches, the loss, that every frozen
   tensor is unchanged and that the trained ones moved; the step is
   captured as one CUDA graph (``engine/cuda_graph.py::GraphedTrainStep``,
   the counterpart of ``jax.jit(train_step, donate_argnums=(0, 1))``) and
   replayed, and the counters include the replays;
6b. on phase 6's configuration, the graphed training step against the
   eager step, each from its own copy of the trainable weights and a fresh
   optimizer, on the same batch and dropout seeds, within the spread of
   two eager copies (losses, n_p, every trainable leaf, the moments and
   the count, 2 + 20 steps across the learning-rate drop); both timed in
   one window with their busy time, idle share and runtime calls (the
   graphed step one graph launch and under 20 kernel launch calls a step);
   the capture's seconds, the pool's bytes, the epilogue kernel's launches
   a replay, the weight check's host time; an in-place write to a
   trainable leaf, a ``Trainer.restore`` and a params tree with a
   replaced tensor, one capture each; the frozen
   tensors bit-identical; an eval step after graphed training against one
   after eager training; the staging of phase 5b with the training
   batch's inputs;
6c. on phase 6's configuration with the language-aware term on, in an
   NCCL process group of one, the training step over a mesh graphed with
   its collectives inside (``Trainer`` graphs a mesh step whose groups
   are NCCL), on the (1, 1) mesh of ``make_mesh()`` and on a (1, 2)
   stand-in whose one rank holds every cache row (every model-axis
   collective through NCCL, the one-process function): the graphed step
   against the eager mesh step over 2 + 20 steps, bit for bit
   (``tools/mesh_graph_check.py::mesh_run``); the (1, 1) mesh bit for
   bit the one-process graphed step of phase 6b, and the stand-in bit
   for bit a witness, the one-process step whose optimizer sums its norm
   in the stand-in's order; both timed in one window (the graphed step
   one graph launch, under 20 kernel launch calls and no c10d or NCCL
   host call a step), the capture's seconds and the pool's bytes (a
   group of one launches no NCCL kernel);
6d. only where two cards or more are visible (the script needs one):
   ``tools/mesh_graph_check.py`` over them, the (N, 1) and (N/2, 2)
   meshes graphed against eager at a rank's batch of 8, with NCCL
   kernels in the replay and their device time;
7. run the HICO-DET evaluation from a dataset on disk to its mAP as the
   CLI runs it (``DataFactory`` -> ``eval_batches``, tail padded -> the
   graphed eval step of phase 5, one graph a bucket captured in the first
   pass -> ``evaluate_hico``) on 18 random JPEGs of both
   orientations written to a temporary directory, with the counters set
   to 0 just before it; check the launches per batch, the buckets, the
   AP vector and that no padded row reached the meter; time the whole
   evaluation, the loader alone, the steps and the host AP, and four more
   passes with every batch shape's first call behind them (their spread);
   then run the same tree through phase 4's small configuration on the
   card and on the CPU and compare the detections and the AP vectors;
8. run the CLI (``cli/main_finetune.py::main``) at full width as the
   repro scripts do (117 classes, RF-UC zero-shot, bf16 towers, the
   generated cache with the synthesis cut to 2 rounds), in a temporary
   working directory, from checkpoint files written from ``--seed``
   (ViT-B/16 CLIP with its text tower, DETR-R50, DINO-R50, a pair
   pickle) and phase 7's tree: an epoch of training, then --eval and
   --cache resumed from its checkpoint, each with the counters set to 0
   just before it; check the launches, the losses, the AP vector and the
   .mat files, and time each run, its stages and the synthesis against
   its f32 bound; then V-COCO --eval at phase 4's small configuration on
   the card and on the CPU, whose role APs must agree; the training epoch
   runs graphed, one graph a batch shape;
9. run the generator pipeline through its CLIs at full width (ViT-B/16
   CLIP with its text tower, from a file written from ``--seed``) on 384
   small random JPEGs a partition, in a temporary working directory:
   ``prepare_data`` crops of the three families, gt-features,
   pair-embeddings through the device crop encoder and global-caches (128
   images each), then ``main_vae`` and ``finetune_ship`` for each family
   at batch 256 (one epoch, two steps), each run with the counters set to
   0 just before it; check each run's K1 launches (and global-caches' DINO
   epilogue launches), the losses, the frozen CLIP bit-identical after
   training and the ``.npz`` files read back;
   time the encodes (crops/s) and the steps (steps/s); then a small
   configuration on the card and on the CPU (pair features, VAE losses
   and parameters);
10. run the DETR offline finetune (``cli/train_detr.py``) at the JAX
   CLI's defaults (batch 2, --max-gt 32, aux losses, remat) on phase 7's
   tree from a DETR-R50 file, one epoch, then ``cli/detections.py`` dump,
   gt and eval; check that the finetune launched no kernel (autograd
   records its backbone, whose epilogues stay the ATen chain) and the dump
   the epilogue kernel alone, once a site of each batch, the losses, the
   first batch's matches against the CPU's on the same outputs and the
   APs; time the steps and the dump;
11. parallelism on one card, at phase 8's flags on phase 7's tree with
   dropout off: the CLI's training epoch and --eval in a NCCL process
   group of one against the same runs without one (bit for bit; the
   training graphed over the group's mesh, one capture a batch shape),
   and ``--devices 2`` refused; then two processes on ``cuda:0`` over
   gloo, whose training steps stay eager:
   the training epoch, --eval and --cache against one process (the
   first update's clipped gradients, the merged AP vector within rtol
   1e-6, the .mat files' rows equal in count and sums, and rank 0's first
   eval step against one process's on the same rows), and one training
   step of phase 6's model with the language-aware term on, with the
   cache rows sharded on a (1, 2) mesh and on a (2, 1) mesh, against one
   process (losses within 1e-4 and clipped gradients, K3 launched on each
   rank's slice); each rank's launches;
12. the remainder: the inference CLI at full width from phase 8's files
   and checkpoint, default, --action K and --action K --failure (6 / 1
   / 3 launches each and one epilogue launch a site of DETR's and DINO's
   ResNet-50, its figures, its one-image step timed), and at a
   small configuration on the card and on the CPU (the listings line for
   line); ``prepare_data gt-features`` with an RN50 CLIP file and
   ``main_vae`` with an RN101 one on phase 9's tree (no launch, the
   frozen CLIP bit-identical) and a small RN tower card against CPU; the
   legacy interaction head at full width and ``generate_masks`` at
   800 x 1344 card against CPU; ``engine/profiling.py`` on phase 5's
   eval step (a profiler trace of five steps with the tracer's spans in
   it, the tracer's own trace and snapshot, the steps' images/s, the
   peak allocation), measured after phase 7 while that model is alive.

The last two lines of standard output are one JSON object of kernel
numbers and one naming the device. Exits non-zero when no CUDA device is
present or the repository is not beside the script.
"""
import argparse
import dataclasses
import json
import math
import os
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
def kernel_checks(records):
    """(check, record) of phase 3: ``check(name, got, want)`` holds a
    kernel's outputs to its plain version's; ``record(...)`` checks, times
    the kernel, its plain version and one library call computing the same
    function, and appends the kernel's record to ``records``."""

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

    return check, record


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
    check, record = kernel_checks(records)

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
    # the frozen-BN epilogue at the ResNet-50 sites of a batch of 32
    check_epilogue_kernel(records)

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
    check_vitl14_kernels(n_sm, clock_hz, check, record)
    check_new_shapes(model, batch, cfg, train_model, n_sm, clock_hz, check,
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


def resnet_epilogues(fused=()):
    """The frozen-BN epilogues one ResNet-50 forward runs through
    ``conv_epilogue`` where autograd records nothing: the stem and 3 a
    block, less the tail blocks of the layers in ``fused`` (K2's)."""
    from hoigen_tpu_torch.models.detr.resnet import LAYER_BLOCKS
    return 1 + 3 * (sum(LAYER_BLOCKS)
                    - sum(LAYER_BLOCKS[li] - 1 for li in fused))


def epilogue_sites(cfg):
    """The frozen-BN epilogues a step (one detector forward) of the
    ``HOIModelConfig`` ``cfg`` runs through ``conv_epilogue``: DETR's, less
    its fused tail, which runs in bf16 only (``detr_forward``), and, with
    ``use_dino``, DINO's."""
    fused = cfg.detr.fused_resnet_tail if (
        cfg.dtype == "bfloat16" and not cfg.detr.remat_backbone) else ()
    return resnet_epilogues(fused) + (
        resnet_epilogues() if cfg.upt.use_dino else 0)


def expect_epilogues(what, records, cfg):
    """Fail unless every graph of ``records`` launches the epilogue kernel
    once an epilogue site a replay."""
    want = epilogue_sites(cfg)
    got = {k: r["launches_per_replay"].get("conv_epilogue")
           for k, r in records.items()}
    if any(v != want for v in got.values()):
        fail(f"{what}: conv_epilogue launches a replay {got}, expected "
             f"{want}")
    log(f"{what}: conv_epilogue {want} launches a replay in each graph ok")


# the epilogue sites of a (1344, 1344) plane: (name, plane (H, W), C, mode)
EPILOGUE_SITES = (
    ("stem", (672, 672), 64, "site"),
    ("layer1_conv1", (336, 336), 64, "site"),
    ("layer1_end_down", (336, 336), 256, "down"),
    ("layer2_end", (168, 168), 512, "identity"),
    ("layer3_end", (84, 84), 1024, "identity"),
    ("layer4_end", (42, 42), 2048, "identity"))


def check_epilogue_kernel(records):
    """Phase 3, the frozen-BN epilogue kernel (``ops/conv_epilogue.py``)
    at the main path's sites of a batch of 32 on (1344, 1344) planes, in
    bf16 and f32, and at batch 1 in bf16: bit for bit against its plain
    version, the ATen chain it replaces. Timed, against its bound and the
    ATen chain, from CUDA events: the bf16 sites and the f32 stem at batch
    32, where the host is far ahead of the card, and the stem at batch 1,
    which the profiler also reads (its device time alone). Scales are
    drawn in [0.5, 1] and biases in [-0.5, 0.5], so that a rounding
    dropped shows and the timed loop, which writes over its input, stays
    bounded."""
    import torch

    from hoigen_tpu_torch.ops.conv_epilogue import conv_epilogue, \
        conv_epilogue_reference

    gen = torch.Generator().manual_seed(7)

    def draw(shape, dtype, lo=-3.0, hi=3.0):
        return (lo + (hi - lo) * torch.rand(shape, generator=gen)).to(
            "cuda", dtype)

    cases = [(f"conv_epilogue_{name}", 32, hw, c, mode, torch.bfloat16)
             for name, hw, c, mode in EPILOGUE_SITES]
    cases += [(f"conv_epilogue_{name}_b1", 1, hw, c, mode, torch.bfloat16)
              for name, hw, c, mode in EPILOGUE_SITES]
    cases += [(f"conv_epilogue_{name}_f32", 32, hw, c, mode, torch.float32)
              for name, hw, c, mode in EPILOGUE_SITES]
    timed = {name for name, nb, _, _, _, dt in cases
             if (nb == 32 and dt == torch.bfloat16)
             or name.startswith("conv_epilogue_stem")}
    for name, nb, (h, w), c, mode, dt in cases:
        y = draw((nb, h, w, c), dt)
        s, b = draw((c,), dt, 0.5, 1.0), draw((c,), dt, -0.5, 0.5)
        kw = {"site": {}, "identity": {"identity": torch.relu(draw(y.shape,
                                                                   dt))},
              "down": {"down": (draw(y.shape, dt), draw((c,), dt, 0.5, 1.0),
                                draw((c,), dt, -0.5, 0.5))}}[mode]
        got = conv_epilogue(y.clone(), s, b, **kw)
        torch.cuda.synchronize()
        same_bits(f"{name} against its plain version, the ATen chain",
                  (got,), (conv_epilogue_reference(y, s, b, **kw),))
        del got
        if name in timed:
            scratch = y.clone()
            # a site reads y and writes out; a block end also reads id
            n_bytes = (2 if mode == "site" else 3) * nbytes(y) \
                + 2 * nbytes(s) * (2 if mode == "down" else 1)
            bound_ms, bound_by = bound(n_bytes, (0.0,))
            ms = cuda_ms(lambda: conv_epilogue(scratch, s, b, **kw), 20)
            aten_ms = cuda_ms(
                lambda: conv_epilogue_reference(y, s, b, **kw), 20)
            dev_ms = profile_steps(
                lambda: conv_epilogue(scratch, s, b, **kw), 20)[0] \
                if nb == 1 else None
            records.append({
                "name": name, "route": "cuda",
                "source": "hoigen_tpu_torch/csrc/conv_epilogue.cu",
                "replaces": "none: XLA fuses the epilogue into the conv on "
                            "the TPU",
                "status": "not a TPU kernel: checked bit for bit",
                "max_abs_err": 0.0, "ms": ms, "plain_ms": aten_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": aten_ms, "kernel_device_ms": dev_ms,
                "plain_device_ms": None, "library_device_ms": None,
                "gb_per_s": n_bytes / ms / 1e6})
            dev = "" if dev_ms is None else \
                f"; the profiler's device time {dev_ms:.4f} ms"
            log(f"kernel {name}: {(nb, h, w, c)} {str(dt)[6:]} {mode}: "
                f"{n_bytes / 1e9:.3f} GB; events {ms:.4f} ms, "
                f"{n_bytes / ms / 1e6:.0f} GB/s, {bound_ms / ms:.1%} of the "
                f"bound {bound_ms:.4f} ms; the ATen chain {aten_ms:.4f} ms"
                + dev)
            del scratch
        del y, kw
        torch.cuda.empty_cache()


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


def clip_attention_inputs(cfg, b, gen):
    """q, k, v and dout of the CLIP tower's self-attention at batch ``b``,
    f32, in the call site's layout: (B, H, L, D) views of (B, L, H, D)
    buffers, as models/clip/model.py::_mhsa_fused passes its projections."""
    import torch
    heads = cfg.clip.vision_heads
    shape = (b, cfg.clip.grid_size ** 2 + 1, heads,
             cfg.clip.vision_width // heads)
    return tuple(torch.randn(shape, generator=gen).cuda().transpose(1, 2)
                 for _ in range(4))


def record_clip_attention(q, k, v, dout, suffix, n_sm, clock_hz, record):
    """K1's f32 route and K4 at the CLIP tower's call site (K4 through the
    autograd.Function without a bias, as the tower calls it), recorded as
    ``attention_fwd_clip_f32<suffix>`` and ``attention_bwd<suffix>``
    against their plain versions (bf16 products) and timed beside SDPA on
    contiguous bf16 copies. -> (one product's and the exponentials'
    bound times, s)."""
    import torch
    import torch.nn.functional as F

    from hoigen_tpu_torch.ops.attention import attention_bwd, \
        attention_bwd_reference, attention_forward, attention_reference, \
        fused_attention
    bf16 = torch.bfloat16
    b, heads, length, hd = q.shape
    n_scores = b * heads * length * length
    t_exp = n_scores / (EXP_PER_SM_PER_CLOCK * n_sm * clock_hz)
    t_mm = 2 * n_scores * hd / BF16_TC_FLOPS       # one of the products
    q16, k16, v16 = (t.contiguous().to(bf16) for t in (q, k, v))
    out, stats = attention_forward(q, k, v, return_stats=True)
    record(f"attention_fwd_clip_f32{suffix}",
           "hoigen_tpu_torch/csrc/attention.cu",
           "hoigen_tpu/ops/attention.py:48", out,
           attention_reference(q, k, v, compute_dtype=bf16),
           lambda: fused_attention(q, k, v),
           lambda: attention_reference(q, k, v, compute_dtype=bf16),
           lambda: F.scaled_dot_product_attention(q16, k16, v16),
           nbytes(q, k, v, out), (2 * t_mm, t_exp), iters=50)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(fused_attention(*ins, None), ins, dout)
    want = attention_bwd_reference(
        q, k, v, None, attention_reference(q, k, v, compute_dtype=bf16),
        dout, compute_dtype=bf16)[:3]
    q16g, k16g, v16g = (t.clone().requires_grad_() for t in (q16, k16, v16))
    o16 = F.scaled_dot_product_attention(q16g, k16g, v16g)
    do16 = dout.contiguous().to(bf16)
    record(f"attention_bwd{suffix}", "hoigen_tpu_torch/csrc/attention.cu",
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
    return t_mm, t_exp


def check_training_kernels(model, cfg, b, n_sm, clock_hz, check, record):
    """Phase 3, the training step's kernels: K1 and K4 at the CLIP tower's
    shapes, (B, 12, 197, 64) f32 (K4 through the autograd.Function, so
    that a gradient in the wrong slot fails), and K3 at 117 classes."""
    import torch
    import torch.nn.functional as F

    from hoigen_tpu_torch.ops.attention import attention_bwd_reference, \
        attention_reference, fused_attention
    from hoigen_tpu_torch.ops.pallas_cache import cache_logits_reference, \
        fused_cache_logits, kernel_operands

    params, buffers = model
    gen = torch.Generator().manual_seed(2)
    bf16 = torch.bfloat16
    q, k, v, dout = clip_attention_inputs(cfg, b, gen)
    _, heads, length, hd = q.shape
    t_mm, t_exp = record_clip_attention(q, k, v, dout, "", n_sm, clock_hz,
                                        record)
    # ... and at the generator pipeline's crop encodes (phase 9): main_vae's
    # batch of 256, prepare_data's 64 and the crop encoder's chunk of 32,
    # in the call site's layout
    cgen = torch.Generator(device="cuda").manual_seed(3)
    for nb in GEN_K1_BATCHES:
        qg, kg, vg = (torch.randn((nb, length, heads, hd), generator=cgen,
                                  device="cuda").transpose(1, 2)
                      for _ in range(3))
        qg16, kg16, vg16 = (t.contiguous().to(bf16) for t in (qg, kg, vg))
        scale = nb / b
        record(f"attention_fwd_clip_f32_b{nb}",
               "hoigen_tpu_torch/csrc/attention.cu",
               "hoigen_tpu/ops/attention.py:48", fused_attention(qg, kg, vg),
               attention_reference(qg, kg, vg, compute_dtype=bf16),
               lambda: fused_attention(qg, kg, vg),
               lambda: attention_reference(qg, kg, vg, compute_dtype=bf16),
               lambda: F.scaled_dot_product_attention(qg16, kg16, vg16),
               nbytes(qg, kg, vg, qg), (2 * t_mm * scale, t_exp * scale),
               iters=20 if nb > 64 else 50)
        del qg, kg, vg, qg16, kg16, vg16
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



def check_vitl14_kernels(n_sm, clock_hz, check, record):
    """Phase 3, the kernels at the ViT-L/14@336px tower's training shapes
    (``--clip-model ViT-L/14@336px`` at the batch of 32 of the cell
    ``hico-rfuc-vitl14-train-b32``): K1's f32 route and K4 at (32, 16,
    577, 64) in the call site's layout, timed beside SDPA and its
    backward, with phase 3's layout checks at that shape; K3 at the
    training step's 117 classes and two shots over 768-wide rows, for
    its proposals and its generated pairs, timed beside its two bf16
    matmuls."""
    import torch

    from hoigen_tpu_torch.engine.hoi_model import HOIModelConfig
    from hoigen_tpu_torch.models.cache import random_caches
    from hoigen_tpu_torch.models.clip.config import VIT_L14_336
    from hoigen_tpu_torch.ops.pallas_cache import cache_logits_reference, \
        fused_cache_logits, kernel_operands

    b, bf16 = 32, torch.bfloat16
    cfg = HOIModelConfig(clip=VIT_L14_336)
    gen = torch.Generator().manual_seed(5)
    q, k, v, dout = clip_attention_inputs(cfg, b, gen)
    log(f"kernels at the ViT-L/14@336px tower: attention {tuple(q.shape)} "
        "f32")
    record_clip_attention(q, k, v, dout, "_vitl14", n_sm, clock_hz, record)
    check_attention_layouts(q, k, v, dout, check)
    del q, k, v, dout

    # K3: the H cache branch over the 768-wide cache rows, at the step's
    # proposals and at its generated pairs (one an image)
    caches = random_caches(117, 2, dim=VIT_L14_336.embed_dim, seed=5)
    w = torch.as_tensor(caches.cache_h).cuda()
    bb = (0.1 * torch.randn(w.shape[0], generator=gen) - 1.0).cuda()
    lab = torch.as_tensor(caches.one_hots).float().cuda()
    s = torch.as_tensor(caches.sample_lens).float().cuda()
    w16, lt16, s_pad = kernel_operands(w, lab, s)
    lab16 = lab.to(bf16)
    for n_pairs, suffix in ((cfg.upt.proposals.n_pairs, ""), (1, "_gen")):
        feats = torch.randn((b, n_pairs, VIT_L14_336.embed_dim),
                            generator=gen)
        feats = (feats / feats.norm(dim=-1, keepdim=True)).cuda()

        def two_matmuls():
            phi = torch.matmul(feats.to(bf16), w16.t()).float() + bb
            return torch.matmul(phi.to(bf16), lab16).float() / s

        rows = b * n_pairs
        log(f"kernels at the ViT-L/14@336px tower: cache scoring "
            f"{tuple(feats.shape)} against {tuple(w.shape)} rows, "
            f"{lab.shape[1]} classes")
        record(f"cache_logits_fwd_c117_d768{suffix}",
               "hoigen_tpu_torch/csrc/cache_logits.cu",
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


def check_new_shapes(model, batch, cfg, train_model, n_sm, clock_hz, check,
                     record):
    """Phase 3, the shapes that phases 11 and 12 give the kernels: K1, K2
    and K3 at batch 1 (the inference CLI's one-image step, 600 and 117
    classes); at the per-rank batch 2 of a global batch of 4 over two data
    ranks, K1 and K2 at phase 7's buckets (rank 0's rows, padded to the
    global plane), the CLIP tower's K1 and K4 and K3 at 117 classes; and
    K3 on half the cache rows (a model axis of 2: L of (600, 600) and
    (117, 117)). Each against its plain version, the first bucket's, the
    CLIP tower's and each K3 timed."""
    import torch
    import torch.nn.functional as F

    from hoigen_tpu_torch.models.detr.model import downsample_mask
    from hoigen_tpu_torch.models.detr.resnet import _bottleneck_nhwc
    from hoigen_tpu_torch.ops.attention import attention_reference, \
        fused_attention
    from hoigen_tpu_torch.ops.fused_resnet import \
        bottleneck_chain_reference, fused_bottleneck_chain
    from hoigen_tpu_torch.ops.pallas_cache import cache_logits_reference, \
        fused_cache_logits, kernel_operands
    from hoigen_tpu_torch.ops.pixels import pad_mask_from_sizes

    params, buffers = model
    gen = torch.Generator().manual_seed(5)
    dev, bf16 = "cuda", torch.bfloat16
    heads = cfg.detr.nheads
    hd = cfg.detr.hidden_dim // heads

    def k1(name, sizes, ph, pw, timed):
        nb = len(sizes)
        fh, fw = -(-ph // 32), -(-pw // 32)
        q, k, v = (torch.randn((nb, heads, fh * fw, hd), generator=gen)
                   .to(dev, bf16) for _ in range(3))
        kb = torch.where(downsample_mask(pad_mask_from_sizes(
            torch.as_tensor(sizes, device=dev, dtype=torch.float32), ph, pw),
            fh, fw).reshape(nb, fh * fw), -1e9, 0.0).float()
        got, want = fused_attention(q, k, v, kb), \
            attention_reference(q, k, v, kb)
        if not timed:
            return check(f"{name} ({ph}, {pw}), {fh * fw} keys", got, want)
        length = fh * fw
        record(name, "hoigen_tpu_torch/csrc/attention.cu",
               "hoigen_tpu/ops/attention.py:48", got, want,
               lambda: fused_attention(q, k, v, kb),
               lambda: attention_reference(q, k, v, kb),
               lambda: F.scaled_dot_product_attention(
                   q, k, v, attn_mask=kb.to(bf16)[:, None, None, :]),
               nbytes(q, k, v, kb, q),
               (4 * q.numel() * length / BF16_TC_FLOPS,
                nb * heads * length * length
                / (EXP_PER_SM_PER_CLOCK * n_sm * clock_hz)), iters=50)

    def varied(conv):
        n = conv["scale"].shape[0]
        return {"w": conv["w"],
                "scale": (1 + 0.1 * torch.randn(n, generator=gen)).to(dev),
                "bias": (0.1 * torch.randn(n, generator=gen)).to(dev)}
    blocks = [{n: varied(c) for n, c in bp.items()}
              for bp in params["detr"]["backbone"]["layers"][0][1:]]

    def k2(name, nb, ph, pw, timed):
        x = torch.relu(torch.randn((nb, ph // 4, pw // 4, 256),
                                   generator=gen)).to(dev, bf16)
        got, want = fused_bottleneck_chain(x, blocks), \
            bottleneck_chain_reference(x, blocks)
        if not timed:
            return check(f"{name} {tuple(x.shape)}", got, want)

        def unfused():
            y = x
            for bp in blocks:
                y = _bottleneck_nhwc(y, bp, 1)
            return y
        flops = 2 * x.numel() // 256 * len(blocks) * (2 * 256 * 64
                                                        + 9 * 64 * 64)
        weight_bytes = sum(cv["w"].numel() * 2 + nbytes(cv["scale"],
                                                        cv["bias"])
                           for bp in blocks for cv in bp.values())
        record(name, "hoigen_tpu_torch/csrc/fused_resnet.cu",
               "hoigen_tpu/ops/fused_resnet.py:47", got, want,
               lambda: fused_bottleneck_chain(x, blocks),
               lambda: bottleneck_chain_reference(x, blocks), unfused,
               nbytes(x, x) + weight_bytes, (flops / BF16_TC_FLOPS,),
               iters=20)

    def k3(name, nb, upt, bufs, rows_frac):
        n_pairs = cfg.upt.proposals.n_pairs
        feats = torch.randn((nb, n_pairs, 512), generator=gen)
        feats = (feats / feats.norm(dim=-1, keepdim=True)).to(dev)
        r = upt["adapter_H_w"].shape[0] // rows_frac
        w = upt["adapter_H_w"].detach()[:r].contiguous()
        bb = upt["adapter_H_b"].detach()[:r].contiguous()
        lab = bufs["one_hots_H"][:r].contiguous()
        s = bufs["sample_lens_H"]
        w16, lt16, s_pad = kernel_operands(w, lab, s)
        lab16 = lab.to(bf16)

        def two_matmuls():
            phi = torch.matmul(feats.to(bf16), w16.t()).float() + bb
            return torch.matmul(phi.to(bf16), lab16).float() / s
        n_rows = nb * n_pairs
        record(name, "hoigen_tpu_torch/csrc/cache_logits.cu",
               "hoigen_tpu/ops/pallas_cache.py:44",
               fused_cache_logits(feats, w, bb, lab, s),
               cache_logits_reference(feats, w, bb, lab, s, bf16),
               lambda: fused_cache_logits(feats, w, bb, lab, s),
               lambda: cache_logits_reference(feats, w, bb, lab, s, bf16),
               two_matmuls,
               nbytes(feats, w16, bb, lt16, s_pad) + n_rows * lab.shape[1]
               * 4, (2 * n_rows * r * (512 + lab.shape[1])
                     / BF16_TC_FLOPS,), iters=50)

    # batch 1: the 800x1344 bucket of phase 5's feed, its first image
    hi, wi = batch["images"].shape[2:]
    sizes1 = batch["image_sizes"][:1].tolist()
    k1("attention_fwd_b1", sizes1, hi, wi, True)
    k2("bottleneck_chain_fwd_b1", 1, hi, wi, True)
    tparams, tbuffers = train_model
    k3("cache_logits_fwd_b1", 1, params["upt"], buffers, 1)
    k3("cache_logits_fwd_b1_c117", 1, tparams["upt"], tbuffers, 1)
    # per-rank batch 2 at phase 7's buckets (rank 0's rows of batch 4)
    for i, ((ph, pw), sizes) in enumerate(eval_feeds(4).items()):
        k1("attention_fwd_b2", sizes[:2], ph, pw, i == 0)
        k2("bottleneck_chain_fwd_b2", 2, ph, pw, i == 0)
    # ... and the training step's and the CLI's at a rank's batch 2: the
    # CLIP tower's K1 (f32 route) and K4, and K3 over all 234 rows of 117
    # classes
    record_clip_attention(*clip_attention_inputs(cfg, 2, gen), "_b2", n_sm,
                          clock_hz, record)
    k3("cache_logits_fwd_b2_c117", 2, tparams["upt"], tbuffers, 1)
    # half of the cache rows, at the eval step's batch
    b = batch["images"].shape[0]
    k3("cache_logits_fwd_half_rows", b, params["upt"], buffers, 2)
    k3("cache_logits_fwd_half_rows_c117", b, tparams["upt"], tbuffers, 2)

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
    """Phase 5: the full-width eval step as the CLI runs it, captured as
    one CUDA graph per batch shape (``engine/cuda_graph.py``; the first
    call warms up and captures, the rest replay), counters zeroed just
    before. Returns (launch counts, timed step times in s, outputs of the
    last step, the graphed step). Each step is timed alone, from a
    synchronised start to its synchronised end."""
    import torch

    from hoigen_tpu_torch.engine.cuda_graph import graphed
    from hoigen_tpu_torch.engine.hoi_model import make_eval_step
    from hoigen_tpu_torch.ops.attention import fused_attention
    from hoigen_tpu_torch.ops.fused_resnet import fused_bottleneck_chain
    from hoigen_tpu_torch.ops.pallas_cache import fused_cache_logits

    params, buffers = model
    step = graphed(make_eval_step(cfg, device=batch["images"].device))
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
    return counts, times[warmup:], out, step


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
               if ev.key.startswith(("cuda", "cuLaunch"))}
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


def same_outputs(what, got, want):
    """Fail unless the eval outputs ``got`` hold ``want``'s indices and
    masks exactly and its scores and boxes within two bf16 ulps of their
    scale. -> {key: max abs difference}."""
    import torch
    for k in ("pair_valid", "objects", "detection_verbs"):
        if not torch.equal(got[k], want[k]):
            fail(f"{what}: {k} differs")
    diffs = {}
    for k in ("detection_scores", "boxes"):
        diffs[k] = float((got[k].float() - want[k].float()).abs().max())
        scale = max(1.0, float(want[k].abs().max()))
        if not diffs[k] <= KERNEL_TOL * scale:
            fail(f"{what}: {k} differs by {diffs[k]:.3e} (scale {scale:g})")
    log(f"{what}: indices equal; scores and boxes within "
        f"{diffs['detection_scores']:.3e} and {diffs['boxes']:.3e}")
    return diffs


def staging_check(what, batch, seed, card):
    """Phases 5b and 6b: the graphs' staging of host batches
    (``engine/cuda_graph.py::_Graph.load``) at the cells' batch of 32 and
    both planes, (1344, 1344) and (800, 1344): uint8 images drawn from
    ``seed`` beside the phase's other inputs tiled to 32 rows, from numpy,
    two batches in turn. After 1 + 20 loads the static inputs equal the
    last batch on the card (``torch.equal``) and the graph's record shows
    every load piped, in the chunks of ``chunk_plan``; a graph of the
    small inputs alone pipes none. Logs the mean ``graph.stage`` host time over
    the 20 loads and the time until their copies landed, with the pool's
    threads, ``POOL_CAP`` and the CPUs visible. Needs the tracer on (the
    phase's own). -> record."""
    import numpy as np
    import torch

    from hoigen_tpu_torch.engine import cuda_graph as cg
    from hoigen_tpu_torch.engine import profiling

    def stage_span():
        s = profiling.snapshot()["spans"].get("graph.stage", {})
        return s.get("count", 0), s.get("total_ms", 0.0)

    rows = 32
    cpus = len(os.sched_getaffinity(0))
    record = {"pool_cap": cg.POOL_CAP, "cpus": cpus,
              "pool_threads": min(cg.POOL_CAP, cpus)}
    gen = np.random.default_rng([seed, 21])
    small = {k: np.resize(v.cpu().numpy(), (rows, *v.shape[1:]))
             if v.ndim and len(v) == len(batch["images"]) else v.cpu().numpy()
             for k, v in batch.items() if k != "images"}
    for hw in ((1344, 1344), (800, 1344)):
        feeds = [dict(small, images=gen.integers(0, 256, (rows, 3, *hw),
                                                 np.uint8))
                 for _ in range(2)]
        g = cg._Graph(feeds[0], torch.device("cuda"))
        g.load(feeds[1])
        count, total = stage_span()
        landed = []
        for i in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g.load(feeds[i % 2])
            g.copied.synchronize()
            landed.append(time.perf_counter() - t0)
        count2, total2 = stage_span()
        host_ms = (total2 - total) / max(count2 - count, 1)
        same = all(torch.equal(g.static_in[k], torch.as_tensor(v).cuda())
                   for k, v in feeds[1].items())
        rec = g.record()
        key = "x".join(map(str, hw))
        nbytes = feeds[0]["images"].nbytes
        record[key] = {"stage_ms": host_ms,
                       "landed_ms": 1e3 * float(np.mean(landed)),
                       "equal": same, "record": rec}
        log(f"phase {what}: staging a batch of {rows} at {hw} "
            f"({nbytes / 1e6:.1f} MB of images) from "
            f"numpy: graph.stage {host_ms:.3f} ms a load on the host, "
            f"{record[key]['landed_ms']:.3f} ms until the copies landed "
            f"(mean of {count2 - count}); pool of {record['pool_threads']} "
            f"threads (POOL_CAP {cg.POOL_CAP}, {cpus} CPUs visible); "
            f"loads {rec['loads']}, piped {rec['piped_loads']}, "
            f"{rec['chunks_per_piped_load']:g} chunks a piped load; static "
            f"inputs equal to the source: {same}; on {card}")
        if not same or rec["piped_loads"] != rec["loads"] or \
                rec["chunks_per_piped_load"] != len(
                    cg.chunk_plan(rows, nbytes)):
            fail(f"phase {what}: staging at {hw}: equal {same}, {rec}")
        del g
    g = cg._Graph(small, torch.device("cuda"))
    g.load(small)
    record["small_alone"] = g.record()
    if g.record()["piped_loads"]:
        fail(f"phase {what}: the small inputs alone were piped: "
             f"{g.record()}")
    return record


def graph_phase(model, batch, cfg, args, card, gstep):
    """Phase 5b: phase 5's graphed eval step ``gstep`` against the eager
    step on phase 5's model and feed: the outputs; both timed in one
    window (warm-up and timed steps as phase 5, then profiled steps: busy
    time, runtime calls); the input copy alone, from card tensors and from
    numpy through the pinned staging; the captures' seconds and pool
    bytes and the per-call weight check's host time; then, between
    replays, a cache weight that K3 reads through ``_weights.prepared``
    and a DETR layer1 weight that K2 prepares written in place, and a
    params tree with replaced tensors (``apply_vis_tor``), each replay
    against a fresh eager step. The weights are restored after. ->
    record."""
    import numpy as np
    import torch

    from hoigen_tpu_torch.engine import profiling
    from hoigen_tpu_torch.engine.cuda_graph import signature
    from hoigen_tpu_torch.engine.hoi_model import make_eval_step
    from hoigen_tpu_torch.models.upt import apply_vis_tor

    t5b = time.perf_counter()
    # the tracer's host spans time the weight check (graph.check)
    profiling.reset()
    profiling.enable()
    params, buffers = model
    eager = make_eval_step(cfg)
    g = gstep.graphs[signature(batch)]
    record = {"graphed_vs_eager": same_outputs(
        "phase 5b: graphed step against the eager step",
        gstep(params, buffers, batch), eager(params, buffers, batch)),
        "card": card}

    def timed_ms(fn, n):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return times

    for name, step in (("eager", eager), ("graphed", gstep)):
        def run(step=step):
            return step(params, buffers, batch)
        times = timed_ms(run, args.warmup + args.steps)[args.warmup:]
        mean, median, q1, q3, rate = step_stats(times, args.batch)
        log(f"phase 5b {name}: {len(times)} timed steps after "
            f"{args.warmup} warm-up: mean {mean:.3f} ms, median "
            f"{median:.3f} ms, quartiles {q1:.3f} / {q3:.3f} ms; "
            f"{rate:.2f} images/s at batch {args.batch} on {card}")
        profiled = profile_steps(run, args.profile_steps)
        busy = report_profile(f"phase 5b {name}", profiled,
                              args.profile_steps, mean)
        runtime = profiled[2]
        record[name] = {
            "mean_ms": mean, "median_ms": median, "q1_ms": q1, "q3_ms": q3,
            "images_per_s": rate, "device_busy_ms": busy,
            "idle_share": None if busy is None else 1 - busy / mean,
            "runtime_calls_per_step": runtime}
    launches = sum(v for k, v in record["graphed"][
        "runtime_calls_per_step"].items() if "LaunchKernel" in k)
    if not launches < 20 or \
            record["graphed"]["runtime_calls_per_step"].get(
                "cudaGraphLaunch") != 1:
        fail(f"phase 5b: the graphed step makes {launches:g} kernel "
             "launch calls a step, runtime calls "
             f"{record['graphed']['runtime_calls_per_step']}")

    # the input copy alone, and the graphed step from the host feed
    host = {k: v.cpu().numpy() for k, v in batch.items()}
    for name, feed in (("card tensors", batch), ("numpy", host)):
        ms = 1e3 * float(np.mean(timed_ms(lambda feed=feed: g.load(feed),
                                          20)))
        record[f"input_copy_ms_{name.split()[0]}"] = ms
        log(f"phase 5b: the input copy alone from {name}: {ms:.3f} ms "
            "(mean of 20)")
    times = timed_ms(lambda: gstep(params, buffers, host), 20)
    mean, median, _, _, rate = step_stats(times, args.batch)
    record["graphed_host_feed"] = {"mean_ms": mean, "median_ms": median,
                                   "images_per_s": rate}
    log(f"phase 5b graphed from the numpy feed (copy included): mean "
        f"{mean:.3f} ms, median {median:.3f} ms; {rate:.2f} images/s")

    # weights changed between replays: each replay against a fresh eager
    # step, after one call that captures again
    def after_change(what, p):
        captures = g.captures
        gstep(p, buffers, batch)
        got = gstep(p, buffers, batch)
        if g.captures != captures + 1:
            fail(f"phase 5b {what}: {g.captures - captures} captures, "
                 "expected 1")
        return same_outputs(f"phase 5b {what}: the replay against a fresh "
                            "eager step", got, eager(p, buffers, batch)), got

    before = gstep(params, buffers, batch)
    cache_w = params["upt"]["adapter_H_w"]
    layer1_w = params["detr"]["backbone"]["layers"][0][1]["conv1"]["w"]
    saved = [cache_w.detach().clone(), layer1_w.detach().clone()]
    with torch.no_grad():
        cache_w.mul_(1.25)
        layer1_w.mul_(0.8)
    record["in_place_write"], got = after_change(
        "in-place write to a K3 and a K2 weight", params)
    replaced = dict(params, upt=apply_vis_tor(params["upt"], cfg.upt, 2.0))
    record["replaced_tensors"], got2 = after_change(
        "params with replaced tensors", replaced)
    if torch.equal(got["detection_scores"], before["detection_scores"]) or \
            torch.equal(got2["detection_scores"], got["detection_scores"]):
        fail("phase 5b: a weight change left the scores unchanged")
    with torch.no_grad():
        cache_w.copy_(saved[0])
        layer1_w.copy_(saved[1])
    record["restored"], _ = after_change("weights restored", params)
    record["staging"] = staging_check("5b", batch, args.seed, card)
    check = profiling.snapshot()["spans"]["graph.check"]
    profiling.disable()
    profiling.reset()
    check_us = 1e3 * check["per_step_ms"]
    record["graphs"] = gstep.records()
    expect_epilogues("phase 5b", record["graphs"], cfg)
    record["check_us_per_call"] = check_us
    for key, rec in record["graphs"].items():
        log(f"phase 5b: graph {key}: {rec}")
    log(f"phase 5b: the weight check's host time {check_us:.1f} us a call "
        f"(mean of {check['steps']})")
    log(f"phase 5b took {time.perf_counter() - t5b:.1f} s")
    return record


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
    from hoigen_tpu_torch.engine.cuda_graph import graphed
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
        # one graph per bucket, captured in the first pass
        step = graphed(hm.make_eval_step(cfg))
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
            "warm_step_images_per_s": args.batch * n_batches * (
                len(passes) - 1) / sum(p["steps_s"] for p in passes[1:]),
            "passes": passes, "graphs": step.records(),
            "launches": dict(zip(("attention_fwd", "bottleneck_chain_fwd",
                                  "cache_logits_fwd"), counts)),
            "card": card}
        log(f"eval from disk: mAP {result['mAP']:.6f}, rare "
            f"{result['mAP_rare']:.6f}, non-rare "
            f"{result['mAP_non_rare']:.6f} (random weights)")
        log(f"eval from disk: loader alone {loader_s:.3f} s a pass; "
            "steps by CUDA events around each (no sync)")
        for i, p in enumerate(passes):
            note = " (first calls of each shape: warm-up and capture)" \
                if i == 0 else ""
            log(f"eval from disk, pass {i + 1} of {len(passes)}{note}: "
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
            f"padded batches of {args.batch} in the first pass, "
            f"{record['warm_step_images_per_s']:.2f} images/s in passes "
            f"2-{len(passes)} (phase 5: the line 'main path: eval step')")
        for key, rec in record["graphs"].items():
            log(f"eval from disk: graph {key}: {rec}")

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
                graphed(hm.make_eval_step(small, device=device)),
                (params, buffers),
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
    """Phase 6: the full-width training step through Trainer (graphed: the
    first step warms up and captures, the rest replay), counters zeroed
    just before. Returns (launch counts K1, K4, K3, timed step times in s,
    the per-step losses, the Trainer)."""
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


def train_graph_phase(model, batch, cfg, args, card):
    """Phase 6b: on phase 6's configuration, model and batch, the graphed
    training step (``engine/cuda_graph.py::GraphedTrainStep``, as a
    Trainer makes it) against the eager step, each on its own copy of the
    trainable weights with a fresh optimizer (learning-rate drop at update
    10), on the same batch and dropout seeds; a second eager copy gives the
    spread of two eager runs, and graphed against eager must be bit for
    bit where the two eager runs are, else within twice their difference:
    losses, n_p, every trainable leaf, the moments and the count. In order: 2 +
    ``args.train_steps`` steps across the drop; both steps timed in one
    window (busy time, idle share, runtime calls: the graphed step one
    ``cudaGraphLaunch`` and under 20 kernel launch calls); an in-place
    write to a trainable leaf, a ``Trainer.restore`` from a checkpoint and
    a params tree with a replaced tensor, each one new capture; the frozen
    tensors bit-identical; an eval step (graphed, captured before the
    training, and eager) on the graphed copy against the eager copy's.
    Failures are gathered and end the run at the phase's end. -> record."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from hoigen_tpu_torch.engine import profiling
    from hoigen_tpu_torch.engine.checkpoint import save_checkpoint
    from hoigen_tpu_torch.engine.cuda_graph import GraphedTrainStep, graphed
    from hoigen_tpu_torch.engine.hoi_model import make_eval_step, \
        make_optimizer, make_train_step
    from hoigen_tpu_torch.engine.partition import trainable_leaves
    from hoigen_tpu_torch.engine.train import Trainer
    from hoigen_tpu_torch.tools.mesh_graph_check import trainable_copy

    t6b = time.perf_counter()
    # the tracer's host spans time the weight check and the versions' bump
    # (graph.check)
    profiling.reset()
    profiling.enable()
    params0, buffers = model
    failures = []
    runs = {}
    for name in ("graphed", "eager", "eager2"):
        params = trainable_copy(params0)
        opt = make_optimizer(lr_drop_step=10)(params)
        step = make_train_step(cfg, opt)
        trainer = Trainer(step, opt, params, buffers,
                          checkpoint_every_epoch=False)
        runs[name] = {"params": params, "opt": opt, "trainer": trainer,
                      "step": trainer.step_fn if name == "graphed" else step,
                      "done": 0, "metrics": []}
    gstep = runs["graphed"]["step"]
    if not isinstance(gstep, GraphedTrainStep):
        fail(f"phase 6b: Trainer's step is a {type(gstep).__name__}")
    frozen = snapshot_frozen(runs["graphed"]["params"])

    def run(name):
        """One step of a copy, dropout from a generator seeded by its step
        count, as a Trainer seeds it. -> (loss, n_p)."""
        r = runs[name]
        gen = torch.Generator(device="cuda").manual_seed(
            args.seed * 1_000_003 + r["done"])
        m = r["step"](r["params"], buffers, batch, gen)
        r["done"] += 1
        out = (float(m["loss"]), float(m["n_p"]))
        r["metrics"].append(out)
        return out

    def gap(a, b):
        """The largest difference of each kind between two copies: the
        steps' losses and n_p since the last comparison (absolute), every
        trainable leaf and moment (relative to the leaf's largest
        magnitude), the count."""
        ra, rb = runs[a], runs[b]
        ma, mb = np.asarray(ra["metrics"]), np.asarray(rb["metrics"])
        moments = [[t for g in r["opt"].param_groups
                    for t in g["mu"] + g["nu"]] for r in (ra, rb)]
        leaves = [[t.detach() for _, t in trainable_leaves(r["params"])]
                  for r in (ra, rb)]

        def rel(xs, ys):
            return max(float((x - y).abs().max())
                       / max(float(y.abs().max()), 1e-30)
                       for x, y in zip(xs, ys))
        return {"loss": float(np.abs(ma[:, 0] - mb[:, 0]).max()),
                "n_p": float(np.abs(ma[:, 1] - mb[:, 1]).max()),
                "leaves": rel(*leaves), "moments": rel(*moments),
                "count": abs(ra["opt"].count - rb["opt"].count)}

    def compare(what):
        """Graphed against eager, bit for bit where the two eager copies
        agree bit for bit, else within twice their difference (one draw
        of a spread: a graphed copy that is one more eager-like run lands
        beyond it about half the time)."""
        ge, ee = gap("graphed", "eager"), gap("eager2", "eager")
        steps = {n: r["done"] for n, r in runs.items()}
        if len(set(steps.values())) != 1:
            failures.append(f"{what}: steps {steps}")
        for k, v in ge.items():
            if not v <= 2 * ee[k]:
                failures.append(f"{what}: graphed {k} differs from eager "
                                f"by {v:.3e}, two eager runs by {ee[k]:.3e}")
        log(f"phase 6b {what}: after {steps['graphed']} steps (count "
            f"{runs['graphed']['opt'].count}), graphed against eager "
            + ", ".join(f"{k} {v:.3e}" for k, v in ge.items())
            + "; eager against eager "
            + ", ".join(f"{k} {v:.3e}" for k, v in ee.items()))
        for r in runs.values():
            r["metrics"] = []
        return {"graphed_vs_eager": ge, "eager_vs_eager": ee,
                "steps": steps["graphed"],
                "count": runs["graphed"]["opt"].count}

    record = {"card": card, "lr_drop_step": 10}
    n = 2 + args.train_steps
    for name in runs:
        for _ in range(n):
            run(name)
    if runs["graphed"]["opt"].count <= 10:
        failures.append("the steps did not cross the learning-rate drop")
    if not all(math.isfinite(x) and x > 1e-3 and n_p > 0
               for x, n_p in runs["graphed"]["metrics"]):
        failures.append(f"losses, n_p {runs['graphed']['metrics']}")
    record["steps"] = compare(f"2 + {args.train_steps} steps across the "
                              "learning-rate drop at update 10")

    # both timed in one window, then profiled; the second eager copy takes
    # the same steps untimed
    def timed(name, k):
        times = []
        for _ in range(k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(name)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return times

    for name in ("eager", "graphed"):
        times = timed(name, args.warmup + args.train_steps)[args.warmup:]
        mean, median, q1, q3, rate = step_stats(times, args.batch)
        log(f"phase 6b {name}: {len(times)} timed training steps after "
            f"{args.warmup} warm-up: mean {mean:.3f} ms, median "
            f"{median:.3f} ms, quartiles {q1:.3f} / {q3:.3f} ms; "
            f"{rate:.2f} images/s at batch {args.batch} on {card}")
        profiled = profile_steps(lambda name=name: run(name),
                                 args.train_profile_steps)
        busy = report_profile(f"phase 6b {name}", profiled,
                              args.train_profile_steps, mean)
        record[name] = {
            "mean_ms": mean, "median_ms": median, "q1_ms": q1, "q3_ms": q3,
            "images_per_s": rate, "device_busy_ms": busy,
            "idle_share": None if busy is None else 1 - busy / mean,
            "runtime_calls_per_step": profiled[2]}
    for _ in range(args.warmup + args.train_steps
                   + args.train_profile_steps):
        run("eager2")
    runtime = record["graphed"]["runtime_calls_per_step"]
    launch_calls = sum(v for k, v in runtime.items() if "LaunchKernel" in k)
    if not launch_calls < 20 or runtime.get("cudaGraphLaunch") != 1:
        failures.append(f"the graphed step makes {launch_calls:g} kernel "
                        f"launch calls a step, runtime calls {runtime}")
    record["timed"] = compare("the timed and profiled steps")

    # changes between replays: each one new capture, then a replay
    g = next(iter(gstep.graphs.values()))

    def after(what, change):
        captures = g.captures
        change()
        for name in runs:
            run(name)
            run(name)
        if g.captures != captures + 1:
            failures.append(f"{what}: {g.captures - captures} captures, "
                            "expected 1")
        record[what] = compare(what)

    def write():
        with torch.no_grad():
            for r in runs.values():
                r["params"]["upt"]["adapter_H_w"].mul_(1.25)

    after("an in-place write to a trainable leaf", write)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_6b_")
    path = save_checkpoint(ckpt_dir, 0, runs["graphed"]["trainer"].state())
    saved_done = runs["graphed"]["done"]
    for name in runs:
        run(name)

    def restore():
        for r in runs.values():
            r["trainer"].restore(path)
            r["done"] = saved_done
            r["metrics"] = []

    after("a Trainer.restore from a checkpoint", restore)
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    def replace():
        for r in runs.values():
            visual = r["params"]["upt"]["clip"]["visual"]
            r["params"] = dict(r["params"], upt=dict(
                r["params"]["upt"], clip=dict(
                    r["params"]["upt"]["clip"], visual=dict(
                        visual, conv1_w=visual["conv1_w"].clone()))))

    after("a params tree with a replaced tensor", replace)
    changed = [p for p, t in snapshot_frozen(
        runs["graphed"]["params"]).items() if not torch.equal(t, frozen[p])]
    if changed:
        failures.append(f"frozen tensors changed: {changed[:5]}")

    # an eval step after graphed training sees the trained weights: an
    # eval graph captured and the kernel-ready copies of the trainable
    # weights made (both at the leaves' versions now), then two replays
    # of the training graph, which write the leaves; the eval graph must
    # capture again and the copies be made anew
    eval_batch = {k: batch[k] for k in ("images", "image_sizes",
                                        "clip_sizes")}
    eval_graphed, eval_eager = graphed(make_eval_step(cfg)), \
        make_eval_step(cfg)
    for step in (eval_graphed, eval_eager):
        step(runs["graphed"]["params"], buffers, eval_batch)
    eval_captures = sum(r["captures"] for r in eval_graphed.records()
                        .values())
    for name in runs:
        run(name)
        run(name)
    record["after_an_eval_step"] = compare("two replays after an eval step")
    want = eval_eager(runs["eager"]["params"], buffers, eval_batch)
    record["eval_after_training"] = {
        "graphed": same_outputs(
            "phase 6b: the graphed eval step on the graphed copy against "
            "the eager eval step on the eager copy",
            eval_graphed(runs["graphed"]["params"], buffers, eval_batch),
            want),
        "eager": same_outputs(
            "phase 6b: the eager eval step on the graphed copy against "
            "the same on the eager copy",
            eval_eager(runs["graphed"]["params"], buffers, eval_batch),
            want)}
    if sum(r["captures"] for r in eval_graphed.records().values()) != \
            eval_captures + 1:
        failures.append("the eval graph did not capture again after the "
                        "training")
    if record["after_an_eval_step"]["graphed_vs_eager"]["leaves"] == 0 and \
            any(v for d in record["eval_after_training"].values()
                for v in d.values()):
        failures.append("the eval outputs on equal weights differ: "
                        f"{record['eval_after_training']}")

    record["graphs"] = gstep.records()
    expect_epilogues("phase 6b", record["graphs"], cfg)
    record["staging"] = staging_check("6b", batch, args.seed, card)
    check = profiling.snapshot()["spans"]["graph.check"]
    profiling.disable()
    profiling.reset()
    record["check_us_per_call"] = 1e3 * check["per_step_ms"]
    record["pool_bytes"] = sum(r["pool_bytes"] for r in
                               record["graphs"].values())
    for key, rec in record["graphs"].items():
        log(f"phase 6b: graph {key}: {rec}")
    log(f"phase 6b: the weight check's and the version bump's host time "
        f"{record['check_us_per_call']:.1f} us a call (mean of "
        f"{check['steps']} graphed calls, the eval step's few among them, "
        f"{len(g.leaves)} tensors); {len(frozen)} frozen "
        f"tensors bit-identical; on {card}")
    record["seconds"] = time.perf_counter() - t6b
    log(f"phase 6b took {record['seconds']:.1f} s")
    if failures:
        fail("phase 6b: " + "; ".join(failures))
    return record


def mesh_graph_phase(model, batch, cfg, args, card):
    """Phase 6c: the training step over a mesh, graphed with its NCCL
    collectives inside (``engine/cuda_graph.py::GraphedTrainStep``, which
    ``Trainer`` takes for a mesh whose groups are NCCL: the counterpart of
    the JAX package's jitted SPMD step), on phase 6's model and batch with
    the language-aware term on, in an NCCL process group of one on
    ``cuda:0``. Two meshes: ``make_mesh()``, the (1, 1) mesh whose data
    group is the group of one, and ``Mesh(1, 2, 0, 0, g, g)`` over the
    unsharded caches, a harness and not a mesh kind of its own: a model
    axis of 2 whose one rank holds every cache row, so that every
    model-axis collective (the partial logits and their gradient, the
    optimizer's row norm) runs through NCCL while the function stays the
    one-process step's. Each mesh goes through
    ``hoigen_tpu_torch/tools/mesh_graph_check.py::mesh_run`` with
    2 + ``args.train_steps`` steps (the checks and timings it states: the
    graphed step against the eager mesh step bit for bit, the launches of
    K1, K4 and K3, one window's timing and profile, one
    ``cudaGraphLaunch``, under 20 kernel launch calls and no c10d or NCCL
    host call a graphed step, the NCCL kernels, the capture's seconds and
    the pool's bytes). Then, after the first update and after the steps,
    bit for bit: the (1, 1) mesh against the one-process graphed step of
    phase 6b made the same way, and the stand-in against a witness, the
    one-process graphed step whose optimizer sums its norm over the
    stand-in's row group (the cache rows' squares apart from the rest's:
    another f32 order than one process's, and the only one); the
    witness's first loss and n_p bit for bit one process's, its later gap
    to one process logged. In a group of one NCCL launches no kernel, so
    the NCCL kernels' device time is read only across cards (phase 6d).
    Failures are gathered and end the run at the phase's end. ->
    record."""
    import torch
    import torch.distributed as dist

    from hoigen_tpu_torch.parallel import Mesh, capturable, \
        init_distributed, make_mesh
    from hoigen_tpu_torch.parallel.distributed import free_port
    from hoigen_tpu_torch.tools import mesh_graph_check as mgc

    t6c = time.perf_counter()
    device = batch["images"].device
    cfg = dataclasses.replace(cfg, upt=dataclasses.replace(cfg.upt, LA=True))
    failures = []
    record = {"card": card, "lr_drop_step": mgc.LR_DROP,
              "language_aware": True}
    n = 2 + args.train_steps

    def held(what, got, want, keys=None):
        """Fail unless ``got`` is ``want`` bit for bit in ``keys`` (None:
        every kind of :func:`mgc.gap`). -> the gaps."""
        d = mgc.gap(got, want)
        bad = {k: v for k, v in d.items()
               if (keys is None or k in keys) and not v <= 0}
        if bad:
            failures.append(f"{what}: differs by {bad}")
        log(f"phase 6c {what}: " + ", ".join(f"{k} {v:.3e}"
                                            for k, v in d.items()))
        return d

    def one_process(norm_mesh=None):
        """The one-process graphed step over 2 + train_steps steps, its
        norm over ``norm_mesh``'s row group. -> (state after the first
        update, after the steps)."""
        r = mgc.new_run(cfg, model, device, norm_mesh=norm_mesh)
        mgc.step_once(r, batch, args.seed)
        first = mgc.state(r)
        while r["done"] < n:
            mgc.step_once(r, batch, args.seed)
        return first, mgc.state(r)

    ref = one_process()
    if not (ref[1]["count"] > mgc.LR_DROP and all(
            math.isfinite(x) and x > 1e-3 and n_p > 0
            for x, n_p in ref[1]["metrics"])):
        failures.append(f"one process: count {ref[1]['count']}, losses, "
                        f"n_p {ref[1]['metrics'].tolist()}")
    torch.cuda.empty_cache()

    init_distributed(f"localhost:{free_port()}", 1, 0, device="cuda")
    try:
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            fail(f"phase 6c: backend {dist.get_backend()}")
        mesh11 = make_mesh()
        g = mesh11.data_group
        standin = Mesh(1, 2, 0, 0, data_group=g, model_group=g)
        witness = one_process(norm_mesh=standin)
        torch.cuda.empty_cache()
        held("the witness against one process, the first step's loss "
             "and n_p", witness[0], ref[0], keys=("loss", "n_p"))
        record["witness_vs_one_process"] = held(
            f"the witness against one process after {n} steps (logged)",
            witness[1], ref[1], keys=())
        for name, mesh, want, against in (
                ("(1, 1)", mesh11, ref, "one process"),
                ("(1, 2) stand-in", standin, witness, "the witness")):
            if not capturable(mesh):
                failures.append(f"{name}: not capturable")
            rec, fails, states = mgc.mesh_run(
                mesh, model, batch, cfg, device, steps=args.train_steps,
                seed=args.seed)
            record[name] = rec
            failures += [f"{name}: {f}" for f in fails]
            for what in ("graphed_vs_eager", "timed_graphed_vs_eager"):
                log(f"phase 6c {name} {what}: " + ", ".join(
                    f"{k} {v:.3e}" for k, v in rec[what].items()))
            rec["first_vs_reference"] = held(
                f"{name}: graphed against {against} after the first "
                "update", states["first"], want[0])
            rec["steps_vs_reference"] = held(
                f"{name}: graphed against {against} after {n} steps",
                states["steps"], want[1])
            rec["steps_vs_one_process"] = mgc.gap(states["steps"], ref[1])
            for which in ("eager", "graphed"):
                t = rec[which]
                log(f"phase 6c {name} {which}: {args.train_steps} timed "
                    f"steps after {mgc.WARMUP} warm-up: mean "
                    f"{t['mean_ms']:.3f} ms, median {t['median_ms']:.3f} ms,"
                    f" quartiles {t['q1_ms']:.3f} / {t['q3_ms']:.3f} ms; "
                    f"{t['images_per_s']:.2f} images/s at batch "
                    f"{rec['images']}; busy {t['busy_ms']} ms, idle share "
                    f"{t['idle_share']}; runtime calls a step "
                    f"{t['runtime_calls']}; NCCL kernels a step "
                    f"{t['nccl_kernels'] or 'none'} "
                    f"({t['nccl_device_ms']:.4f} ms), c10d and NCCL host "
                    f"calls a step {t['nccl_host_calls'] or 'none'} on "
                    f"{card}")
            log(f"phase 6c {name}: launches {rec['launches']} over {n} "
                f"steps; graphs {rec['graphs']}; capture "
                f"{rec['capture_s']:.3f} s, pool {rec['pool_bytes']} B")
            del states
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    record["seconds"] = time.perf_counter() - t6c
    log(f"phase 6c took {record['seconds']:.1f} s")
    if failures:
        fail("phase 6c: " + "; ".join(failures))
    return record


def multi_card_phase(card):
    """Phase 6d, on a machine with two cards or more only (the script
    needs one): ``hoigen_tpu_torch/tools/mesh_graph_check.py`` over the
    largest even number of cards, the (N, 1) and (N/2, 2) meshes graphed
    against eager, with the NCCL kernels in the replay that a group of
    one cannot show. Fails unless the tool exits 0. -> its record."""
    import torch
    cards = torch.cuda.device_count() // 2 * 2
    t6d = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "hoigen_tpu_torch.tools.mesh_graph_check",
         "--cards", str(cards)], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(f"phase 6d: {line}")
    if proc.returncode or not lines:
        fail(f"phase 6d: mesh_graph_check over {cards} cards exited "
             f"{proc.returncode}: {proc.stderr[-4000:]}")
    record = json.loads(lines[-1])
    log(f"phase 6d took {time.perf_counter() - t6d:.1f} s on {cards} x "
        f"{card}")
    return record


# ------------------------------------------------------- the CLI end to end
# the repro scripts' flags (scripts/repro_common.sh) for HICO-DET's RF-UC
# zero-shot run, with the synthesis cut from the CLI's 100 rounds to 2
CLI_FLAGS = ["--num-classes", "117", "--use-multi-hot", "true",
             "--dtype", "bfloat16", "--zs", "true", "--zs-type",
             "rare_first"]
CLI_GEN_ROUNDS = 2
# H100 SXM float32 peak outside the tensor cores (the synthesis runs in
# full f32, TF32 off)
F32_FLOPS = 67e12


def text_tower_flops(clip_cfg):
    """Operations of one sequence through the text tower, as computed
    (the causal scores and products in full): per token and layer 24 w^2
    for the projections and the 4x MLP, 4 n w for the scores and the
    weighted sum."""
    w, n = clip_cfg.transformer_width, clip_cfg.context_length
    return (24 * w * w + 4 * n * w) * clip_cfg.transformer_layers * n


class FunctionTimes:
    """While active, each named function of ``module`` adds its wall time
    (from a synchronised start to a synchronised end) to ``self.s[name]``
    and counts its calls in ``self.calls[name]``."""

    def __init__(self, module, names):
        self.module, self.names = module, names
        self.s = {n: 0.0 for n in names}
        self.calls = {n: 0 for n in names}

    def __enter__(self):
        import torch
        self.saved = {n: getattr(self.module, n) for n in self.names}
        for name, fn in self.saved.items():
            def timed(*args, _name=name, _fn=fn, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    return _fn(*args, **kw)
                finally:
                    torch.cuda.synchronize()
                    self.s[_name] += time.perf_counter() - t0
                    self.calls[_name] += 1
            setattr(self.module, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)


def check_mat_files(cache_dir, n_images):
    """The 80 official .mat files of a HICO-DET --cache run: each holds
    ``all_boxes`` of (the object's interactions, n_images) entries, each
    empty or (n, 9) finite rows (human box, object box, score) whose
    boxes have x2 >= x1 - 1 and y2 >= y1 - 1 (the official format's
    corners are pixel indices, the inclusive ones less 1). Returns the
    number of rows."""
    import numpy as np
    import scipy.io as sio

    from hoigen_tpu_torch.labels import HICO
    rows = 0
    for obj in range(80):
        path = os.path.join(cache_dir, f"detections_{obj + 1:02d}.mat")
        if not os.path.isfile(path):
            fail(f"cli cache: {path} is missing")
        boxes = sio.loadmat(path)["all_boxes"]
        if boxes.shape != (len(HICO.object_to_interaction[obj]), n_images):
            fail(f"cli cache: {path} holds {boxes.shape}")
        for e in boxes.ravel():
            if not e.size:
                continue
            if e.shape[1] != 9 or not np.isfinite(e).all() or \
                    (e[:, [2, 3, 6, 7]] < e[:, [0, 1, 4, 5]] - 1).any():
                fail(f"cli cache: {path} holds a malformed entry")
            rows += len(e)
    return rows


def cli_run(mf, argv, wrappers):
    """``main(parse_config(argv))`` with the launch counters set to 0 just
    before and read just after, its stages timed. Returns (result,
    seconds, counts, {stage: seconds}, {stage: calls})."""
    import torch

    from hoigen_tpu_torch.models import generator
    from hoigen_tpu_torch.utils.config import parse_config
    cfg = parse_config(argv)
    for fn in wrappers:
        fn.launches = 0
    with FunctionTimes(mf, ("load_pretrained", "encode_class_texts",
                            "maybe_gen_features", "init_hoi_model",
                            "evaluate_hico", "cache_hico")) as times, \
            FunctionTimes(generator, ("synthesize_features",)) as synth:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = mf.main(cfg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return (result, seconds, [fn.launches for fn in wrappers],
            times.s | synth.s, times.calls | synth.calls)


def small_vcoco_config(cfg, device=None):
    """Phase 4's small float32 configuration for a V-COCO run of the CLI:
    the COCO detector's 92 logits, a 2-layer text tower of width 64."""
    cfg4 = tiny_config()
    return dataclasses.replace(
        cfg4, clip=dataclasses.replace(cfg4.clip, transformer_layers=2,
                                       transformer_width=64),
        detr=dataclasses.replace(cfg4.detr, num_classes=92),
        upt=dataclasses.replace(cfg4.upt, num_classes=cfg.num_classes,
                                generate_feature=False))


def vcoco_card_and_cpu(mf, work, seed, batch):
    """``main --eval`` of V-COCO at the small configuration from the same
    files, on the CPU, whose detections then become the ground truth (so
    that the APs compared are not zero), then on the card and on the CPU
    again: the detections index for index (boxes and scores within 2e-4
    of their scale) and every number of the two role-AP reports within
    1e-6. Returns a record."""
    import functools

    import numpy as np

    from hoigen_tpu_torch.data import factory as factory_module
    from hoigen_tpu_torch.tools.make_checkpoints import write_checkpoints
    from hoigen_tpu_torch.tools.make_vcoco import \
        annotate_vcoco_from_detections, build_vcoco
    from hoigen_tpu_torch.utils.config import RunConfig

    root = build_vcoco(os.path.join(work, "vcoco"), n_images=8, seed=seed)
    small = small_vcoco_config(RunConfig(dataset="vcoco", num_classes=24))
    saved = (mf.make_model_config, mf.DataFactory, mf.evaluate_vcoco,
             factory_module.DEFAULT_BUCKETS)
    runs, reports = {}, {}

    def files(file_seed):
        # the person in slot 1 of the 92 logits; the box head spread by 6
        # (by more, the small DETR's boxes at 64 x 48 pixels have no area)
        return write_checkpoints(os.path.join(work, f"vcoco_{file_seed}"),
                                 small.clip, small.detr, seed=file_seed,
                                 dino=False, spread=6.0, human=1)

    current = {}

    def capture(stream, *args, **kw):
        runs[current["run"]] = list(stream)
        return saved[2](iter(runs[current["run"]]), *args, **kw)

    mf.make_model_config = small_vcoco_config
    mf.DataFactory = functools.partial(
        factory_module.DataFactory, clip_resolution=small.upt.clip_resolution,
        transform_kwargs=SMALL_TRANSFORM)
    mf.evaluate_vcoco = capture
    factory_module.DEFAULT_BUCKETS = SMALL_BUCKETS
    def evaluate(run, device, paths):
        current["run"] = run
        cfg = RunConfig(dataset="vcoco", data_root=root, num_classes=24,
                        batch_size=batch, eval=True, seed=seed,
                        generate_feature=False,
                        clip_model_path=paths["clip"],
                        pretrained_detr=paths["detr"],
                        dino_pretrained=os.path.join(work, "absent"),
                        output_dir=os.path.join(work, f"vcoco_{run}"))
        t0 = time.perf_counter()
        reports[run] = mf.main(cfg, device=device)
        log(f"cli vcoco: --eval on {device} in "
            f"{time.perf_counter() - t0:.1f} s")

    try:
        # the random small DETR of some seeds gives every query one box,
        # and no pair forms: the files of the first of five seeds whose
        # DETR finds pairs on the CPU, whose detections then become the
        # ground truth
        for file_seed in range(seed, seed + 5):
            paths = files(file_seed)
            evaluate("first", "cpu", paths)
            if annotate_vcoco_from_detections(root, runs["first"],
                                              small.upt.proposals):
                break
        else:
            fail("cli vcoco: no pair was detected from five seeds' files")
        log(f"cli vcoco: the files of seed {file_seed}")
        for run in ("cuda", "cpu"):
            evaluate(run, run, paths)
    finally:
        (mf.make_model_config, mf.DataFactory, mf.evaluate_vcoco,
         factory_module.DEFAULT_BUCKETS) = saved
    worst = 0.0
    n_det = 0
    for (go, gb), (co, cb) in zip(runs["cuda"], runs["cpu"]):
        if not np.array_equal(gb.indices, cb.indices):
            fail("cli vcoco: the batches differ between card and CPU")
        for k in ("pair_valid", "objects", "detection_verbs"):
            if not np.array_equal(go[k], co[k]):
                fail(f"cli vcoco: {k} differs between card and CPU")
        for k in ("boxes", "detection_scores"):
            err = float(np.abs(go[k] - co[k]).max())
            if not err <= 2e-4 * max(1.0, float(np.abs(co[k]).max())):
                fail(f"cli vcoco: {k} differs by {err:.3e}")
            worst = max(worst, err)
        n_det += int((co["detection_scores"] > 0).sum())
    if len(runs["cuda"]) != len(runs["cpu"]) or not n_det:
        fail(f"cli vcoco: {len(runs['cuda'])} / {len(runs['cpu'])} batches, "
             f"{n_det} detections")

    def numbers(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from numbers(v, path + (k,))
        elif isinstance(tree, (int, float, np.number, np.ndarray)):
            yield path, np.asarray(tree, np.float64)

    got, want = dict(numbers(reports["cuda"])), dict(numbers(reports["cpu"]))
    if got.keys() != want.keys() or not got:
        fail("cli vcoco: the reports differ in their keys")
    ap_err = max(float(np.abs(got[p] - want[p]).max(initial=0.0))
                 for p in got)
    means = {k: reports["cuda"][k]["mean"] for k in
             ("role_ap_scenario_1", "role_ap_scenario_2", "agent_ap")}
    if not ap_err <= 1e-6 or not means["role_ap_scenario_1"] > 0:
        fail(f"cli vcoco: the role APs differ by {ap_err:.3e} (card: "
             f"{means})")
    log(f"cli vcoco: {len(runs['cuda'])} batches, {n_det} detections, "
        f"indices equal, boxes and scores within {worst:.3e}; role APs "
        f"{means} on the card, every number of the reports within "
        f"{ap_err:.3e} of the CPU's ok")
    return {"file_seed": file_seed, "detections": n_det,
            "max_abs_err": worst, "report_max_abs_diff": ap_err,
            "means": means}


def cli_phase(args, card, work, ctx):
    """Phase 8: ``cli/main_finetune.py::main`` at full width from files on
    disk, in a temporary working directory: an epoch of training, then
    --eval and --cache resumed from its checkpoint, each with the launch
    counters set to 0 just before; then V-COCO at the small configuration
    on the card and on the CPU, in ``work`` (made here, kept for phases
    11 and 12, which find its paths in ``ctx``). Returns the ``cli_run``
    record."""
    import numpy as np
    import torch

    from hoigen_tpu_torch.cli import main_finetune as mf
    from hoigen_tpu_torch.engine.cuda_graph import GraphedTrainStep
    from hoigen_tpu_torch.tools.make_checkpoints import write_checkpoints
    from hoigen_tpu_torch.tools.make_hicodet import write_hicodet
    from hoigen_tpu_torch.utils.config import parse_config

    t8 = time.perf_counter()
    os.makedirs(work)
    cwd = os.getcwd()
    names, wrappers = kernel_wrappers()
    record = {"card": card, "gen_rounds": CLI_GEN_ROUNDS,
              "flags": " ".join(CLI_FLAGS)}
    try:
        # the CLI writes caches/dataset/ and args.json where it runs
        os.chdir(work)
        data = write_hicodet(os.path.join(work, "hicodet"), EVAL_SIZES,
                             seed=args.seed)
        out, cache_out = (os.path.join(work, d) for d in ("run", "cache"))
        model_cfg = mf.make_model_config(parse_config(CLI_FLAGS))
        # the frozen-BN epilogues of a detector forward (bf16 towers)
        epilogues = epilogue_sites(model_cfg)
        t0 = time.perf_counter()
        paths = write_checkpoints(
            os.path.join(work, "ckpt"), model_cfg.clip, model_cfg.detr,
            seed=args.seed, image_names=[
                f"HICO_train2015_{i:08d}.jpg" for i in range(len(EVAL_SIZES))])
        record["write_files_s"] = time.perf_counter() - t0
        record["file_mb"] = {k: os.path.getsize(p) / 2 ** 20
                             for k, p in paths.items()}
        log(f"cli: wrote the checkpoint files in {record['write_files_s']:.1f}"
            f" s ({', '.join(f'{k} {v:.0f} MB' for k, v in record['file_mb'].items())})")
        argv = CLI_FLAGS + [
            "--data-root", data, "--output-dir", out,
            "--gen-rounds", str(CLI_GEN_ROUNDS),
            "--clip-model-path", paths["clip"],
            "--pretrained-detr", paths["detr"],
            "--dino-pretrained", paths["dino"], "--file1", paths["pairs"],
            "--gen-ckpt-dir", os.path.join(work, "generators"),
            "--batch-size", str(args.batch), "--epochs", "1",
            "--print-interval", "100", "--seed", str(args.seed)]
        seqs = 3 * CLI_GEN_ROUNDS * 600
        flops = seqs * text_tower_flops(model_cfg.clip)
        bound_s = flops / F32_FLOPS
        record.update(synthesis_sequences=seqs, synthesis_flops=flops,
                      synthesis_bound_s=bound_s, runs={})
        for mode, extra in (
                ("train", []),
                ("eval", ["--eval", "true", "--resume", out]),
                ("cache", ["--cache", "true", "--resume", out,
                           "--output-dir", cache_out])):
            result, seconds, counts, stage_s, calls = cli_run(
                mf, argv + extra, wrappers)
            launches = dict(zip(names, counts))
            synth_s = stage_s["synthesize_features"]
            run = {"seconds": seconds, "launches": launches,
                   "stages_s": stage_s, "calls": calls,
                   "synthesis_sequences_per_s": seqs / synth_s,
                   "synthesis_share_of_bound": bound_s / synth_s}
            if mode == "train":
                steps = result.iteration
                # K1: 6 in DETR's encoder (bf16) and 12 in CLIP; K3 3 a
                # step: the CLI's batches carry no generated pairs
                expect = [18 * steps, 12 * steps, steps, 3 * steps,
                          epilogues * steps]
                losses = list(result._losses)
                if not steps or not all(np.isfinite(losses)) or \
                        not os.path.isfile(os.path.join(
                            out, f"ckpt_{steps:08d}.pt")):
                    fail(f"cli train: {steps} steps, losses {losses}")
                # one process: the Trainer's step is graphed, one graph a
                # batch shape, each step a capture or a replay
                graphs = result.step_fn.records()
                calls_g = sum(g["captures"] + g["replays"]
                              for g in graphs.values())
                if not isinstance(result.step_fn, GraphedTrainStep) or \
                        calls_g != steps:
                    fail(f"cli train: {steps} steps, graphs {graphs}")
                run.update(steps=steps, losses=losses, graphs=graphs)
                del result
            else:
                # the test partition at batch args.batch, tail padded
                n_b = -(-len(EVAL_SIZES) // args.batch)
                expect = [6 * n_b, 0, n_b, 3 * n_b, epilogues * n_b]
                run["batches"] = n_b
            if mode == "eval":
                ap = np.asarray(result["ap"])
                if ap.shape != (600,) or not np.isfinite(ap).all() or \
                        not ((ap >= 0) & (ap <= 1)).all() or \
                        "mAP_unseen" not in result:
                    fail(f"cli eval: ap of shape {ap.shape}, keys "
                         f"{sorted(result)}")
                run.update({k: result[k] for k in (
                    "mAP", "mAP_rare", "mAP_non_rare", "mAP_unseen",
                    "mAP_seen")})
            if mode == "cache":
                run["mat_rows"] = check_mat_files(cache_out,
                                                  len(EVAL_SIZES))
                if not run["mat_rows"]:
                    fail("cli cache: the .mat files hold no detection")
            if counts != expect:
                fail(f"cli {mode}: launches {launches}, expected "
                     f"{dict(zip(names, expect))}")
            record["runs"][mode] = run
            log(f"cli {mode}: main in {seconds:.2f} s; launches {launches} "
                f"as expected; " + ", ".join(
                    f"{k} {v:.3f} s ({calls[k]}x)"
                    for k, v in stage_s.items() if calls[k]))
            log(f"cli {mode}: synthesis of {seqs} sequences in "
                f"{synth_s:.3f} s, {seqs / synth_s:.0f} sequences/s, "
                f"{100 * bound_s / synth_s:.1f}% of the f32 bound "
                f"({bound_s:.3f} s at {flops / 1e12:.1f} TFLOP) on {card}")
            if mode == "train":
                log(f"cli train: {run['steps']} steps, losses "
                    f"{', '.join(f'{x:.5f}' for x in run['losses'])}; "
                    f"graphed: {run['graphs']}")
            elif mode == "eval":
                log(f"cli eval: mAP {run['mAP']:.6f}, unseen "
                    f"{run['mAP_unseen']:.6f} (random weights)")
            else:
                log(f"cli cache: 80 .mat files, {run['mat_rows']} rows ok")
            torch.cuda.empty_cache()
        record["vcoco"] = vcoco_card_and_cpu(mf, work, args.seed, args.batch)
        ctx.update(argv=argv, data=data, paths=paths, out=out,
                   epilogues=epilogues)
    finally:
        os.chdir(cwd)
    record["seconds"] = time.perf_counter() - t8
    log(f"phase 8 took {record['seconds']:.1f} s")
    return record


# ----------------------------------------------- the generator pipeline
# phase 9's tree: 384 small JPEGs a partition, 1 to 3 pairs each, so that
# every family's split holds at least 512 crops after the IoU dedup: two
# VAE and SHIP steps at batch 256
GEN_SIZES = [(96, 72), (72, 96), (112, 84), (84, 112)] * 96
GEN_FAMILIES = ("hoi", "human", "object")
GEN_BATCH = 256
# the images of pair-embeddings and global-caches (cut from the partition)
GEN_ENCODE_LIMIT = 128
# K1's batches on the crop encodes: main_vae, prepare_data's clip_apply,
# the device crop encoder's chunk
GEN_K1_BATCHES = (256, 64, 32)
# phase 9's small configuration, card against CPU: 2 blocks a tower, the
# image tower 128 wide (2 heads), the text tower at its 512
GEN_SMALL_TOL = 5e-2        # K1's f32 route rounds q, k and v to bf16


def kernel_wrappers():
    """(names, wrappers) of the five kernels' launch counters."""
    from hoigen_tpu_torch.ops.attention import attention_bwd, \
        fused_attention
    from hoigen_tpu_torch.ops.conv_epilogue import conv_epilogue
    from hoigen_tpu_torch.ops.fused_resnet import fused_bottleneck_chain
    from hoigen_tpu_torch.ops.pallas_cache import fused_cache_logits
    return (("attention_fwd", "attention_bwd", "bottleneck_chain_fwd",
             "cache_logits_fwd", "conv_epilogue"),
            (fused_attention, attention_bwd, fused_bottleneck_chain,
             fused_cache_logits, conv_epilogue))


def counted_run(fn, *args, **kw):
    """``fn(*args, **kw)`` with the launch counters set to 0 just before
    and read just after. -> (result, seconds, {kernel: launches})."""
    import torch
    names, wrappers = kernel_wrappers()
    for w in wrappers:
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn(*args, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return result, seconds, {n: w.launches for n, w in zip(names, wrappers)}


class Recorded:
    """While active, each call of ``module.name`` appends what ``keep``
    makes of its arguments and result to ``self.calls``."""

    def __init__(self, module, name, keep):
        self.module, self.name, self.keep = module, name, keep
        self.calls = []

    def __enter__(self):
        fn = self.saved = getattr(self.module, self.name)

        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            self.calls.append(self.keep(args, out))
            return out
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)


def expect_launches(what, counts, k1, epilogues=0):
    """Fail unless ``counts`` holds ``k1`` K1 launches, ``epilogues``
    epilogue launches and no other."""
    want = {"attention_fwd": k1, "attention_bwd": 0,
            "bottleneck_chain_fwd": 0, "cache_logits_fwd": 0,
            "conv_epilogue": epilogues}
    if counts != want:
        fail(f"{what}: launches {counts}, expected {want}")


def frozen_clip_check(what, snapshots):
    """Every CLIP tensor loaded by a run bit-identical to its copy taken
    at load time, and none with a gradient. -> the number of tensors."""
    import torch

    from hoigen_tpu_torch.engine.partition import named_leaves
    n = 0
    for params, copies in snapshots:
        for path, t in named_leaves(params):
            if t.grad is not None or t.requires_grad or \
                    not torch.equal(t, copies[path]):
                fail(f"{what}: frozen CLIP tensor {path} changed")
            n += 1
    if not n:
        fail(f"{what}: no CLIP tensor was loaded")
    return n


def generator_small_card_and_cpu(work, data, seed):
    """Phase 9's small configuration from one CLIP file on the card and on
    the CPU: ``pair-embeddings`` through the device crop encoder (boxes
    and ids equal, features within GEN_SMALL_TOL of their scale) and two
    ``main_vae`` steps at batch 4 (each step's loss, and the written
    parameters, within GEN_SMALL_TOL). Returns a record."""
    import pickle

    import numpy as np
    import torch

    from hoigen_tpu_torch.cli import main_vae, prepare_data
    from hoigen_tpu_torch.models import generator as G
    from hoigen_tpu_torch.models.clip.config import CLIPConfig
    from hoigen_tpu_torch.tools.make_checkpoints import clip_state_dict

    small = CLIPConfig(vision_layers=2, vision_width=128,
                       transformer_layers=2, use_adapter=False)
    path = os.path.join(work, "clip_small.pt")
    torch.save(clip_state_dict(small, seed + 5), path)
    split = os.path.join(work, "hoi_split.json")
    with open(split) as f:
        items = json.load(f)["train"][:8]
    small_split = os.path.join(work, "small_split.json")
    with open(small_split, "w") as f:
        json.dump({"train": items, "test": []}, f)
    runs = {}
    for dev in ("cuda", "cpu"):
        pairs = os.path.join(work, f"small_pairs_{dev}.p")
        prepare_data.main(["pair-embeddings", "--data-root", data,
                           "--clip-model", path, "--limit", "6",
                           "--out", pairs], device=dev)
        with Recorded(G, "vae_step",
                      lambda a, out: out.detach().item()) as losses:
            npz = main_vae.main(["--split-json", small_split,
                                 "--clip-model", path, "--ckpt-dir",
                                 os.path.join(work, f"small_{dev}"),
                                 "--epochs", "1", "--batch-size", "4",
                                 "--seed", str(seed)], device=dev)
        with open(pairs, "rb") as f:
            runs[dev] = (pickle.load(f), losses.calls, dict(np.load(npz)))
    (gp, gl, gw), (cp, cl, cw) = runs["cuda"], runs["cpu"]
    if gp.keys() != cp.keys() or len(gp) != 6:
        fail("generator small: the pair pickles hold other images")
    worst = 0.0
    for name in gp:
        for k, v in gp[name].items():
            if not k.endswith("_features"):
                if not np.array_equal(v, cp[name][k]):
                    fail(f"generator small: {k} of {name} differs")
                continue
            err = float(np.abs(v - cp[name][k]).max())
            if not err <= GEN_SMALL_TOL * max(1.0, float(
                    np.abs(cp[name][k]).max())):
                fail(f"generator small: {k} differs by {err:.3e}")
            worst = max(worst, err)
    loss_err = float(np.abs(np.subtract(gl, cl)).max()) if gl else 1e9
    if len(gl) != 2 or len(cl) != 2 or not loss_err <= GEN_SMALL_TOL * \
            max(1.0, max(abs(x) for x in cl)):
        fail(f"generator small: VAE losses {gl} (card) {cl} (CPU)")
    param_err = max(float(np.abs(gw[k] - cw[k]).max()) for k in cw)
    if gw.keys() != cw.keys() or not param_err <= GEN_SMALL_TOL:
        fail(f"generator small: VAE parameters differ by {param_err:.3e}")
    log(f"generator small: 6 images' pair features within {worst:.3e} of "
        f"the CPU's, ids and boxes equal; VAE losses {gl} (card) {cl} "
        f"(CPU), parameters within {param_err:.3e} ok")
    return {"feature_max_abs_err": worst, "loss_max_abs_err": loss_err,
            "param_max_abs_err": param_err, "losses_card": gl,
            "losses_cpu": cl}


def generator_phase(args, card, work, ctx):
    """Phase 9: the generator pipeline through its CLIs at full width
    (ViT-B/16 CLIP with its text tower, from a file written from
    ``--seed``) on GEN_SIZES' tree, in the working directory ``work``
    (made here, kept for phase 12, which finds the splits in ``ctx``):
    ``prepare_data`` crops, gt-features, pair-embeddings (device crop
    encoder) and global-caches, then ``main_vae`` and ``finetune_ship``
    for each family at batch 256, each run with the launch counters set
    to 0 just before; then the small configuration on the card and on the
    CPU. Returns the ``generator_run`` record."""
    import math as _math
    import pickle

    import numpy as np
    import torch

    from hoigen_tpu_torch.cli import finetune_ship, main_vae, prepare_data
    from hoigen_tpu_torch.data import crops as crops_module
    from hoigen_tpu_torch.engine.partition import named_leaves
    from hoigen_tpu_torch.models import generator as G
    from hoigen_tpu_torch.models.clip.config import VIT_B16
    from hoigen_tpu_torch.tools.make_checkpoints import clip_state_dict
    from hoigen_tpu_torch.tools.make_hicodet import write_hicodet

    t9 = time.perf_counter()
    per_encode = VIT_B16.vision_layers      # K1 launches a CLIP encode
    os.makedirs(work)
    cwd = os.getcwd()
    record = {"card": card, "images": len(GEN_SIZES), "runs": {},
              "batch": GEN_BATCH, "epochs": 1}
    runs = record["runs"]
    seed = str(args.seed)
    try:
        os.chdir(work)
        t0 = time.perf_counter()
        data = write_hicodet(os.path.join(work, "hico"), GEN_SIZES,
                             seed=args.seed)
        clip_path = os.path.join(work, "clip.pt")
        torch.save(clip_state_dict(VIT_B16, args.seed), clip_path)
        record["write_files_s"] = time.perf_counter() - t0
        log(f"generator: wrote {2 * len(GEN_SIZES)} JPEGs and the ViT-B/16 "
            f"CLIP file in {record['write_files_s']:.1f} s")

        # crops and splits, on the host
        splits = {}
        for fam in GEN_FAMILIES:
            split = os.path.join(work, f"{fam}_split.json")
            _, sec, counts = counted_run(prepare_data.main, [
                "crops", "--data-root", data, "--category", fam,
                "--out-dir", "crops", "--out", split, "--seed", seed])
            expect_launches(f"crops {fam}", counts, 0)
            with open(split) as f:
                n = len(json.load(f)["train"])
            if n < 2 * GEN_BATCH:
                fail(f"crops {fam}: {n} crops, fewer than two batches")
            splits[fam] = (split, n)
            runs[f"crops_{fam}"] = {"seconds": sec, "crops": n,
                                    "launches": counts}
        log("generator: crops " + ", ".join(
            f"{f} {splits[f][1]}" for f in GEN_FAMILIES))

        # GT features: host crops, CLIP encodes of 64
        gt = {}
        for fam in GEN_FAMILIES:
            split, n = splits[fam]
            gt[fam] = os.path.join(work, f"gt_{fam}.pickle")
            with FunctionTimes(prepare_data, ("produce_gt_features",)) \
                    as pt:
                _, sec, counts = counted_run(prepare_data.main, [
                    "gt-features", "--split-json", split, "--clip-model",
                    clip_path, "--out", gt[fam]])
            loop_s = pt.s["produce_gt_features"]
            expect_launches(f"gt-features {fam}", counts,
                            per_encode * _math.ceil(n / 64))
            with open(gt[fam], "rb") as f:
                feats = [v[0] for v in pickle.load(f).values() if v]
            if sum(len(v) for v in feats) != n or not all(
                    np.isfinite(v).all() for v in feats):
                fail(f"gt-features {fam}: {sum(map(len, feats))} of {n}")
            runs[f"gt_features_{fam}"] = {"seconds": sec, "crops": n,
                                          "producer_s": loop_s,
                                          "crops_per_s": n / loop_s,
                                          "launches": counts}
            log(f"generator: gt-features {fam}: {n} crops in {loop_s:.2f} "
                f"s, {n / loop_s:.0f} crops/s (host crops, CLIP at batch "
                f"64; main {sec:.2f} s with the CLIP file's load); "
                f"launches {counts}")

        # pair embeddings through the device crop encoder (chunks of 32)
        pairs = os.path.join(work, "pairs.p")
        with FunctionTimes(prepare_data, ("produce_pair_embeddings",)) \
                as pt:
            _, sec, counts = counted_run(prepare_data.main, [
                "pair-embeddings", "--data-root", data, "--clip-model",
                clip_path, "--limit", str(GEN_ENCODE_LIMIT), "--out", pairs])
        loop_s = pt.s["produce_pair_embeddings"]
        with open(pairs, "rb") as f:
            anno = pickle.load(f)
        n_crops = sum(3 * len(a["boxes_h"]) for a in anno.values())
        chunks = sum(_math.ceil(3 * len(a["boxes_h"]) / 32)
                     for a in anno.values())
        expect_launches("pair-embeddings", counts, per_encode * chunks)
        if len(anno) != GEN_ENCODE_LIMIT or not all(
                np.isfinite(a[k]).all() and a[k].shape[1] == 512
                for a in anno.values() for k in
                ("huamn_features", "object_features", "union_features")):
            fail("pair-embeddings: the pickle is malformed")
        runs["pair_embeddings"] = {"seconds": sec, "images": len(anno),
                                   "crops": n_crops, "producer_s": loop_s,
                                   "crops_per_s": n_crops / loop_s,
                                   "launches": counts}
        log(f"generator: pair-embeddings: {n_crops} crops of {len(anno)} "
            f"images in {loop_s:.2f} s, {n_crops / loop_s:.0f} crops/s "
            f"(JPEG reads, device crops, {chunks} encodes of 32; main "
            f"{sec:.2f} s with the CLIP file's load); launches {counts}")

        # global caches: whole CLIP-frame images, CLIP and DINO
        caches = os.path.join(work, "global.npz")
        _, sec, counts = counted_run(prepare_data.main, [
            "global-caches", "--data-root", data, "--clip-model", clip_path,
            "--limit", str(GEN_ENCODE_LIMIT), "--num-classes", "117",
            "--out", caches])
        # CLIP's K1 and, under no_grad, DINO's ResNet-50 in f32: one
        # epilogue launch a site of each batch of 64
        batches = _math.ceil(GEN_ENCODE_LIMIT / 64)
        expect_launches("global-caches", counts, per_encode * batches,
                        resnet_epilogues() * batches)
        z = np.load(caches)
        if z["clip_keys"].shape != (512, 234) or \
                z["dino_keys"].shape != (2048, 234) or \
                not all(np.isfinite(z[k]).all() for k in z.files):
            fail(f"global-caches: {[(k, z[k].shape) for k in z.files]}")
        runs["global_caches"] = {"seconds": sec, "images": GEN_ENCODE_LIMIT,
                                 "launches": counts}
        log(f"generator: global-caches of {GEN_ENCODE_LIMIT} images in "
            f"{sec:.2f} s; launches {counts}")

        # the VAE of each family, then its SHIP MLP, at batch 256
        for fam in GEN_FAMILIES:
            split, n = splits[fam]
            steps = n // GEN_BATCH
            snapshots = []

            def keep_clip(a, out):
                snapshots.append((out[0], {p: t.clone() for p, t in
                                           named_leaves(out[0])}))
            argv = ["--data", f"{fam}_data", "--split-json", split,
                    "--clip-model", clip_path, "--ckpt-dir", "ckpt",
                    "--epochs", "1", "--batch-size", str(GEN_BATCH),
                    "--seed", seed]
            with Recorded(main_vae, "load_clip", keep_clip), \
                    Recorded(G, "vae_step", lambda a, out: out.detach()) \
                    as losses, \
                    Recorded(main_vae, "save_family",
                             lambda a, out: {k: v for k, v in
                                             named_leaves(a[0])}) as saved, \
                    FunctionTimes(main_vae, ("train_vae", "encode_image")) \
                    as vt, FunctionTimes(G, ("build_prompt_tables",
                                             "tables_on")) as tt, \
                    FunctionTimes(crops_module.CropDataset,
                                  ("__getitem__",)) as load:
                vae_path, sec, counts = counted_run(main_vae.main, argv)
            expect_launches(f"main_vae {fam}", counts, per_encode * steps)
            vl = [float(x) for x in losses.calls]
            if len(vl) != steps or not all(map(math.isfinite, vl)) or \
                    len(set(vl)) < 2:
                fail(f"main_vae {fam}: losses {vl} over {steps} steps")
            n_frozen = frozen_clip_check(f"main_vae {fam}", snapshots)
            back = main_vae.load_family(vae_path)
            if {k for k, _ in named_leaves(back)} != set(saved.calls[0]) or \
                    not all(torch.equal(t, saved.calls[0][k].cpu())
                            for k, t in named_leaves(back)):
                fail(f"main_vae {fam}: {vae_path} reads back otherwise")
            # the loop less its crop loads, encodes and prompt tables
            tables_s = tt.s["build_prompt_tables"] + tt.s["tables_on"]
            step_s = vt.s["train_vae"] - vt.s["encode_image"] - \
                load.s["__getitem__"] - tables_s
            runs[f"main_vae_{fam}"] = {
                "seconds": sec, "steps": steps, "losses": vl,
                "launches": counts, "train_s": vt.s["train_vae"],
                "encode_s": vt.s["encode_image"],
                "crop_load_s": load.s["__getitem__"], "tables_s": tables_s,
                "step_s": step_s, "steps_per_s": steps / step_s,
                "encode_crops_per_s": steps * GEN_BATCH /
                vt.s["encode_image"], "frozen_tensors": n_frozen}
            log(f"generator: main_vae {fam}: {steps} steps at batch "
                f"{GEN_BATCH}, losses {', '.join(f'{x:.5f}' for x in vl)}; "
                f"main {sec:.2f} s, train_vae {vt.s['train_vae']:.2f} s of "
                f"which the crop loads {load.s['__getitem__']:.2f} s, the "
                f"prompt tables {tables_s:.3f} s and the encodes "
                f"{vt.s['encode_image']:.3f} s "
                f"({steps * GEN_BATCH / vt.s['encode_image']:.0f} crops/s); "
                f"steps {step_s:.3f} s, {steps / step_s:.2f} steps/s; "
                f"{n_frozen} CLIP tensors bit-identical; launches {counts}; "
                f"{os.path.basename(vae_path)} reads back")

            with Recorded(G, "ship_step", lambda a, out: out.detach()) \
                    as losses, \
                    Recorded(finetune_ship, "save_mlp",
                             lambda a, out: {k: v for k, v in
                                             named_leaves(a[0])}) as saved, \
                    FunctionTimes(finetune_ship, ("train_ship",)) as st, \
                    FunctionTimes(G, ("tables_on",)) as tt, \
                    FunctionTimes(crops_module.CropDataset,
                                  ("__getitem__",)) as load:
                mlp_path, sec, counts = counted_run(finetune_ship.main, [
                    "--data", f"{fam}_data", "--vae-ckpt", vae_path,
                    "--gt-features", gt[fam], "--split-json", split,
                    "--clip-model", clip_path, "--ckpt-dir", "ckpt",
                    "--epochs", "1", "--batch-size", str(GEN_BATCH),
                    "--seed", seed])
            expect_launches(f"finetune_ship {fam}", counts, 0)
            sl = [float(x) for x in losses.calls]
            if len(sl) != steps or not all(map(math.isfinite, sl)) or \
                    len(set(sl)) < 2:
                fail(f"finetune_ship {fam}: losses {sl} over {steps} steps")
            back = finetune_ship.load_mlp(mlp_path)
            if len(back) != 3 or not all(
                    torch.equal(t, saved.calls[0][k].cpu())
                    for k, t in named_leaves(back)):
                fail(f"finetune_ship {fam}: {mlp_path} reads back otherwise")
            step_s = st.s["train_ship"] - load.s["__getitem__"] - \
                tt.s["tables_on"]
            runs[f"finetune_ship_{fam}"] = {
                "seconds": sec, "steps": steps, "losses": sl,
                "launches": counts, "train_s": st.s["train_ship"],
                "crop_load_s": load.s["__getitem__"], "step_s": step_s,
                "steps_per_s": steps / step_s}
            log(f"generator: finetune_ship {fam}: losses "
                f"{', '.join(f'{x:.5f}' for x in sl)}; main {sec:.2f} s, "
                f"train_ship {st.s['train_ship']:.2f} s of which the crop "
                f"loads {load.s['__getitem__']:.2f} s and the prompt tables "
                f"{tt.s['tables_on']:.3f} s; steps {step_s:.3f} s, "
                f"{steps / step_s:.2f} steps/s; launches {counts}; "
                f"{os.path.basename(mlp_path)} reads back")
            torch.cuda.empty_cache()
        record["small"] = generator_small_card_and_cpu(work, data,
                                                       args.seed)
        ctx.update(splits=splits)
    finally:
        os.chdir(cwd)
    record["seconds"] = time.perf_counter() - t9
    log(f"phase 9 took {record['seconds']:.1f} s")
    return record


# ------------------------------------------------- the DETR offline finetune
def detr_finetune_phase(args, card):
    """Phase 10: ``cli/train_detr.py::main`` at the JAX CLI's defaults
    (batch 2, --max-gt 32, aux losses) on phase 7's tree from a DETR-R50
    file written from ``--seed``, one epoch; then ``cli/detections.py``
    dump, gt and eval, each with the launch counters set to 0 just before.
    Checks the losses, the launches (none: the finetune's gates are
    closed, and dump's f32 DETR closes K1's), one batch's matches against
    the CPU's on the same outputs, the checkpoint and the APs. Returns the
    ``detr_finetune_run`` record."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from hoigen_tpu_torch.cli import detections, train_detr
    from hoigen_tpu_torch.models.detr.config import DETRConfig
    from hoigen_tpu_torch.ops.matching import detr_matching_cost
    from hoigen_tpu_torch.tools.make_checkpoints import detr_state_dict
    from hoigen_tpu_torch.tools.make_hicodet import write_hicodet

    t10 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="detr_")
    record = {"card": card, "images": len(EVAL_SIZES), "batch": 2,
              "max_gt": 32, "epochs": 1}
    first, losses, step_s = {}, [], []
    make_fns = train_detr.detr_train_step_fns

    def recording_fns(*a, **kw):
        forward_and_cost, loss_and_update = make_fns(*a, **kw)

        def fwd(params, images, mask, gt_labels, gt_boxes):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            layers, costs = forward_and_cost(params, images, mask,
                                             gt_labels, gt_boxes)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            if not first:
                first.update(layers=[t.detach().cpu() for t in layers],
                             labels=np.array(gt_labels),
                             boxes=np.array(gt_boxes),
                             costs=costs.cpu().numpy())
            return layers, costs

        def upd(layers, gt_labels, gt_boxes, gt_valid, rows, cols, mvalid):
            t0 = time.perf_counter()
            out = loss_and_update(layers, gt_labels, gt_boxes, gt_valid,
                                  rows, cols, mvalid)
            torch.cuda.synchronize()
            step_s[-1] += time.perf_counter() - t0
            if "rows" not in first:
                first.update(rows=rows, cols=cols, valid=np.array(gt_valid))
            losses.append(out["total"].item())
            return out
        return fwd, upd

    try:
        data = write_hicodet(os.path.join(work, "hico"), EVAL_SIZES,
                             seed=args.seed)
        pth = os.path.join(work, "detr.pth")
        torch.save({"model": detr_state_dict(DETRConfig(), args.seed + 1,
                                             spread=30.0)}, pth)
        out = os.path.join(work, "detr_out")
        train_detr.detr_train_step_fns = recording_fns
        try:
            with FunctionTimes(train_detr, ("run_epoch",)) as ft:
                (_, avg), sec, counts = counted_run(train_detr.main, [
                    "--data-root", data, "--pretrained", pth, "--epochs",
                    "1", "--output-dir", out, "--seed", str(args.seed)])
        finally:
            train_detr.detr_train_step_fns = make_fns
        # autograd records the finetune's backbone: its epilogues are the
        # ATen chain, with its gradient, and no kernel launches
        expect_launches("train_detr", counts, 0)
        steps = len(EVAL_SIZES) // 2
        if len(losses) != steps or not all(map(math.isfinite, losses)) or \
                len(set(losses)) < 2 or not os.path.isfile(
                    os.path.join(out, "ckpt_00000001.pt")):
            fail(f"train_detr: losses {losses} over {steps} steps")
        # the first batch's matches from the CPU's costs of the card's
        # outputs
        lg, bx = first["layers"]
        cpu_costs = detr_matching_cost(lg, bx, torch.as_tensor(
            first["labels"]).long(), torch.as_tensor(first["boxes"]))
        cost_err = float(np.abs(cpu_costs.numpy() - first["costs"]).max())
        rows, cols, _ = train_detr.match_layers(cpu_costs.numpy(),
                                                first["valid"], 32)
        if not (np.array_equal(rows, first["rows"]) and
                np.array_equal(cols, first["cols"])):
            fail("train_detr: the first batch's matches differ from the "
                 "CPU's")
        loop_s = ft.s["run_epoch"]
        # the forward, costs, losses, backward and update of each step,
        # without the host's batches and matching; the first step holds
        # the first calls
        later = sorted(step_s[1:])
        record["train"] = {"seconds": sec, "steps": steps, "losses": losses,
                           "mean_loss": avg, "launches": counts,
                           "epoch_s": loop_s, "steps_per_s": steps / loop_s,
                           "step_s": step_s,
                           "median_step_s": later[len(later) // 2],
                           "matches": int(first["valid"].sum()) * len(lg),
                           "cost_max_abs_err": cost_err}
        log(f"detr finetune: {steps} steps, losses "
            f"{', '.join(f'{x:.4f}' for x in losses)}; main {sec:.2f} s, "
            f"the epoch {loop_s:.2f} s, {steps / loop_s:.2f} steps/s at "
            f"batch 2 on {card}; the steps' device work (forward to "
            f"update) {step_s[0]:.3f} s first, median "
            f"{record['train']['median_step_s']:.3f} s after; launches "
            f"{counts}; the first batch's "
            f"{record['train']['matches']} matches over {len(lg)} layers "
            f"equal the CPU's (costs within {cost_err:.2e})")

        det, gt = (os.path.join(work, d) for d in ("det", "gt"))
        with FunctionTimes(detections, ("dump_detections",)) as dt:
            _, sec, dump_counts = counted_run(detections.main, [
                "dump", "--data-root", data, "--pretrained", pth,
                "--out-dir", det])
        # the dump's f32 DETR under inference_mode (no fused tail): one
        # epilogue launch a site of each batch of 8
        n_img = len(EVAL_SIZES)
        expect_launches("detections dump", dump_counts, 0,
                        resnet_epilogues() * -(-n_img // 8))
        if len(os.listdir(det)) != n_img:
            fail(f"detections dump: {len(os.listdir(det))} files")
        dump_s = dt.s["dump_detections"]
        _, gt_s, counts = counted_run(detections.main, [
            "gt", "--data-root", data, "--out-dir", gt])
        expect_launches("detections gt", counts, 0)
        ap_gt = detections.main(["eval", "--data-root", data, "--det-dir",
                                 gt])
        ap = detections.main(["eval", "--data-root", data, "--det-dir", det])
        if not np.isfinite(ap).all() or not ((ap >= 0) & (ap <= 1)).all() \
                or float(ap_gt[ap_gt > 0].mean()) != 1.0:
            fail(f"detections eval: AP {ap}, GT AP {ap_gt}")
        record["dump"] = {"seconds": sec, "loop_s": dump_s,
                          "images_per_s": n_img / dump_s,
                          "launches": dump_counts,
                          "mAP": float(ap[ap > 0].mean()) if (ap > 0).any()
                          else 0.0, "gt_mAP": 1.0}
        log(f"detr finetune: dump of {n_img} images in {dump_s:.2f} s, "
            f"{n_img / dump_s:.2f} images/s (f32, batch 8; main "
            f"{sec:.2f} s); launches {dump_counts}; detection mAP "
            f"{record['dump']['mAP']:.4f} (random weights), the GT files' "
            f"1.0 ok")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    record["seconds"] = time.perf_counter() - t10
    log(f"phase 10 took {record['seconds']:.1f} s")
    return record


# ------------------------------------------------- parallelism on one card
# phase 11 runs the CLI with its dropout off (--feat-mask-type 1 and the
# CLIP adapters' rate at 0): each data rank draws its own dropout, so only
# such runs can equal one process's
P11_FLAGS = ["--feat-mask-type", "1"]
P11_TIMEOUT = 600
# the flagship's one training step (f32 towers): 12 CLIP blocks forward
# and backward, H/O/U twice (the generated pairs), the frozen-BN epilogues
# of DETR's and DINO's ResNet-50 (no K2 tail in f32)
P11_STEP_LAUNCHES = [12, 12, 0, 6, 98]
# the first update of two ranks against one process's: each leaf's
# clipped gradient relative to its scale and each group's norm before the
# clip. The ranks' forward parts from one process's as their eval does
# (p11_eval_cause); an H100 gave 4.5e-2 (bf16 towers) and 9.8e-4 (f32)
# for the CLI's runs and 1.9e-4 for the f32 flagship's step, where a
# gradient left unsummed, or summed twice, is off by its own size
P11_GRAD_TOL = {"bf16": 0.25, "f32": 1e-2, "step": 1e-3}


def no_dropout_config(mf):
    """``mf.make_model_config`` with the CLIP adapters' dropout at 0."""
    make = mf.make_model_config

    def config(cfg, device=None):
        m = make(cfg, device)
        return dataclasses.replace(m, clip=dataclasses.replace(
            m.clip, adapter_dropout=0.0))
    return config


class P11Probe:
    """Keeps what phase 11's runs compare beyond their results, while it
    is entered: of the optimizer's first step, each learning-rate group's
    gradient norm before the clip (``norms``: the global norm, over the
    data axis and the sharded rows) and the clipped gradients it applies
    (``grads``, numpy in the optimizer's leaf order), so that a gradient
    summed wrongly shows even where the clip rescales it; with ``mf``, the
    CLI eval loop's first step (``eval``: the step, its model, its feed
    and its outputs as numpy)."""

    def __init__(self, mf=None):
        self.mf = mf
        self.norms = self.grads = self.eval = None

    def __enter__(self):
        import numpy as np

        from hoigen_tpu_torch.engine import hoi_model as hm
        probe, mf = self, self.mf
        self.saved = hm.GroupedAdamW.step, getattr(mf, "make_eval_step",
                                                    None)
        opt_step, make_eval_step = self.saved

        def step(opt):
            if probe.norms is None:
                opt._fill_grads()
                probe.norms = [float(opt._norm(g))
                               for g in opt.param_groups]
            opt_step(opt)
            if probe.grads is None:
                probe.grads = [t.grad.detach().cpu().numpy().copy()
                               for g in opt.param_groups
                               for t in g["params"]]

        def make_probed(cfg, device=None):
            eval_step = make_eval_step(cfg, device)

            def probed(params, buffers, batch):
                out = eval_step(params, buffers, batch)
                if probe.eval is None:
                    probe.eval = {"step": eval_step, "model": (params,
                                                               buffers),
                                  # the graphed step hands its static
                                  # inputs (on the card) to its warm-up
                                  "batch": {k: np.array(v.cpu())
                                            if hasattr(v, "cpu")
                                            else np.array(v)
                                            for k, v in batch.items()},
                                  "out": {k: v.cpu().numpy()
                                          for k, v in out.items()}}
                return out
            return probed
        hm.GroupedAdamW.step = step
        if mf is not None:
            mf.make_eval_step = make_probed
        return self

    def __exit__(self, *exc):
        from hoigen_tpu_torch.engine import hoi_model as hm
        hm.GroupedAdamW.step = self.saved[0]
        if self.mf is not None:
            self.mf.make_eval_step = self.saved[1]


def p11_cli_runs(mf, argv, out, cache_out, modes, wrappers, resume=None,
                 probe=None):
    """``main`` in ``modes`` (train, eval, cache) from ``argv``, the
    launch counters set to 0 before each; --eval and --cache from the
    checkpoint under ``resume`` (None: ``out``, the training's); the
    training and --eval runs inside ``probe`` (a :class:`P11Probe`) where
    one is given. -> {mode: record}."""
    import contextlib

    import numpy as np

    from hoigen_tpu_torch.parallel import process_index
    runs = {}
    resume = resume or out
    extra = {"train": ["--output-dir", out],
             "eval": ["--output-dir", out, "--eval", "true", "--resume",
                      resume],
             "cache": ["--output-dir", cache_out, "--cache", "true",
                       "--resume", resume]}
    for mode in modes:
        with probe if probe is not None and mode != "cache" \
                else contextlib.nullcontext():
            result, seconds, counts, stage_s, _ = cli_run(
                mf, argv + extra[mode], wrappers)
        run = {"seconds": seconds, "launches": counts, "stages_s": stage_s}
        if mode == "train":
            run.update(steps=result.iteration, losses=list(result._losses),
                       graphs=result.step_fn.records()
                       if hasattr(result.step_fn, "records") else {})
        elif mode == "eval":
            run.update(ap=np.asarray(result["ap"], np.float64).tolist(),
                       mAP=result["mAP"])
        elif process_index() == 0:
            run["mat_digest"] = mat_digest(cache_out)
        runs[mode] = run
    return runs


def mat_digest(cache_dir):
    """(rows, sum) of each of the 80 official .mat files."""
    import numpy as np
    import scipy.io as sio
    out = []
    for obj in range(1, 81):
        m = sio.loadmat(os.path.join(cache_dir, f"detections_{obj:02d}.mat"))
        cells = [c for c in np.asarray(m["all_boxes"]).ravel() if c.size]
        out.append([int(sum(c.shape[0] for c in cells)),
                    float(sum(np.float64(c).sum() for c in cells))])
    return out


def train_flagship(seed, device):
    """The full-width training configuration of phase 6 with the
    language-aware term on, its model and global batch (batch 4), from
    ``seed``, the model on ``device``."""
    import torch

    from hoigen_tpu_torch.engine.hoi_model import HOIModelConfig, \
        init_hoi_model, make_example_batch
    from hoigen_tpu_torch.models.cache import random_caches
    from hoigen_tpu_torch.models.upt import UPTConfig
    cfg = HOIModelConfig(upt=UPTConfig(num_classes=117, num_shot=2,
                                       cache_model="gen_feat",
                                       use_pallas_cache=True,
                                       generate_feature=True, LA=True),
                         dtype="float32")
    caches = random_caches(117, 2, num_objects=80, seed=seed)
    params, buffers = init_hoi_model(torch.Generator().manual_seed(seed),
                                     cfg, caches, device=device)
    spread_detection_heads(params, seed)
    batch = make_example_batch(
        cfg, batch_size=4, detr_hw=(800, 1344), seed=seed,
        device_clip_stream=True,
        object_class_multihot=caches.object_class_multihot)
    return cfg, params, buffers, batch


def p11_step(mesh, seed, wrappers):
    """One training step of the flagship on ``mesh``, dropout off: each
    rank its rows of the global batch, the cache rows sharded over the
    model axis (``mesh`` None: one process, the whole batch). -> (loss,
    [launches by kernel], the H branch's rows here, {leaf: the clipped
    gradient it was updated with, numpy, the sharded leaves' gathered
    whole over the model group}, each group's norm before the clip)."""
    import numpy as np
    import torch

    from hoigen_tpu_torch.engine.hoi_model import make_optimizer, \
        make_train_step
    from hoigen_tpu_torch.engine.partition import trainable_leaves
    from hoigen_tpu_torch.parallel import gather_pyobj, is_cache_row_leaf, \
        shard_batch, shard_cache_rows
    from hoigen_tpu_torch.parallel.mesh import _CACHE_ROW_LEAVES
    cfg, params, buffers, batch = train_flagship(seed, "cuda")
    if mesh is not None:
        params, buffers = shard_cache_rows(mesh, params, buffers)
        batch = shard_batch(mesh, batch)
    opt = make_optimizer(mesh=mesh)(params)
    step = make_train_step(cfg, opt, mesh=mesh)
    for w in wrappers:
        w.launches = 0
    with P11Probe() as probe:
        loss = float(step(params, buffers, batch)["loss"])
    torch.cuda.synchronize()
    counts = [w.launches for w in wrappers]
    grads = {}
    for path, t in trainable_leaves(params):
        g = t.grad.cpu().numpy()
        if mesh is not None and mesh.n_model > 1 and is_cache_row_leaf(path):
            # the model group is every process on a (1, 2) mesh
            g = np.concatenate(gather_pyobj(g),
                               axis=_CACHE_ROW_LEAVES[path[-1]])
        grads["/".join(map(str, path))] = g
    return loss, counts, int(params["upt"]["adapter_H_w"].shape[0]), grads, \
        probe.norms


def p11_worker(spec_json):
    """One process of phase 11's gloo pair on ``cuda:0``: the CLI's
    training epoch of each variant (bf16 and f32 towers), and its --eval
    and --cache from the one-process run's checkpoint, then one training
    step on a (2, 1) and on a (1, 2) mesh. Writes its record to
    ``<out>/rank<k>.json``, the clipped gradients of each training run's
    first step and of each mesh step to ``<out>/grads_<run>_rank<k>.npz``
    and its first eval step's feed and outputs of each variant to
    ``<out>/eval0_<variant>_rank<k>.pkl``."""
    import pickle

    import numpy as np
    spec = json.loads(spec_json)
    rank = spec["rank"]
    out = spec["out"]
    os.environ.update(COORDINATOR_ADDRESS=f"localhost:{spec['port']}",
                      NUM_PROCESSES="2", PROCESS_ID=str(rank))
    sys.path.insert(0, str(ROOT))
    import torch

    from hoigen_tpu_torch.cli import main_finetune as mf
    from hoigen_tpu_torch.parallel import init_distributed, make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the kernels load from the parent's build under hoigen_tpu_torch/_build
    init_distributed(device="cuda", backend="gloo")
    _, wrappers = kernel_wrappers()
    mf.make_model_config = no_dropout_config(mf)
    os.chdir(spec["cwd"])
    t0 = time.perf_counter()
    record = {"rank": rank, "device": torch.cuda.current_device()}
    for name, v in spec["variants"].items():
        probe = P11Probe(mf)
        record[name] = p11_cli_runs(mf, v["argv"], v["out"], v["cache_out"],
                                    ("train", "eval", "cache"), wrappers,
                                    v["resume"], probe)
        record.setdefault("norms", {})[name] = probe.norms
        np.savez(os.path.join(out, f"grads_{name}_rank{rank}.npz"),
                 *probe.grads)
        with open(os.path.join(out, f"eval0_{name}_rank{rank}.pkl"),
                  "wb") as f:
            pickle.dump({k: probe.eval[k] for k in ("batch", "out")}, f)
        del probe
    for name, shape in (("dp", (2, 1)), ("tp", (1, 2))):
        loss, counts, rows, grads, norms = p11_step(make_mesh(*shape),
                                                    spec["seed"], wrappers)
        record[name] = {"loss": loss, "launches": counts, "h_rows": rows,
                        "norms": norms}
        np.savez(os.path.join(out, f"grads_{name}_rank{rank}.npz"), **grads)
        torch.cuda.empty_cache()
    record["seconds"] = time.perf_counter() - t0
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)


def grads_rel_diff(got, want):
    """The largest difference of two gradient sets (lists or dicts of
    arrays, leaf by leaf), each leaf's relative to its largest magnitude
    in ``want``. -> (difference, the leaf where it is)."""
    import numpy as np
    keys = list(want) if isinstance(want, dict) else range(len(want))
    if len(got) != len(want):
        fail(f"{len(got)} gradient leaves against {len(want)}")
    worst = (0.0, None)
    for k in keys:
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        if g.shape != w.shape:
            fail(f"gradient leaf {k}: shape {g.shape} against {w.shape}")
        d = float(np.abs(g - w).max(initial=0.0)) / max(
            float(np.abs(w).max(initial=0.0)), 1e-30)
        if not d <= worst[0]:
            worst = (d, k)
    return worst


def norms_rel_diff(got, want):
    """The largest relative difference of two lists of norms."""
    if len(got) != len(want):
        fail(f"{len(got)} gradient norms against {len(want)}")
    return max(abs(g - w) / max(abs(w), 1e-30) for g, w in zip(got, want))


def p11_eval_cause(name, probe, path):
    """Where a rank's eval outputs part from one process's: rank 0's first
    feed must be the one-process feed's first two rows, bit for bit, and
    the one-process step on that feed (batch 2, the global plane) must
    give rank 0's outputs bit for bit; the difference of one process's
    batch of 4, its first two rows, from rank 0's is then the batch's
    alone. -> record."""
    import pickle

    import numpy as np
    import torch
    with open(path, "rb") as f:
        r0 = pickle.load(f)
    one = probe.eval
    n = len(next(iter(r0["batch"].values())))
    for k, v in r0["batch"].items():
        if not np.array_equal(v, one["batch"][k][:n]):
            fail(f"phase 11b {name}: rank 0's first eval feed {k} is not "
                 f"one process's first {n} rows")
    with torch.no_grad():
        again = {k: v.cpu().numpy() for k, v in one["step"](
            *one["model"], r0["batch"]).items()}
    same = {k: np.array_equal(again[k], v) for k, v in r0["out"].items()}
    batch_diff = {k: float(np.abs(np.float64(one["out"][k][:n])
                                  - np.float64(v)).max())
                  for k, v in r0["out"].items()}
    rec = {"feed_rows_equal": True, "batch2_step_equals_rank": same,
           "batch4_rows_max_abs_diff": batch_diff}
    log(f"parallel {name}: rank 0's first eval feed is one process's first "
        f"{n} rows bit for bit; one process's step on it gives rank 0's "
        f"outputs bit for bit: {same}; one process's batch of 4 differs "
        f"from them in its first {n} rows by "
        + ", ".join(f"{k} {v:.3e}" for k, v in batch_diff.items()))
    if not all(same.values()):
        fail(f"phase 11b {name}: one process's eval step on rank 0's feed "
             f"does not give rank 0's outputs")
    return rec


def p11_compare(name, ranks, ref, steps, n_b, names, rtol, probe, out,
                grad_tol, epilogues):
    """Phase 11b's checks of one variant: each rank's launches (K1 and K2
    run in the DETR tower in bf16 only; ``epilogues`` frozen-BN epilogue
    launches a detector forward); the first step's loss (before
    any update: Adam turns rounding in near-zero gradients into steps of
    the learning rate, so later steps part) within ``rtol`` of one
    process's; the clipped gradients of the first update equal on both
    ranks and, leaf by leaf, within ``grad_tol`` of the leaf's scale of
    one process's (``probe``'s); from one checkpoint, both ranks' merged
    AP vectors equal and within rtol 1e-6 of one process's, the .mat
    files' row counts equal and their sums within ``rtol``, and rank 0's
    first eval step held against one process's (``p11_eval_cause``).
    -> record."""
    import numpy as np
    grads = []
    for r in range(2):
        with np.load(os.path.join(out, f"grads_{name}_rank{r}.npz")) as z:
            grads.append([z[f"arr_{i}"] for i in range(len(z.files))])
    if grads_rel_diff(grads[1], grads[0])[0] != 0.0 or \
            ranks[0]["norms"][name] != ranks[1]["norms"][name]:
        fail(f"phase 11b {name}: the ranks' first updates differ")
    grad_diff, grad_leaf = grads_rel_diff(grads[0], probe.grads)
    norm_diff = norms_rel_diff(ranks[0]["norms"][name], probe.norms)
    log(f"parallel {name}: the first update's clipped gradients and norms "
        f"equal on both ranks; {len(probe.grads)} leaves within "
        f"{grad_diff:.3e} of their scale of one process's (leaf "
        f"{grad_leaf}), the groups' norms before the clip "
        f"{ranks[0]['norms'][name]} within {norm_diff:.3e} relative")
    if not max(grad_diff, norm_diff) <= grad_tol:
        fail(f"phase 11b {name}: the first update's gradients differ from "
             f"one process's")
    cause = p11_eval_cause(name, probe,
                           os.path.join(out, f"eval0_{name}_rank0.pkl"))
    d = int(name == "bf16")
    expect = {"train": [(6 * d + 12) * steps, 12 * steps, d * steps,
                        3 * steps, epilogues * steps],
              "eval": [6 * d * n_b, 0, d * n_b, 3 * n_b, epilogues * n_b],
              "cache": [6 * d * n_b, 0, d * n_b, 3 * n_b, epilogues * n_b]}
    for r in ranks:
        cli = r[name]
        log(f"parallel {name}: gloo rank {r['rank']} on cuda:{r['device']}: "
            + "; ".join(f"{m} {cli[m]['seconds']:.2f} s, launches "
                        f"{dict(zip(names, cli[m]['launches']))}"
                        for m in ("train", "eval", "cache")))
        for m, want in expect.items():
            if cli[m]["launches"] != want:
                fail(f"phase 11b {name}: rank {r['rank']} {m} launches "
                     f"{cli[m]['launches']}, expected {want}")
        if cli["train"]["steps"] != steps:
            fail(f"phase 11b {name}: {cli['train']['steps']} steps, one "
                 f"process {steps}")
    if ranks[0][name]["eval"]["ap"] != ranks[1][name]["eval"]["ap"]:
        fail(f"phase 11b {name}: the ranks' merged AP vectors differ")
    ap, want = (np.asarray(x, np.float64) for x in (
        ranks[0][name]["eval"]["ap"], ref["eval"]["ap"]))
    got, want_d = (np.asarray(x, np.float64) for x in (
        ranks[0][name]["cache"]["mat_digest"], ref["cache"]["mat_digest"]))
    losses = np.asarray(ranks[0][name]["train"]["losses"])
    rec = {"ap_max_abs_diff": float(np.abs(ap - want).max()),
           "mAP": ranks[0][name]["eval"]["mAP"], "mAP_one": ref["eval"]["mAP"],
           "mat_rows": int(got[:, 0].sum()),
           "mat_count_diffs": int((got[:, 0] != want_d[:, 0]).sum()),
           "mat_sum_rel_diff": float((np.abs(got[:, 1] - want_d[:, 1])
                                      / np.maximum(np.abs(want_d[:, 1]),
                                                   1e-30)).max()),
           "loss_rel_diff": (np.abs(losses - ref["train"]["losses"])
                             / np.asarray(ref["train"]["losses"])).tolist(),
           "grad_rel_diff": grad_diff, "norm_rel_diff": norm_diff,
           "eval_cause": cause,
           "seconds": {m: ranks[0][name][m]["seconds"]
                       for m in ("train", "eval", "cache")},
           "seconds_one": {m: ref[m]["seconds"]
                           for m in ("train", "eval", "cache")}}
    log(f"parallel {name}: the merged AP vector within "
        f"{rec['ap_max_abs_diff']:.3e} of one process's (mAP {rec['mAP']:.6f}"
        f", one process {rec['mAP_one']:.6f}); .mat rows {rec['mat_rows']}, "
        f"{rec['mat_count_diffs']} objects' counts differ, sums within "
        f"{rec['mat_sum_rel_diff']:.3e} relative; the 4 steps' losses "
        f"within {', '.join(f'{x:.3e}' for x in rec['loss_rel_diff'])} "
        f"relative")
    if not rec["loss_rel_diff"][0] <= rtol:
        fail(f"phase 11b {name}: the first step's loss differs from one "
             f"process's")
    if not np.allclose(ap, want, rtol=1e-6, atol=1e-9):
        fail(f"phase 11b {name}: the AP vector differs from one process's")
    if rec["mat_count_diffs"] or not want_d[:, 0].sum() or \
            rec["mat_sum_rel_diff"] > rtol:
        fail(f"phase 11b {name}: the .mat files differ from one process's")
    return rec


def parallel_phase(args, card, work, ctx):
    """Phase 11: parallelism on one card, at phase 8's flags on phase 7's
    tree with dropout off. (a) The CLI's training epoch and --eval in a
    NCCL process group of one against the same runs without a group, bit
    for bit; ``--devices 2`` refused on this one-card machine. (b) Two
    processes on ``cuda:0`` over gloo (NCCL refuses two ranks on one
    device): the training epoch, --eval and --cache against one process,
    with the bf16 towers of phase 8 and with f32 towers (the random
    weights' APs are zero: the .mat files, rows of boxes and scores, carry
    the comparison), and the first update's gradients; and (c) one
    training step of phase 6's model with the language-aware term on, on
    a (1, 2) mesh, the cache rows sharded, and on a (2, 1) mesh, against
    one process on the same global batch: losses and clipped gradients.
    Returns the ``parallel_run`` record."""
    import subprocess

    import numpy as np
    import torch
    import torch.distributed as dist

    from hoigen_tpu_torch.cli import main_finetune as mf
    from hoigen_tpu_torch.parallel import init_distributed
    from hoigen_tpu_torch.parallel.distributed import free_port
    from hoigen_tpu_torch.utils.config import parse_config

    t11 = time.perf_counter()
    os.makedirs(work)
    cwd = os.getcwd()
    names, wrappers = kernel_wrappers()
    argv = ctx["argv"] + P11_FLAGS
    argv32 = argv + ["--dtype", "float32"]
    record = {"card": card, "flags": " ".join(CLI_FLAGS + P11_FLAGS)}
    saved = mf.make_model_config
    try:
        os.chdir(work)
        mf.make_model_config = no_dropout_config(mf)
        probes = {"bf16": P11Probe(mf), "f32": P11Probe(mf)}
        ref = p11_cli_runs(mf, argv, os.path.join(work, "one"),
                           os.path.join(work, "one_cache"),
                           ("train", "eval", "cache"), wrappers,
                           probe=probes["bf16"])
        init_distributed(f"localhost:{free_port()}", 1, 0, device="cuda")
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            fail(f"phase 11a: backend {dist.get_backend()}")
        try:
            nccl = p11_cli_runs(mf, argv, os.path.join(work, "nccl"),
                                os.path.join(work, "nccl_cache"),
                                ("train", "eval"), wrappers)
        finally:
            dist.destroy_process_group()
        ref32 = p11_cli_runs(mf, argv32, os.path.join(work, "one32"),
                             os.path.join(work, "one32_cache"),
                             ("train", "eval", "cache"), wrappers,
                             probe=probes["f32"])
    finally:
        mf.make_model_config = saved
        os.chdir(cwd)
    for k, key in (("train", "losses"), ("eval", "ap")):
        if nccl[k][key] != ref[k][key] or nccl[k]["launches"] != \
                ref[k]["launches"]:
            fail(f"phase 11a: NCCL world 1 {k} {key} differ from one "
                 f"process's")
    # the CLI's training over the NCCL group's mesh runs graphed, as one
    # process's does: one capture a batch shape, the other steps replays
    graphs = {k: (g["captures"], g["replays"])
              for k, g in nccl["train"]["graphs"].items()}
    if not graphs or sum(c + r for c, r in graphs.values()) != \
            nccl["train"]["steps"]:
        fail(f"phase 11a: NCCL world 1 training graphs {graphs} over "
             f"{nccl['train']['steps']} steps")
    record.update(one_process=ref, nccl_world_1=nccl, one_process_f32=ref32)
    log(f"parallel: NCCL at world size 1: losses "
        f"{', '.join(f'{x:.6f}' for x in nccl['train']['losses'])} and the "
        f"AP vector (mAP {nccl['eval']['mAP']:.6f}) bit for bit those of "
        f"the run without a process group ok; train "
        f"{nccl['train']['seconds']:.2f} s, eval {nccl['eval']['seconds']:.2f}"
        f" s (one process: {ref['train']['seconds']:.2f} s, "
        f"{ref['eval']['seconds']:.2f} s); the training graphed over the "
        f"mesh, (captures, replays) by batch shape {graphs}")

    try:
        mf.main(parse_config(argv + ["--devices", "2", "--output-dir",
                                     os.path.join(work, "devices2")]))
    except RuntimeError as e:
        if "need 2 CUDA devices; 1 are visible" not in str(e):
            raise
        log(f"parallel: --devices 2 refused: {e} ok")
        record["devices_2"] = str(e)
    else:
        fail("phase 11: --devices 2 ran on a one-card machine")

    torch.cuda.empty_cache()
    port = free_port()
    dp_out = os.path.join(work, "two")
    os.makedirs(dp_out)
    variants = {name: {"argv": a, "out": os.path.join(dp_out, name),
                       "cache_out": os.path.join(dp_out, name + "_cache"),
                       "resume": os.path.join(work, one)}
                for name, a, one in (("bf16", argv, "one"),
                                     ("f32", argv32, "one32"))}
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for rank in range(2):
            spec = json.dumps({"rank": rank, "port": port,
                               "variants": variants, "out": dp_out,
                               "cwd": work, "seed": args.seed})
            logs.append(open(os.path.join(work, f"rank{rank}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", "import sys, chip_smoke; "
                 "chip_smoke.p11_worker(sys.argv[1])", spec], cwd=str(ROOT),
                stdout=logs[-1], stderr=subprocess.STDOUT))
        for rank, p in enumerate(procs):
            try:
                rc = p.wait(timeout=P11_TIMEOUT)
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                with open(os.path.join(work, f"rank{rank}.log")) as f:
                    tail = f.read()[-4000:]
                fail(f"phase 11b: rank {rank} ended with {rc}:\n{tail}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    record["two_process_s"] = time.perf_counter() - t0
    ranks = []
    for rank in range(2):
        with open(os.path.join(dp_out, f"rank{rank}.json")) as f:
            ranks.append(json.load(f))
    record["two_processes"] = ranks
    steps, n_b = ref["train"]["steps"], -(-len(EVAL_SIZES) // args.batch)
    # a rank's batch of 2 takes other cuDNN and cuBLAS kernels than one
    # process's batch of 4, which round otherwise (p11_eval_cause holds
    # it: one process's step on rank 0's rows gives rank 0's outputs bit
    # for bit, and its batch of 4 differs from them), and the random
    # DETR's box head, spread by 30, multiplies that 30-fold in the boxes
    # and the pairs' features: two bf16 ulps with bf16 towers; with f32
    # towers (TF32 off) 1e-4, 30 times a few f32 roundings
    record["bf16"] = p11_compare("bf16", ranks, ref, steps, n_b, names,
                                 KERNEL_TOL / 2, probes["bf16"], dp_out,
                                 P11_GRAD_TOL["bf16"], ctx["epilogues"])
    record["f32"] = p11_compare(
        "f32", ranks, ref32, steps, n_b, names, 1e-4, probes["f32"], dp_out,
        P11_GRAD_TOL["f32"],
        epilogue_sites(mf.make_model_config(parse_config(argv32))))
    del probes
    torch.cuda.empty_cache()
    log(f"parallel: two gloo processes on one card, {record['two_process_s']:.1f}"
        f" s for both variants and the mesh steps ok")
    # the compared vectors stay out of the record
    for runs in [ref, nccl, ref32] + [r[v] for r in ranks
                                     for v in ("bf16", "f32")]:
        for run in runs.values():
            run.pop("ap", None)
            run.pop("mat_digest", None)

    # (c): the (2, 1) and (1, 2) steps against one process's on the whole
    # batch; the language-aware term on, which data rank 0 alone adds
    one_loss, one_counts, one_rows, one_grads, one_norms = p11_step(
        None, args.seed, wrappers)
    record["one_step_launches"] = one_counts
    dp, tp = ([r[k] for r in ranks] for k in ("dp", "tp"))
    k3 = names.index("cache_logits_fwd")
    for what, runs, rows in (("(2, 1)", dp, 234), ("(1, 2)", tp, 117),
                             ("one process", [{"launches": one_counts,
                                               "h_rows": one_rows}], 234)):
        for r in runs:
            if r["h_rows"] != rows or r["launches"] != P11_STEP_LAUNCHES:
                fail(f"phase 11c: a {what} rank holds {r['h_rows']} rows "
                     f"and launched {r['launches']}, expected {rows} and "
                     f"{P11_STEP_LAUNCHES}")
    grads = {}
    for k in ("dp", "tp"):
        for r in range(2):
            with np.load(os.path.join(dp_out, f"grads_{k}_rank{r}.npz")) \
                    as z:
                grads[k, r] = {n: z[n] for n in z.files}
    diffs = {"dp_ranks": grads_rel_diff(grads["dp", 1], grads["dp", 0]),
             "tp_ranks": grads_rel_diff(grads["tp", 1], grads["tp", 0]),
             "dp_one": grads_rel_diff(grads["dp", 0], one_grads),
             "tp_dp": grads_rel_diff(grads["tp", 0], grads["dp", 0])}
    losses = {"dp": [d["loss"] for d in dp], "tp": [t["loss"] for t in tp],
              "one": one_loss}
    norm_diff = max(norms_rel_diff(r["norms"], one_norms) for r in dp + tp)
    loss_diff = max(abs(t - one_loss) for t in losses["dp"] + losses["tp"])
    log(f"parallel: one training step with the language-aware term on, "
        f"losses (2, 1) {losses['dp']}, (1, 2) {losses['tp']}, one process "
        f"{one_loss} (within {loss_diff:.3e}); K3 launched "
        f"{tp[0]['launches'][k3]} times a (1, 2) rank on its 117 of the 234 "
        f"cache rows; the groups' norms before the clip {one_norms} (one "
        f"process), every rank's within {norm_diff:.3e} relative; clipped "
        f"gradients, the largest difference relative to its leaf's scale: "
        + "; ".join(f"{k} {v:.3e} ({leaf})" for k, (v, leaf) in diffs.items()))
    if diffs["dp_ranks"][0] or diffs["tp_ranks"][0]:
        fail("phase 11c: the ranks of one mesh hold different gradients")
    if not loss_diff < 1e-4 or not max(
            diffs["dp_one"][0], diffs["tp_dp"][0], norm_diff) <= \
            P11_GRAD_TOL["step"]:
        fail("phase 11c: the mesh steps differ from one process's")
    record.update(tp_loss=tp[0]["loss"], dp_loss=dp[0]["loss"],
                  one_loss=one_loss, step_loss_diff=loss_diff,
                  step_norms=one_norms, step_norm_rel_diff=norm_diff,
                  step_grad_rel_diff={k: v for k, (v, _) in diffs.items()})
    record["seconds"] = time.perf_counter() - t11
    log(f"phase 11 took {record['seconds']:.1f} s")
    return record


# ---------------------------------------------------------- the remainder
# OpenAI's RN101 (ModifiedResNet (3, 4, 23, 3) of width 64, 224 pixels, a
# 512-wide output): the generator's VAE takes 512-wide features (FEAT in
# both packages), which RN50's 1024-wide output is not
def rn101_config():
    import dataclasses as dc

    from hoigen_tpu_torch.tools.make_checkpoints import RN50
    return dc.replace(RN50, embed_dim=512, vision_layers=33,
                      rn_layers=(3, 4, 23, 3))


def listing_lines(text):
    return [line for line in text.splitlines()
            if line.startswith(("=> Action", "(", "saved "))]


def run_inference(inference, argv, device=None):
    """``inference.main(argv)`` with its stdout kept and its eval step
    timed. -> (listing lines, seconds, step seconds)."""
    import contextlib
    import io

    import torch

    from hoigen_tpu_torch.engine import hoi_model as hm
    make = hm.make_eval_step
    step_s = []

    def timed_make(cfg, device=None):
        step = make(cfg, device)

        def run(*a):
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*a)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            return out
        return run
    buf = io.StringIO()
    hm.make_eval_step = timed_make
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            inference.main(argv, device=device)
        seconds = time.perf_counter() - t0
    finally:
        hm.make_eval_step = make
    return listing_lines(buf.getvalue()), seconds, step_s[0]


def small_inference_config(cfg, device=None):
    """The inference CLI's small float32 configuration: the port's CPU
    tests' tiny model, every kernel gate closed."""
    from hoigen_tpu_torch.engine import hoi_model as hm
    from hoigen_tpu_torch.models.clip.config import CLIPConfig
    from hoigen_tpu_torch.models.detr.config import DETRConfig
    from hoigen_tpu_torch.models.proposals import ProposalConfig
    from hoigen_tpu_torch.models.upt import UPTConfig
    return hm.HOIModelConfig(
        clip=CLIPConfig(image_resolution=32, vision_layers=2,
                        vision_width=64, vision_patch_size=8,
                        transformer_layers=2, transformer_width=64,
                        adapter_layers=(0, 1), fused_attention=False),
        detr=DETRConfig(hidden_dim=64, nheads=2, enc_layers=2, dec_layers=2,
                        dim_feedforward=128, num_queries=12,
                        num_classes=81),
        upt=UPTConfig(num_classes=cfg.num_classes, num_shot=2,
                      clip_resolution=32, use_dino=False,
                      cache_model=cfg.cache_model,
                      proposals=ProposalConfig(max_instances=4),
                      max_gt_pairs=cfg.max_gt_pairs,
                      generate_feature=False))


def small_inference_card_and_cpu(work, data, seed):
    """The inference CLI at the small configuration on the card and on the
    CPU, from the same files, on the first image of phase 7's tree whose
    listing holds a pair: the listings line for line. -> record."""
    import functools

    from hoigen_tpu_torch.cli import inference
    from hoigen_tpu_torch.cli import main_finetune as mf
    from hoigen_tpu_torch.data import factory as factory_module
    from hoigen_tpu_torch.tools.make_checkpoints import write_checkpoints
    from hoigen_tpu_torch.utils.config import RunConfig

    small = small_inference_config(RunConfig())
    paths = write_checkpoints(os.path.join(work, "small_files"), small.clip,
                              small.detr, seed=seed, dino=False,
                              spread=100.0,
                              image_names=[f"HICO_train2015_{i:08d}.jpg"
                                           for i in range(len(EVAL_SIZES))])
    saved = (mf.make_model_config, factory_module.DataFactory,
             factory_module.DEFAULT_BUCKETS)
    mf.make_model_config = small_inference_config
    factory_module.DataFactory = functools.partial(
        saved[1], clip_resolution=32, transform_kwargs=SMALL_TRANSFORM)
    factory_module.DEFAULT_BUCKETS = SMALL_BUCKETS
    try:
        for index in range(len(EVAL_SIZES)):
            argv = ["--data-root", data, "--num-classes", "117",
                    "--dino", "false", "--generate-feature", "false",
                    "--clip-model-path", paths["clip"],
                    "--pretrained-detr", paths["detr"], "--file1",
                    paths["pairs"], "--index", str(index),
                    "--action-score-thresh", "0.0"]
            cpu = run_inference(inference, argv + [
                "--output-dir", os.path.join(work, "small_cpu")], "cpu")[0]
            if any(line.startswith("(") for line in cpu):
                break
        else:
            fail("inference small: no image of the tree gives a pair")
        card = run_inference(inference, argv + [
            "--output-dir", os.path.join(work, "small_cuda")], "cuda")[0]
    finally:
        (mf.make_model_config, factory_module.DataFactory,
         factory_module.DEFAULT_BUCKETS) = saved
    cpu = [line.replace("small_cpu", "<out>") for line in cpu]
    card = [line.replace("small_cuda", "<out>") for line in card]
    if card != cpu:
        fail("inference small: the listings differ between card and CPU:\n"
             + "\n".join(card[:10]) + "\n---\n" + "\n".join(cpu[:10]))
    n = sum(line.startswith("(") for line in card)
    log(f"remainder: inference at the small configuration, image {index}: "
        f"{len(card)} listing lines ({n} pairs) equal on card and CPU ok")
    return {"index": index, "lines": len(card), "pairs": n}


def rn_encodes(gen_work, gen_ctx, seed):
    """``prepare_data gt-features`` of one family with an RN50 CLIP file and
    ``main_vae`` of that family with an RN101 one, both written from
    ``seed``: no kernel launch, finite features and losses, the frozen
    CLIP bit-identical. -> record."""
    import pickle

    import torch

    from hoigen_tpu_torch.cli import main_vae, prepare_data
    from hoigen_tpu_torch.engine.partition import named_leaves
    from hoigen_tpu_torch.models import generator as G
    from hoigen_tpu_torch.tools.make_checkpoints import RN50, \
        clip_state_dict

    fam = GEN_FAMILIES[0]
    split, n = gen_ctx["splits"][fam]
    rec = {"family": fam, "crops": n}
    cwd = os.getcwd()
    try:
        os.chdir(gen_work)
        files = {}
        for name, cfg in (("rn50", RN50), ("rn101", rn101_config())):
            files[name] = os.path.join(gen_work, f"{name}.pt")
            torch.save(clip_state_dict(cfg, seed), files[name])
        out = os.path.join(gen_work, "gt_rn50.pickle")
        with FunctionTimes(prepare_data, ("produce_gt_features",)) as pt:
            _, sec, counts = counted_run(prepare_data.main, [
                "gt-features", "--split-json", split, "--clip-model",
                files["rn50"], "--out", out])
        expect_launches("gt-features RN50", counts, 0)
        with open(out, "rb") as f:
            feats = [v[0] for v in pickle.load(f).values() if v]
        if sum(len(v) for v in feats) != n or not all(
                torch.isfinite(torch.as_tensor(v)).all() and
                v.shape[1] == RN50.embed_dim for v in feats):
            fail(f"gt-features RN50: {sum(map(len, feats))} of {n}")
        loop_s = pt.s["produce_gt_features"]
        rec.update(gt_features_s=sec, producer_s=loop_s,
                   rn50_crops_per_s=n / loop_s)
        log(f"remainder: gt-features {fam} with RN50: {n} crops, "
            f"{RN50.embed_dim}-wide features, in {loop_s:.2f} s, "
            f"{n / loop_s:.0f} crops/s (host crops, RN50 at batch 64); "
            f"launches {counts}")

        snapshots = []

        def keep_clip(a, out):
            snapshots.append((out[0], {p: t.clone() for p, t in
                                       named_leaves(out[0])}))
        with Recorded(main_vae, "load_clip", keep_clip), \
                Recorded(G, "vae_step", lambda a, out: out.detach()) \
                as losses, \
                FunctionTimes(main_vae, ("encode_image",)) as vt:
            _, sec, counts = counted_run(main_vae.main, [
                "--data", f"{fam}_data", "--split-json", split,
                "--clip-model", files["rn101"], "--ckpt-dir", "ckpt_rn",
                "--epochs", "1", "--batch-size", str(GEN_BATCH),
                "--seed", str(seed)])
        expect_launches("main_vae RN101", counts, 0)
        vl = [float(x) for x in losses.calls]
        steps = n // GEN_BATCH
        if len(vl) != steps or not all(map(math.isfinite, vl)):
            fail(f"main_vae RN101: losses {vl} over {steps} steps")
        n_frozen = frozen_clip_check("main_vae RN101", snapshots)
        rec.update(main_vae_s=sec, steps=steps, losses=vl,
                   rn101_crops_per_s=steps * GEN_BATCH / vt.s["encode_image"],
                   frozen_tensors=n_frozen)
        log(f"remainder: main_vae {fam} with RN101: {steps} steps at batch "
            f"{GEN_BATCH}, losses {', '.join(f'{x:.5f}' for x in vl)}, "
            f"encodes {steps * GEN_BATCH / vt.s['encode_image']:.0f} "
            f"crops/s; {n_frozen} CLIP tensors bit-identical; launches "
            f"{counts}")
    finally:
        os.chdir(cwd)
    return rec


def small_rn_card_and_cpu(seed):
    """A small RN tower's encode on the card against the CPU's, from the
    same converted file: within 2e-4 of the features' scale."""
    import dataclasses as dc

    import torch

    from hoigen_tpu_torch.models.clip.convert import \
        torch_state_dict_to_params
    from hoigen_tpu_torch.models.clip.model import encode_image
    from hoigen_tpu_torch.tools.make_checkpoints import RN50, \
        clip_state_dict
    from hoigen_tpu_torch.engine.hoi_model import to_device
    cfg = dc.replace(RN50, rn_layers=(1, 1, 1, 1), vision_width=16,
                     vision_layers=4, embed_dim=64, image_resolution=64,
                     transformer_layers=1)
    params, cfg = torch_state_dict_to_params(clip_state_dict(cfg, seed))
    x = torch.randn((4, 3, 64, 64), generator=torch.Generator()
                    .manual_seed(seed))
    with torch.no_grad():
        want = encode_image(params, x, cfg)
        got = encode_image(to_device(params, "cuda"), x.cuda(), cfg)
    err = max(float((g.cpu() - w).abs().max() / w.abs().max())
              for g, w in zip(got, want))
    if not err <= 2e-4:
        fail(f"RN small: card against CPU {err:.3e}")
    log(f"remainder: a small RN tower's features on the card within "
        f"{err:.3e} of the CPU's (relative to their scale) ok")
    return err


def head_and_masks_card_and_cpu(seed):
    """The legacy interaction head at full width (hidden 256,
    representation 512, 117 classes, 15 + 15 slots) and generate_masks
    (30 boxes at 800 x 1344), card against CPU. -> (head error, mask
    seconds)."""
    import torch

    from hoigen_tpu_torch.engine.hoi_model import full_f32, to_device
    from hoigen_tpu_torch.models.interaction_head import \
        InteractionHeadConfig, init_interaction_head, \
        interaction_head_forward
    from hoigen_tpu_torch.ops.masks import generate_masks
    gen = torch.Generator().manual_seed(seed)
    cfg = InteractionHeadConfig()
    params = init_interaction_head(gen, cfg)
    b, s = 2, cfg.proposals.n_slots
    xy = torch.rand((b, s, 2), generator=gen) * 500
    boxes = torch.cat([xy, xy + 20 + torch.rand((b, s, 2), generator=gen)
                       * 300], -1)
    valid = torch.rand((b, s), generator=gen) < 0.8
    ins = (torch.randn((b, cfg.num_channels), generator=gen),
           torch.randn((b, s, cfg.hidden_state_size), generator=gen), boxes,
           torch.rand((b, s), generator=gen),
           torch.randint(0, 80, (b, s), generator=gen), valid,
           torch.tensor([[800.0, 1344.0], [800.0, 1200.0]]),
           (torch.rand((80, 117), generator=gen) < 0.1).float())
    with torch.no_grad(), full_f32():
        want = interaction_head_forward(params, *ins, cfg, training=False)
        got = interaction_head_forward(to_device(params, "cuda"),
                                       *(t.cuda() for t in ins), cfg,
                                       training=False)
    err = float((got[0].cpu() - want[0]).abs().max()
                / want[0].abs().max())
    if not err <= 2e-4 or not torch.equal(got[2].cpu(), want[2]) or \
            not torch.allclose(got[1].cpu(), want[1], rtol=1e-6, atol=1e-6):
        fail(f"interaction head: card against CPU {err:.3e}")
    mboxes = torch.cat([xy[0], xy[0] + 0.5 + torch.rand(
        (s, 2), generator=gen) * 400], -1)
    m_cpu = generate_masks(mboxes, 800, 1344)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m_card = generate_masks(mboxes.cuda(), 800, 1344)
    torch.cuda.synchronize()
    mask_s = time.perf_counter() - t0
    if not torch.equal(m_card.cpu(), m_cpu):
        fail("generate_masks: card and CPU differ")
    log(f"remainder: the interaction head at full width ({b} images, "
        f"{cfg.proposals.n_pairs} pairs, 117 classes) on the card within "
        f"{err:.3e} of the CPU's logits, priors and pair_valid equal; "
        f"generate_masks of {s} boxes at 800 x 1344 bit for bit ok")
    return err, mask_s


def profiling_check(model, step, batch, eval_images_per_s):
    """``engine/profiling.py`` on phase 5's graphed eval step ``step``
    (captured with tracing off: spans, no device ranges): five steps,
    their outputs on the host, under ``trace`` with the tracer on, written
    as a Chrome trace that holds the tracer's ``hoigen.graph.replay``
    ranges; the tracer's own trace and snapshot (a check, a staging and a
    replay a step); the steps' images/s beside phase 5's; the card's peak
    allocation. -> record."""
    import shutil
    import tempfile

    import torch

    from hoigen_tpu_torch.engine import profiling
    logdir = tempfile.mkdtemp(prefix="trace_")
    profiling.reset()
    profiling.enable("cuda" if torch.cuda.is_available() else None)
    t0 = time.perf_counter()
    with profiling.trace(logdir):
        for _ in range(5):
            step(*model, batch)["detection_scores"].cpu()
    seconds = time.perf_counter() - t0
    snap = profiling.snapshot()
    profiling.write(os.path.join(logdir, "program_trace.json"))
    profiling.disable()
    profiling.reset()
    path = os.path.join(logdir, "trace.json")
    size = os.path.getsize(path)
    with open(path) as f:
        replays = f.read().count('"hoigen.graph.replay"')
    counts = {k: snap["spans"].get(k, {}).get("count") for k in
              ("graph.check", "graph.stage", "graph.replay")}
    stats = torch.cuda.memory_stats()
    if not size or not replays or set(counts.values()) != {5} or \
            not os.path.getsize(os.path.join(logdir, "program_trace.json")) \
            or "allocated_bytes.all.peak" not in stats:
        fail(f"profiling: trace of {size} bytes with {replays} replay "
             f"ranges, spans {counts}, memory stats {stats}")
    b = batch["images"].shape[0]
    rec = {"trace_bytes": size, "images_per_s": 5 * b / seconds,
           "step_ms": seconds / 5 * 1e3, "spans": snap["spans"],
           "phase5_images_per_s": eval_images_per_s,
           "peak_allocated_gib": stats["allocated_bytes.all.peak"] / 2 ** 30}
    shutil.rmtree(logdir, ignore_errors=True)
    log(f"remainder: profiling: a trace of 5 eval steps, {size} bytes, "
        f"{replays} hoigen.graph.replay ranges; {rec['images_per_s']:.2f} "
        f"images/s under the profiler and the tracer (phase 5: "
        f"{eval_images_per_s:.2f}); peak allocation "
        f"{rec['peak_allocated_gib']:.2f} GiB ok")
    return rec


def remainder_phase(args, card, cli_ctx, gen_work, gen_ctx, profiling):
    """Phase 12: the inference CLI at full width from phase 8's files and
    checkpoint on phase 7's tree (default, --action K and --action K
    --failure, each with the counters set to 0), and at the small
    configuration on the card and on the CPU; RN CLIP files through
    ``prepare_data`` and ``main_vae``; the legacy interaction head and the
    box masks card against CPU; ``profiling`` (phase 5's, measured while
    its model was alive). Returns the ``remainder_run`` record."""
    import torch

    from hoigen_tpu_torch.cli import inference
    t12 = time.perf_counter()
    names, _ = kernel_wrappers()
    record = {"card": card, "profiling": profiling}
    work = os.path.dirname(cli_ctx["out"])
    vis = os.path.join(work, "vis")
    argv = cli_ctx["argv"] + ["--resume", cli_ctx["out"], "--output-dir",
                              vis, "--index", "0"]
    runs = record["inference"] = {}
    cwd = os.getcwd()
    try:
        os.chdir(work)
        # the default listing of every scored pair; then the first listed
        # action's pairs at or above, and below, its first pair's score
        k, thresh = None, "0.0"
        for mode in ("default", "action", "failure"):
            extra = ["--action-score-thresh", thresh] + ([] if mode ==
                                                         "default" else (
                ["--action", str(k)] + (["--failure"] if mode == "failure"
                                        else [])))
            (lines, seconds, step_s), _, counts = counted_run(
                run_inference, inference, argv + extra)
            if counts != dict(zip(names, (6, 0, 1, 3,
                                          cli_ctx["epilogues"]))):
                fail(f"inference {mode}: launches {counts}")
            if mode == "default":
                first = next((i for i, line in enumerate(lines)
                              if line.startswith("=> Action")), None)
                if first is None:
                    fail("inference: no pair was listed")
                from hoigen_tpu_torch.labels import HICO
                k = HICO.verbs_sentence.index(lines[first].split(": ", 1)[1])
                thresh = lines[first + 1].split("score: ")[1].split(",")[0]
                files = ["vis_000000.png", "vis_000000_boxes.png"]
            else:
                files = [f"vis_000000_action_{k:03d}"
                         f"{'_failure' if mode == 'failure' else ''}.png"]
            for f in files:
                if not os.path.getsize(os.path.join(vis, f)):
                    fail(f"inference {mode}: {f} is empty")
            runs[mode] = {"seconds": seconds, "step_ms": step_s * 1e3,
                          "launches": counts, "lines": len(lines),
                          "pairs": sum(x.startswith("(") for x in lines),
                          "files": files, "saved": lines[-1]}
            log(f"remainder: inference {mode}: main in {seconds:.2f} s, the "
                f"one-image eval step {step_s * 1e3:.2f} ms; launches "
                f"{counts}; {len(lines)} listing lines, the last: "
                f"{lines[-1]}")
            torch.cuda.empty_cache()
        record["inference_small"] = small_inference_card_and_cpu(
            work, cli_ctx["data"], args.seed)
    finally:
        os.chdir(cwd)
    record["rn"] = rn_encodes(gen_work, gen_ctx, args.seed)
    record["rn_small_err"] = small_rn_card_and_cpu(args.seed)
    record["head_err"], record["masks_s"] = \
        head_and_masks_card_and_cpu(args.seed)
    record["seconds"] = time.perf_counter() - t12
    log(f"phase 12 took {record['seconds']:.1f} s")
    return record


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

    log(f"phases 1 and 2 took {time.perf_counter() - t_start:.1f} s")

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
    t3 = time.perf_counter()
    records = check_kernels(model, batch, cfg, train_model, train_cfg,
                            clock_hz)
    log(f"phase 3 took {time.perf_counter() - t3:.1f} s")

    # phase 4: small input, card against CPU
    t4 = time.perf_counter()
    small_reference_check(args.seed)
    log(f"phase 4 took {time.perf_counter() - t4:.1f} s")

    # phase 5: the main path
    t5 = time.perf_counter()
    counts, times, out, gstep = main_path(model, batch, cfg, args.warmup,
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
    busy_ms = report_profile(
        "main path", profile_steps(lambda: gstep(*model, batch),
                                   args.profile_steps),
        args.profile_steps, mean_ms)
    log(f"phase 5 took {time.perf_counter() - t5:.1f} s")
    # phase 5b: the graphed step against the eager step
    graph_run = graph_phase(model, batch, cfg, args, card, gstep)
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
    train_graphs = trainer.step_fn.records()
    if [(r["captures"], r["replays"]) for r in train_graphs.values()] != \
            [(1, n_run - 1)]:
        fail(f"train path: graphs {train_graphs}")
    log(f"train path: one graph, {n_run - 1} replays: "
        f"{next(iter(train_graphs.values()))}")
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
    # phase 6b: the graphed training step against the eager step
    train_graph_run = train_graph_phase(train_model, train_batch, train_cfg,
                                        args, card)
    # phase 6c: the mesh training steps, graphed with NCCL inside
    mesh_graph_run = mesh_graph_phase(train_model, train_batch, train_cfg,
                                      args, card)
    # phase 6d: across cards, where the machine has two or more
    if torch.cuda.device_count() >= 2:
        mesh_graph_run["cards"] = multi_card_phase(card)

    # phase 7: the HICO-DET evaluation from disk
    eval_run = eval_from_disk_phase(model, cfg, args, card)
    # phase 12's profiling check, on phase 5's eval step while it is here
    profiling = profiling_check(model, gstep, batch, images_per_s)

    # phase 8: the CLI end to end
    del model, train_model, trainer, gstep
    torch.cuda.empty_cache()
    import shutil
    import tempfile
    scratch = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        cli_ctx, gen_ctx = {}, {}
        cli = cli_phase(args, card, os.path.join(scratch, "cli"), cli_ctx)
        # phase 9: the generator pipeline; phase 10: the DETR offline
        # finetune
        gen_work = os.path.join(scratch, "generator")
        generator_run = generator_phase(args, card, gen_work, gen_ctx)
        detr_run = detr_finetune_phase(args, card)
        # phase 11: parallelism on one card; phase 12: the remainder
        parallel_run = parallel_phase(
            args, card, os.path.join(scratch, "parallel"), cli_ctx)
        remainder_run = remainder_phase(args, card, cli_ctx, gen_work,
                                        gen_ctx, profiling)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    # K1's launches in phase 9's runs, on the record of their batch: the
    # VAE encodes 256 crops, prepare_data's clip_apply up to 64 (a last
    # batch holds the rest), the crop encoder 32
    gen_runs = generator_run["runs"]
    gen_shapes = {"attention_fwd_clip_f32_b256": ("main_vae",),
                  "attention_fwd_clip_f32_b64": ("gt_features",
                                                 "global_caches"),
                  "attention_fwd_clip_f32_b32": ("pair_embeddings",)}
    gen_launches = {name: {run: r["launches"]["attention_fwd"]
                           for run, r in gen_runs.items()
                           if run.startswith(prefixes)}
                    for name, prefixes in gen_shapes.items()}
    for name, by_run in gen_launches.items():
        launches[name] = sum(by_run.values())
    # phase 12's one-image steps and phase 11's runs, on the records of
    # their shapes: the inference CLI at batch 1 (117 classes); each gloo
    # rank's runs and (2, 1) step at batch 2: the DETR's K1 (bf16) and K2,
    # the CLIP tower's K1 and K4 (a training run launches them in pairs;
    # its other K1 are the DETR's), K3 over all rows; the (1, 2) step's
    # K3 on half the rows, its K1 and K4 at batch 4 as phase 6's, as the
    # one-process step of phase 11c
    inf_runs = remainder_run["inference"].values()
    ranks = parallel_run["two_processes"]
    k1, k4, k2, k3 = range(4)
    modes = ("train", "eval", "cache")
    cli_b2 = [r[v][m]["launches"] for r in ranks for v in ("bf16", "f32")
              for m in modes]
    train_b2 = [r[v]["train"]["launches"] for r in ranks
                for v in ("bf16", "f32")]
    dp_b2 = [r["dp"]["launches"] for r in ranks]
    tp = [r["tp"]["launches"] for r in ranks] + \
        [parallel_run["one_step_launches"]]
    launches.update({
        "attention_fwd_b1": sum(r["launches"]["attention_fwd"]
                                for r in inf_runs),
        "bottleneck_chain_fwd_b1": sum(
            r["launches"]["bottleneck_chain_fwd"] for r in inf_runs),
        "cache_logits_fwd_b1_c117": sum(r["launches"]["cache_logits_fwd"]
                                        for r in inf_runs),
        "attention_fwd_b2": sum(c[k1] for c in cli_b2)
        - sum(c[k4] for c in train_b2),
        "bottleneck_chain_fwd_b2": sum(c[k2] for c in cli_b2),
        "attention_fwd_clip_f32_b2": sum(c[k4] for c in train_b2)
        + sum(c[k1] for c in dp_b2),
        "attention_bwd_b2": sum(c[k4] for c in train_b2 + dp_b2),
        "cache_logits_fwd_b2_c117": sum(c[k3] for c in cli_b2 + dp_b2),
        "cache_logits_fwd_half_rows_c117": sum(c[k3] for c in tp[:2])})
    launches["attention_fwd_clip_f32"] += sum(c[k1] for c in tp)
    launches["attention_bwd"] += sum(c[k4] for c in tp)
    launches["cache_logits_fwd_c117"] += tp[2][k3]
    # phase 6c's mesh steps: phase 6's shapes, batch 4 and every cache row
    for mesh in ("(1, 1)", "(1, 2) stand-in"):
        for name, n in zip(("attention_fwd_clip_f32", "attention_bwd",
                            "cache_logits_fwd_c117"),
                           mesh_graph_run[mesh]["launches"]):
            launches[name] += n
    log(f"total {time.perf_counter() - t_start:.1f} s")

    for rec in records:
        # records off the main path (K2's layer2-4 tails) launched 0 times
        rec["launches"] = launches.get(rec["name"], 0)
        # each wrapper's launches in phase 8's runs of the CLI, on the
        # record of its main-path shape
        rec["launches_cli"] = {mode: run["launches"].get(rec["name"], 0)
                               for mode, run in cli["runs"].items()}
        # and in phase 9's runs at its shape (every other kernel and
        # shape launched 0 times there), and phase 10's (the dump's
        # epilogues)
        kernel = next(k for k in ("attention_fwd", "attention_bwd",
                                  "bottleneck_chain_fwd", "cache_logits_fwd",
                                  "conv_epilogue")
                      if rec["name"].startswith(k[:12]))
        rec["launches_generator"] = gen_launches.get(rec["name"], {})
        rec["launches_detr_finetune"] = {
            run: detr_run[run]["launches"][kernel]
            for run in ("train", "dump")}
        if rec["source"].endswith("fused_resnet.cu"):
            # {kernel: (registers, spill store bytes, spill load bytes)}
            rec["ptxas"] = ptxas.get("fused_resnet", {})
    line = {"kernels": records, "to_port": [],
            "eval_step": eval_step, "graph_run": graph_run,
            "train_step": {"batch": args.batch, "steps": len(tms),
                           "mean_ms": tmean, "median_ms": tmedian,
                           "q1_ms": tq1, "q3_ms": tq3,
                           "images_per_s": timages, "device_busy_ms": tbusy,
                           "first_loss": losses[0], "last_loss": losses[-1],
                           "graphs": train_graphs, "card": card},
            "train_graph_run": train_graph_run,
            "mesh_graph_run": mesh_graph_run,
            "eval_run": eval_run, "cli_run": cli,
            "generator_run": generator_run, "detr_finetune_run": detr_run,
            "parallel_run": parallel_run, "remainder_run": remainder_run}
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
