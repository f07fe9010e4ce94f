"""Device time of the attention kernels (``csrc/attention.cu``): K1 over its
launch choices, and K1 and K4 as the port's callers call them.

    python3 hoigen_tpu_torch/tools/sweep_attention.py [--tree DIR] [--iters 50]

Shapes, batch 4, from random inputs made from ``--seed``: the CLIP tower's
training attention, (4, 12, 197, 64) f32 as (B, H, L, D) views of (B, L,
H, D) buffers (the layout ``models/clip/model.py::_mhsa_fused`` passes),
and the DETR encoder's, (4, 8, 1050, 32) bf16, contiguous, with a key bias
masking the last 10% of keys.

1. Calls (public API only, so that ``--tree`` can point at another
   checkout of the repository to compare two versions in one run): the
   device time per call (torch.profiler, the sum of the call's own
   kernels, copies included) and the CUDA-event time per call of
   ``fused_attention`` under no grad at both shapes, and of the backward
   through autograd at the CLIP shape (``torch.autograd.grad`` on a kept
   graph: K4 and whatever copies the call makes).
2. Plans, where the tree's ``attention_forward`` takes ``plan=``: K1's
   device time per call for every (query rows a block, ring depth) beside
   ``ops/attention.py::_attn_plan``'s choice; every choice must give the
   same output bit for bit.

Exits non-zero without a CUDA card.
"""
import argparse
import inspect
import itertools
import pathlib
import subprocess
import sys

import torch


def kernel_ms(fn, iters):
    """Device time per call of each kernel that ``fn`` launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {ev.key: ev.self_device_time_total / 1e3 / iters
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)
            and ev.self_device_time_total > 0}


def event_ms(fn, iters):
    """CUDA-event time per call over ``iters`` back-to-back calls (host
    time included where it exceeds the device's)."""
    for _ in range(3):
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


def report(label, fn, iters):
    times = kernel_ms(fn, iters)
    ev = event_ms(fn, iters)
    print(f"{label}: device {sum(times.values()):.4f} ms a call, events "
          f"{ev:.4f} ms a call; by kernel: " + "; ".join(
              f"{k[:70]} {v:.4f}" for k, v in
              sorted(times.items(), key=lambda r: -r[1])), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(
        pathlib.Path(__file__).resolve().parents[2]),
        help="root of the checkout whose hoigen_tpu_torch is timed")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("sweep_attention: no CUDA card")
    sys.path.insert(0, str(pathlib.Path(args.tree).resolve()))
    from hoigen_tpu_torch.ops import _build
    from hoigen_tpu_torch.ops import attention as A
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(f"tree {args.tree}", flush=True)
    _build.build_all(("attention",))

    gen = torch.Generator().manual_seed(args.seed)
    b = 4
    clip = [torch.randn((b, 197, 12, 64), generator=gen).cuda()
            .transpose(1, 2) for _ in range(4)]
    detr = [torch.randn((b, 8, 1050, 32), generator=gen).cuda()
            .to(torch.bfloat16) for _ in range(3)]
    bias = torch.zeros((b, 1050), device="cuda")
    bias[:, -105:] = -1e9

    # 1. calls
    with torch.no_grad():
        report("K1 CLIP f32 (4, 12, 197, 64), views",
               lambda: A.fused_attention(*clip[:3]), args.iters)
        report("K1 DETR bf16 (4, 8, 1050, 32), key bias",
               lambda: A.fused_attention(*detr, bias), args.iters)
    ins = [t.clone().requires_grad_() for t in clip[:3]]
    out = A.fused_attention(*ins)
    report("K4 CLIP f32 backward through autograd, views",
           lambda: torch.autograd.grad(out, ins, clip[3],
                                       retain_graph=True), args.iters)

    # 2. plans
    if "plan" not in inspect.signature(A.attention_forward).parameters:
        print("plans: this tree's attention_forward takes no plan",
              flush=True)
        return
    for label, (q, k, v, kb) in {"CLIP f32": (*clip[:3], None),
                                 "DETR bf16": (*detr, bias)}.items():
        chosen = A._attn_plan(b, q.shape[1], q.shape[2], k.shape[2],
                              q.shape[3], q.dtype)[:2]
        first = None
        for plan in itertools.product((64, 32), (2, 3)):
            with torch.no_grad():
                got = A.attention_forward(q, k, v, kb, plan=plan)
                if first is None:
                    first = got
                elif not torch.equal(got, first):
                    sys.exit(f"{label} plan {plan}: the output differs from "
                             "the first plan's")
                times = kernel_ms(
                    lambda: A.attention_forward(q, k, v, kb, plan=plan),
                    args.iters)
            mark = "  <- _attn_plan" if plan == chosen else ""
            print(f"plans {label}: bq {plan[0]} stages {plan[1]}: device "
                  f"{sum(times.values()):.4f} ms a call{mark}", flush=True)

if __name__ == "__main__":
    main()
