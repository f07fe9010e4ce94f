"""Device time of the bottleneck-chain kernels (``csrc/fused_resnet.cu``) at
the eval step's shape, over K2's launch choices.

    python3 hoigen_tpu_torch/tools/sweep_fused_resnet.py [--tree DIR]
                                                          [--iters 20]

The shape is the DETR-R50 layer1 tail the eval step runs once a step: two
blocks, C 256, M 64, on a (4, 200, 336) bf16 plane, with weights and input
made from ``--seed`` (per-channel BN scales around 1 and nonzero biases).

1. The call (public API only, so that ``--tree`` can point at another
   checkout of the repository to compare two versions in one run): the
   device time per call of ``fused_bottleneck_chain`` (torch.profiler, the
   sum of the call's own kernels) and its CUDA-event time per call.
2. Plans, where the tree's ``ops/fused_resnet.py`` has ``_chain_plan``:
   the device time per call for every tile and weight-ring depth the
   fused route takes, beside the plan's own choice, and the layered route
   at the same shape; every fused choice must give the default's output
   bit for bit (each output is summed in the same order whatever the tile
   and ring), and the layered route's output is shown by its largest
   difference from it (another product instruction, another order).

Exits non-zero without a CUDA card.
"""
import argparse
import math
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
    """CUDA-event time per call over ``iters`` back-to-back calls."""
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(
        pathlib.Path(__file__).resolve().parents[2]),
        help="root of the checkout whose hoigen_tpu_torch is timed")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("sweep_fused_resnet: no CUDA card")
    sys.path.insert(0, str(pathlib.Path(args.tree).resolve()))
    from hoigen_tpu_torch.ops import _build
    from hoigen_tpu_torch.ops import fused_resnet as R
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(f"tree {args.tree}", flush=True)
    _build.build_all(("fused_resnet",))

    gen = torch.Generator().manual_seed(args.seed)
    b, h, w, c, m = 4, 200, 336, 256, 64

    def conv(o, i, k):
        return {"w": (torch.randn((o, i, k, k), generator=gen)
                      * math.sqrt(2 / (i * k * k))).cuda(),
                "scale": (1 + 0.1 * torch.randn(o, generator=gen)).cuda(),
                "bias": (0.1 * torch.randn(o, generator=gen)).cuda()}
    blocks = [{"conv1": conv(m, c, 1), "conv2": conv(m, m, 3),
               "conv3": conv(c, m, 1)} for _ in range(2)]
    x = torch.relu(torch.randn((b, h, w, c), generator=gen)).cuda() \
        .to(torch.bfloat16)

    # 1. the call
    with torch.no_grad():
        def call():
            return R.fused_bottleneck_chain(x, blocks)
        times = kernel_ms(call, args.iters)
        print(f"K2 (4, 200, 336, 256) bf16, 2 blocks: device "
              f"{sum(times.values()):.4f} ms a call, events "
              f"{event_ms(call, args.iters):.4f} ms a call; by kernel: "
              + "; ".join(f"{k[:60]} {v:.4f}" for k, v in
                          sorted(times.items(), key=lambda r: -r[1])),
              flush=True)
        if not hasattr(R, "_chain_plan"):
            return

        # 2. plans
        default = R._chain_plan(b, h, w, c, m, 2)
        want = R.fused_bottleneck_chain(x, blocks, plan=default)
        plans = []
        for tile in R._FUSED_TILES:
            for stages in R._FUSED_STAGES:
                try:
                    plans.append(R._chain_plan(b, h, w, c, m, 2, tile,
                                               stages))
                except ValueError:
                    pass
        plans.append(R._chain_plan(b, h, w, c, m, 1))     # layered route
        for plan in plans:
            def run(plan=plan):
                return R.fused_bottleneck_chain(x, blocks, plan=plan)
            got = run()
            diff = (got.float() - want.float()).abs().max().item()
            ms = sum(kernel_ms(run, args.iters).values())
            mark = " (the plan's choice)" if plan == default else ""
            print(f"  {plan.route} tile {plan.tile} stages {plan.stages} "
                  f"smem {plan.smem} threads {plan.threads}: device "
                  f"{ms:.4f} ms a call, output differs by {diff:.3e}"
                  f"{mark}", flush=True)
            if plan.route == "fused" and not torch.equal(got, want):
                sys.exit(f"sweep_fused_resnet: {plan} differs from "
                         f"{default}")


if __name__ == "__main__":
    main()
