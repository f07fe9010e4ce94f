"""Device time of K3's two launches (``csrc/cache_logits.cu``) over its
tile choices, at the HICO-DET eval shapes (C=600) and the training shapes
(C=117), batch 4, from random inputs made from a seed.

    python3 -m hoigen_tpu_torch.tools.sweep_cache_tiles [--iters 50]

For every block width of the phi launch (bn1), of the logits launch (bn2)
and ring depth (stages), prints the device time per call of each launch
(torch.profiler, the sum of the kernel's own device time over ``--iters``
calls) beside the choice of ``ops/pallas_cache.py::_gemm_plan``, and
checks that every choice gives the same logits bit for bit. Exits non-zero
without a CUDA card.
"""
import argparse
import itertools
import subprocess
import sys

import torch

from ..ops import _build, pallas_cache

SHAPES = {"eval C=600": (1800, 512, 1200, 600),
          "train C=117": (1800, 512, 234, 117)}


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
            and ev.self_device_time_total > 0}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("sweep_cache_tiles: no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    _build.build_all(("cache_logits",))
    gen = torch.Generator().manual_seed(args.seed)
    for label, (n, d, r, c) in SHAPES.items():
        x, w = (torch.randn(shape, generator=gen) for shape in ((n, d), (r, d)))
        x, w = (t / t.norm(dim=-1, keepdim=True) for t in (x, w))
        b = 0.1 * torch.randn(r, generator=gen) - 1.0
        lab = (torch.rand((r, c), generator=gen) < 0.05).float()
        s = lab.sum(0) + 1.0
        x, w, b, lab, s = (t.cuda() for t in (x, w, b, lab, s))
        w16, lt, s_pad = pallas_cache.kernel_operands(w, lab, s)
        lc, rp = lt.shape
        x16 = x.to(torch.bfloat16)
        phi = torch.empty((n, rp), dtype=torch.bfloat16, device="cuda")
        out = torch.empty((n, c), device="cuda")
        plan = (pallas_cache._gemm_plan(n, rp, d)[1],
                pallas_cache._gemm_plan(n, c, rp)[1],
                pallas_cache._gemm_plan(n, rp, d)[3])
        first = None
        for bn1, bn2, stages in itertools.product((32, 64, 128), (32, 64, 128),
                                                  (3, 4)):
            def call():
                _build.check(pallas_cache._launcher()(
                    x16.data_ptr(), w16.data_ptr(), b.data_ptr(),
                    lt.data_ptr(), s_pad.data_ptr(), phi.data_ptr(),
                    out.data_ptr(), n, d, r, rp, c, lc, bn1, bn2, stages,
                    torch.cuda.current_stream().cuda_stream),
                    "cache_logits")
            call()
            if first is None:
                first = out.clone()
            elif not torch.equal(out, first):
                sys.exit(f"{label} bn1 {bn1} bn2 {bn2} stages {stages}: "
                         "the logits differ from the first choice's")
            times = kernel_ms(call, args.iters)
            phi_ms = sum(v for k, v in times.items() if ", false>" in k)
            logits_ms = sum(v for k, v in times.items() if ", true>" in k)
            mark = "  <- _gemm_plan" if (bn1, bn2, stages) == plan else ""
            print(f"{label}: bn1 {bn1:3d} bn2 {bn2:3d} stages {stages}: "
                  f"phi {phi_ms:.4f} ms, logits {logits_ms:.4f} ms, both "
                  f"{phi_ms + logits_ms:.4f} ms{mark}", flush=True)


if __name__ == "__main__":
    main()
