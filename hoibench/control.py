"""The control of a cell's comparison, and the faults it has to catch: the
reference put in the program's place and run in the precision below the
configuration's (``precision``: float32 products in TF32, the bf16
detector's and DINO's weights and convolution operands rounded through
fp8; ``tf32``: the float32 step alone), or with a fault planted, then
held against
the reference by the numbers that decide ``correct``. Each of these has
to come out not correct.

    python3 hoibench/control.py --workload <name> --seeds <n> [<n> ...]
                                [--fault {precision,tf32,half_batch,
                                          altered_answer}]

prints one JSON line a seed with the numbers and whether the cell's
limits pass them. It runs at the cell's own sizes on the card (the
benchmark's runs never run it); ``hoibench/tests/`` runs it small on the
CPU.
"""
import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FAULTS = ("precision", "tf32", "half_batch", "altered_answer")


def control_numbers(run, fault="precision"):
    """The numbers of ``fault`` standing in for the program in ``run``'s
    cell (``run.shrink`` as in a cell's run)."""
    import numpy as np

    from hoibench import cells as C, compare, model as M, spec, \
        traffic as T
    rc = M.run_config(run.config, run.traffic)
    cfg = M.model_config(run.config, rc, run.device, run.shrink)
    training = run.traffic["mode"] == "train"
    caches = T.make_caches(run.seed, run.config, cfg.upt.num_classes,
                           cfg.upt.num_shot)
    feed = spec.feed_of(run.traffic, ROOT)
    batches = feed.inputs(run, rc, cfg, M.Caches(**caches))
    low = fault == "precision"
    tf32 = fault in ("precision", "tf32")
    detr = (C.reference_detectors(run, cfg, batches, fp8_towers=True)
            if low else C.reference_detectors(run, cfg, batches))
    ref_detr = C.reference_detectors(run, cfg, batches, given=detr)
    prog_in, prog_detr = batches, detr
    if fault == "half_batch":
        half = batches[0]["images"].shape[0] // 2
        prog_in = [{k: v[:half] for k, v in b.items()} for b in batches]
        prog_detr = [tuple(x[:half] for x in d) for d in detr]
    precision = "high" if tf32 else None
    if training:
        run_seed = feed.run_seed(run, rc)
        prog = C.reference_train(run, cfg, prog_in, prog_detr, run_seed, rc,
                                 precision=precision, fp8_towers=low)
        ref = C.reference_train(run, cfg, batches, detr, run_seed, rc)
        numbers = compare.train_numbers(prog, ref)
    else:
        prog = C.reference_eval(run, cfg, prog_in, prog_detr,
                                precision=precision, fp8_towers=low)
        if fault == "half_batch":
            prog = [{k: np.concatenate([v, np.zeros_like(v)])
                     for k, v in o.items()} for o in prog]
        if fault == "altered_answer":
            prog[0]["detection_scores"][0] = 1.0 - \
                prog[0]["detection_scores"][0]
        ref = C.reference_eval(run, cfg, batches, detr)
        numbers = compare.eval_numbers(prog, ref)
    # the control's timed side is the reference itself: what it hands over
    # is what it ran
    numbers["handover_gap"] = 0.0
    numbers.update(compare.detector_numbers(detr, ref_detr, run.device))
    return numbers


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", choices=FAULTS, default="precision")
    args = p.parse_args(argv)
    import torch

    from hoibench import cells as C, compare, spec
    cell = spec.Cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("hoibench control: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        run = C.Run(seed=seed % (1 << 63), seconds=0, trace=False,
                    config=cell.config, traffic=cell.traffic,
                    device="cuda")
        numbers = control_numbers(run, args.fault)
        correct, compared = compare.judge(numbers, cell.limits)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fault": args.fault, "correct": correct,
                          "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
