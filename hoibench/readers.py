"""What the metric readers (``metrics/<metric>.py``) share: the window's
counts, spans, traced kernels and the yardstick's bounds. A reader takes
the runs of a cell (one a process; the worst is reported where they
differ) and returns None where it finds nothing to read."""
from . import roofline as RL, trace as TR


def span_ms(runs, name):
    """The mean of span ``name`` in ms, the worst run's, or None."""
    worst = None
    for run in runs:
        s = run.spans.get(name)
        if s:
            ms = 1e3 * sum(s) / len(s)
            worst = ms if worst is None else max(worst, ms)
    return worst


def images_per_s(runs):
    """The images the window completed over its length, the first
    process's (on a mesh each counts the global batch)."""
    run = runs[0]
    return run.images / run.window_s if run.window_s else None


def idle_share(runs):
    """1 - busy / traced window, in %, the worst run's."""
    shares = [100.0 * (1.0 - r.traced["busy_s"] / r.traced["window_s"])
              for r in runs if r.traced]
    return max(shares) if shares else None


def rows(run):
    """The images a step of the run's process takes."""
    return run.traffic["batch"]


def roofline(runs, match, bound_of_step):
    """Sum of the bound times over the sum of the device times of the
    kernels ``match`` accepts, in %, over every run's traced steps:
    ``bound_of_step(run, hw)`` is one launch's bound (s) at a step's
    padded (h, w), and each step launches the kernel the same number of
    times (the count traced over the steps traced)."""
    bound = seconds = 0.0
    for run in runs:
        if not run.traced or not run.traced_hw:
            continue
        n, s = TR.kernel_seconds(run.traced, match)
        if not n:
            continue
        per_step = n / len(run.traced_hw)
        bound += per_step * sum(bound_of_step(run, hw)
                                for hw in run.traced_hw)
        seconds += s
    return 100.0 * bound / seconds if seconds else None


def is_k1_f32(name):
    return "attn_fwd<float" in name


def is_k1_bf16(name):
    return "attn_fwd<" in name and "bfloat16" in name


def is_k4(name):
    return "attn_bwd" in name


def is_k2(name):
    return "chain2_fused" in name


def clip_shape(run):
    cfg = run.config["widths"]
    width = cfg["clip_vision_width"]
    grid = cfg["clip_resolution"] // cfg["clip_patch"]
    return rows(run), width // 64, grid * grid + 1, 64


def step_mfu(runs):
    """The least time of the window's steps at the peaks, over the window,
    in %, the worst run's."""
    shares = []
    for run in runs:
        if not run.window_hw or not run.window_s:
            continue
        w = run.config["widths"]
        least = sum(RL.least_seconds(RL.step_flops(
            rows(run), hw, run.training, w["num_classes"],
            w["num_shot"], w)) for hw in run.window_hw)
        shares.append(100.0 * least / run.window_s)
    return min(shares) if shares else None
