"""The run of one cell: set-up, the measured window, the traced steps and
the comparison, for the kinds of traffic the feeds here drive
(``feeds/<mode>_<feed>.py`` calls them):

- ``train``/``ready``: ``engine/train.py::Trainer.run_epoch`` over
  ``GraphedTrainStep(make_train_step(...))`` fed from a pool of host
  batches;
- ``train``/``jpeg``: the same fed by ``cli/main_finetune.py::
  batches_from_factory`` from JPEG files written at set-up;
- ``eval``/``ready``: ``graphed(make_eval_step(cfg))``, a closed loop
  whose outputs reach the host every batch, as ``eval_batches`` copies
  them.

Set-up drives the training step through its first three steps on the
window's own call and feed (the comparison follows them), then one step
of every other batch signature the window will see, and ends on the
signature the window starts with: every kernel is built and every graph
captured once before the window. Inside it the port's graphed training
step still captures again at each change of signature (a graph whose
weights another graph's replay updated is stale): that is the program's
cost at such traffic, and the window counts it.
"""
import contextlib
import dataclasses
import gc
import itertools
import time

import numpy as np
import torch

from . import compare, model as M, trace as TR, traffic as T

# steps profiled after the window of a --trace 1 run (a mix may set its
# own "traced_steps")
TRACED_STEPS = 6


def traced_steps(run):
    return run.traffic.get("traced_steps", TRACED_STEPS)


@dataclasses.dataclass
class Run:
    """What a cell's run hands to its metric readers and to the JSON
    line."""
    seed: int
    seconds: float
    trace: bool
    config: dict
    traffic: dict
    device: str = "cuda"
    shrink: object = None          # the CPU tests' smaller model
    # filled in by the run
    setup_s: float = 0.0
    window_s: float = 0.0
    steps: int = 0
    images: int = 0
    batch_ms: list = dataclasses.field(default_factory=list)
    spans: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)
    traced: dict = None
    traced_hw: list = dataclasses.field(default_factory=list)
    window_hw: list = dataclasses.field(default_factory=list)
    memory_peak_bytes: int = 0
    numbers: dict = dataclasses.field(default_factory=dict)
    notes: list = dataclasses.field(default_factory=list)
    training: bool = True


def _now():
    return time.perf_counter()


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device):
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def _free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def _hw(batch):
    return tuple(int(x) for x in batch["images"].shape[2:])


def _signature(batch):
    return tuple(sorted((k, tuple(v.shape), str(v.dtype))
                        for k, v in batch.items()))


def warm_ups(done, stream):
    """The set-up's steps after ``done``: one batch of each signature in
    ``stream`` (the window's batches, in order) that ``done`` has not run,
    then, where that leaves another signature captured last, the window's
    first batch, so that the window starts on the graph it replays."""
    seen = {_signature(b) for b in done}
    warm = []
    for b in stream:
        if _signature(b) not in seen:
            seen.add(_signature(b))
            warm.append(b)
    last = warm[-1] if warm else (done[-1] if done else None)
    if last is not None and _signature(last) != _signature(stream[0]):
        warm.append(stream[0])
    return warm


# ------------------------------------------------------------ the detector
class DetectorTap:
    """The detector's outputs as the timed step made them: the port's
    ``engine/hoi_model.py`` calls ``detr_forward`` by its module name, and
    the tap puts a wrapper there that copies ``pred_logits`` and
    ``pred_boxes`` into buffers of its own at each call. Inside a captured
    graph the two copies are recorded with the step, so each replay
    writes them again (two small device copies a step). The buffers are
    made at a signature's first call, which the graphed steps run eagerly
    before capturing it. ``take()``: host copies of the last step's."""

    def __init__(self):
        self.buffers = {}
        self.inner = None

    def __enter__(self):
        from hoigen_tpu_torch.engine import hoi_model
        self.inner = inner = hoi_model.detr_forward

        def tapped(*args, **kwargs):
            out = inner(*args, **kwargs)
            got = (out["pred_logits"], out["pred_boxes"])
            key = tuple(tuple(t.shape) for t in got)
            if key not in self.buffers:
                self.buffers[key] = tuple(torch.empty_like(t) for t in got)
            for buf, t in zip(self.buffers[key], got):
                buf.copy_(t)
            return out
        hoi_model.detr_forward = tapped
        return self

    def __exit__(self, *exc):
        from hoigen_tpu_torch.engine import hoi_model
        hoi_model.detr_forward = self.inner

    def take(self):
        (bufs,) = self.buffers.values()
        return tuple(t.to("cpu", torch.float32, copy=True).numpy()
                     for t in bufs)


def handed_over(timed, eager):
    """The detector outputs the reference takes: the timed step's logits
    and boxes with the eager pass's stages (:func:`detector_outputs`)
    beside them; where the timed step's do not have the batch's shape
    (``handover_gap`` reads that), the eager pass's."""
    return [(tuple(t) if all(a.shape == b.shape for a, b in zip(t, e))
             else tuple(e[:2])) + tuple(e[2:]) for t, e in zip(timed, eager)]


def detector_outputs(detr_params, cfg, batch, device, fns, given=None):
    """The detector on ``batch`` as the eval and training steps run it
    (``engine/hoi_model.py::_forward``), on the whole batch (the kernels
    round otherwise at another batch size), with its first residual
    layer's output (the fused K2 tail's) beside. ``fns``: (detr_forward,
    resnet50_forward_nhwc, device_normalize, pad_mask_from_sizes,
    full_f32) of the side that runs. ``given`` (the reference judging a
    side): that side's outputs, whose first-layer output the reference's
    backbone goes on from and whose encoder output its decoder runs on,
    stage by stage. -> (pred_logits, pred_boxes, the last decoder layer's
    output, the encoder's output: numpy; the first layer's output: a
    bf16 tensor on the host)."""
    forward, backbone, normalize, mask_from_sizes, full_f32 = fns
    dtype = getattr(torch, cfg.dtype)
    images = torch.as_tensor(batch["images"]).to(device)
    sizes = torch.as_tensor(batch["image_sizes"]).to(device)
    with torch.no_grad(), full_f32():
        mask = mask_from_sizes(sizes, images.shape[2], images.shape[3])
        x = normalize(images, dtype, pad_mask=mask)
        fused = cfg.detr.fused_resnet_tail if (
            x.is_cuda and x.dtype == torch.bfloat16
            and not cfg.detr.remat_backbone) else ()
        bb = detr_params["backbone"]
        layer1 = backbone({"stem": bb["stem"], "layers": bb["layers"][:1]},
                          x.permute(0, 2, 3, 1).contiguous(),
                          fused_tail=fused)
        if given is None:
            out = forward(detr_params, x, mask, cfg.detr)
            memory = out["memory"]
        else:
            memory = forward(detr_params, x, mask, cfg.detr,
                             layer1=given[4].to(device))["memory"]
            out = forward(detr_params, x, mask, cfg.detr, memory=torch.as_tensor(
                given[3]).to(device, dtype))
        return tuple(t.float().cpu().numpy() for t in (
            out["pred_logits"], out["pred_boxes"], out["hs"][-1],
            memory)) + (layer1.cpu(),)


def program_detector(params, cfg, batch, device):
    from hoigen_tpu_torch.engine.hoi_model import full_f32
    from hoigen_tpu_torch.models.detr.model import detr_forward
    from hoigen_tpu_torch.models.detr.resnet import resnet50_forward_nhwc
    from hoigen_tpu_torch.ops.pixels import device_normalize, \
        pad_mask_from_sizes
    return detector_outputs(
        params["detr"], cfg, batch, device,
        (detr_forward, resnet50_forward_nhwc, device_normalize,
         pad_mask_from_sizes, full_f32))


def reference_detector(params, rcfg, batch, device, given=None):
    from .reference.engine.hoi_model import full_f32
    from .reference.models.detr.model import detr_forward
    from .reference.models.detr.resnet import resnet50_forward_nhwc
    from .reference.ops.pixels import device_normalize, pad_mask_from_sizes
    return detector_outputs(
        params["detr"], rcfg, batch, device,
        (detr_forward, resnet50_forward_nhwc, device_normalize,
         pad_mask_from_sizes, full_f32), given)


def detr_dict(detr, device):
    """The detector outputs the steps take, on ``device``."""
    return {"pred_logits": torch.as_tensor(detr[0]).to(device),
            "pred_boxes": torch.as_tensor(detr[1]).to(device)}


# -------------------------------------------------------------- training
def trainable(params):
    from hoigen_tpu_torch.engine.partition import trainable_leaves
    return {p: t.detach().clone() for p, t in trainable_leaves(params)}


def optimizer_mu(opt, params, leaves_of):
    """{path: first moment} of every trainable leaf (the optimizer keeps
    them in its groups, in the leaves' order)."""
    by_id = {id(t): m for g in opt.param_groups
             for t, m in zip(g["params"], g["mu"])}
    return {p: by_id[id(t)].detach().clone()
            for p, t in leaves_of(params)}


def steps_per_epoch(config, traffic):
    return max(config["train_images"] // traffic["batch"], 1)


def make_trainer(run, rc, cfg, params, buffers):
    from hoigen_tpu_torch.engine.hoi_model import make_optimizer, \
        make_train_step
    from hoigen_tpu_torch.engine.train import Trainer
    opt = make_optimizer(rc.lr_vit, rc.lr_head, rc.weight_decay,
                         rc.lr_drop * steps_per_epoch(run.config,
                                                      run.traffic),
                         rc.clip_max_norm)(params)
    trainer = Trainer(make_train_step(cfg, opt, run.device), opt, params,
                      buffers, print_interval=10 ** 9, output_dir=None,
                      checkpoint_every_epoch=False)
    return trainer, opt


class StepProbe:
    """Wraps ``Trainer.step_fn``: a span around each call (the
    ``train_call`` layer), and the first steps' losses and detector
    outputs (``tap``)."""

    def __init__(self, fn, spans, tap, keep=3):
        self.fn, self.spans, self.tap, self.keep = fn, spans, tap, keep
        self.losses, self.detr = [], []

    def __call__(self, params, buffers, batch, generator=None):
        with self.spans.span("train_call"):
            out = self.fn(params, buffers, batch, generator)
        if len(self.losses) < self.keep:
            self.losses.append(out["loss"])
            self.detr.append(self.tap.take())
        return out


def train_setup(trainer, opt, params, first, warm, run_seed):
    """Drive the first three steps (the comparison's), then the steps of
    ``warm`` (:func:`warm_ups`) through ``trainer``. -> the program's state
    of the three: first moments after the first, the trainable leaves
    before and after."""
    from hoigen_tpu_torch.engine.partition import trainable_leaves
    state = {"p0": trainable(params)}

    def feed_first():
        for i, batch in enumerate(first):
            if i == 1:
                state["mu1"] = optimizer_mu(opt, params, trainable_leaves)
            yield batch
        state["p3"] = trainable(params)

    trainer.run_epoch(feed_first(), seed=run_seed)
    if warm:
        trainer.run_epoch(warm, seed=run_seed)
    return state


def captures(step):
    """The captures the port's graphed training step has made so far, over
    all its graphs (``GraphedTrainStep.records()``; none on the CPU)."""
    records = getattr(step, "records", None)
    return sum(r["captures"] for r in records().values()) if records else 0


def run_window(run, step_once):
    """Call ``step_once()`` (which returns the images it completed) until
    ``run.seconds`` have passed; the window closes when the last step that
    started inside it has completed."""
    t0 = _now()
    while _now() - t0 < run.seconds:
        run.images += step_once()
        run.steps += 1
    run.window_s = _now() - t0


def train_window(run, trainer, batches, run_seed, images_per_step):
    """One ``Trainer.run_epoch`` over ``batches`` for ``run.seconds``, as
    the CLI runs an epoch: the next batch is taken once the last step's
    loss is on the host, until the window's time has passed."""
    t0 = _now()

    def feed():
        last = t0
        for batch in batches:
            now = _now()
            if now - t0 >= run.seconds:
                return
            if run.steps:
                run.batch_ms.append((now - last) * 1e3)
            last = now
            run.steps += 1
            run.images += images_per_step
            run.window_hw.append(_hw(batch))
            yield batch

    trainer.run_epoch(feed(), seed=run_seed)
    run.window_s = _now() - t0


def train_ready(run, t_start):
    """The ``train``/``ready`` cell. -> what :func:`check_train`
    compares: the batches of the first three steps, the program's state
    after them and its detector's outputs on them."""
    spans = TR.Spans()
    rc, cfg, params, buffers = M.build_program(
        run.seed, run.config, run.traffic, run.device, run.shrink)
    caches = T.make_caches(run.seed, run.config, cfg.upt.num_classes,
                           cfg.upt.num_shot)
    pool, steps = T.make_batches(run.seed, run.config, run.traffic,
                                 cfg.upt.num_classes,
                                 caches=M.Caches(**caches),
                                 pixels=M.pixel_maker(run.device),
                                 clip_resolution=cfg.upt.clip_resolution)
    first = [pool[i] for i in steps[:3]]
    stream = [pool[i] for i in steps[3:] + steps[:3]]
    trainer, opt = make_trainer(run, rc, cfg, params, buffers)
    with DetectorTap() as tap:
        probe = StepProbe(trainer.step_fn, spans, tap)
        trainer.step_fn = probe
        run_seed = M.dropout_seed(run.seed)
        state = train_setup(trainer, opt, params, first,
                            warm_ups(first, stream), run_seed)
        _sync(run.device)
        spans.seconds.clear()
        run.setup_s = _now() - t_start

        cycle = itertools.cycle(stream)
        before = captures(probe.fn)
        train_window(run, trainer, cycle, run_seed, run.traffic["batch"])
        run.counters["graph_captures"] = captures(probe.fn) - before
        run.memory_peak_bytes = _peak(run.device)
        run.spans = {k: list(v) for k, v in spans.seconds.items()}
        if run.trace:
            traced = [next(cycle) for _ in range(traced_steps(run))]
            run.traced_hw = [_hw(b) for b in traced]
            run.traced = TR.profile(
                lambda: trainer.run_epoch(traced, seed=run_seed), run.device)
    state["losses"] = [float(x) for x in probe.losses]
    eager = [program_detector(params, cfg, b, run.device) for b in first]
    state["handover_gap"] = compare.handover_gap(probe.detr, eager)
    detr = handed_over(probe.detr, eager)
    del trainer, opt, probe, params, buffers
    _free(run.device)
    return cfg, first, state, detr, run_seed


def check_train(run, cfg, batches, state, prog_detr, run_seed):
    """The reference follows the first three steps from the same inputs,
    the detector's outputs handed over; its detector is checked by itself.
    -> {name: value}."""
    rc = M.run_config(run.config, run.traffic)
    ref = reference_train(run, cfg, batches, prog_detr, run_seed, rc)
    numbers = compare.train_numbers(state, ref)
    keep = compare.moving_leaves(compare.first_gradients(ref["mu1"]))
    run.notes += [
        "first-gradient gap, worst leaves: " + "; ".join(
            compare.worst_leaves(compare.first_gradients(state["mu1"]),
                                 compare.first_gradients(ref["mu1"]),
                                 keep)),
        "change gap, worst leaves: " + "; ".join(compare.worst_leaves(
            {p: state["p3"][p] - state["p0"][p] for p in keep},
            {p: ref["p3"][p] - ref["p0"][p] for p in keep}, keep)),
        f"losses: program {state['losses']} reference {ref['losses']}"]
    numbers["handover_gap"] = state["handover_gap"]
    numbers.update(compare.detector_numbers(
        prog_detr, reference_detectors(run, cfg, batches, given=prog_detr),
        run.device))
    return numbers


def reference_detectors(run, cfg, batches, fp8_towers=False, given=None):
    """The reference's detector on ``batches``, on its own or stage by
    stage after ``given`` (the detector outputs of the side it judges:
    ``detector_outputs``)."""
    rcfg, params, _ = M.build_reference(run.seed, run.config, cfg,
                                        run.device)
    with control_precision(params, fp8=fp8_towers):
        out = [reference_detector(params, rcfg, b, run.device,
                                  None if given is None else given[i])
               for i, b in enumerate(batches)]
    del params
    _free(run.device)
    return out


def reference_step(R, rcfg, params, buffers, opt, batch, detr, run_seed,
                   iteration, device):
    """One training step of the reference: the forward with the step's
    dropout draws (``Trainer.run_epoch``'s seed of the iteration), the
    focal sum over the positive count, one backward, one update. -> the
    loss."""
    gen = torch.Generator(device=device).manual_seed(
        M.step_generator_seed(run_seed, iteration))
    with R.full_f32():
        opt.zero_grad()
        loss, _ = R.train_loss(
            params, buffers,
            {k: torch.as_tensor(np.asarray(v)).to(device)
             for k, v in batch.items()}, rcfg, generator=gen,
            detr_out=detr_dict(detr, device))
        loss.backward()
        opt.step()
    return float(loss.detach())


def reference_train(run, cfg, batches, detr, run_seed, rc, precision=None,
                    fp8_towers=False):
    """The reference's three steps. -> losses, mu1, p0, p3."""
    from .reference.engine import hoi_model as R
    from .reference.engine.partition import trainable_leaves
    rcfg, params, buffers = M.build_reference(run.seed, run.config, cfg,
                                              run.device)
    opt = R.make_optimizer(rc.lr_vit, rc.lr_head, rc.weight_decay,
                           rc.lr_drop * steps_per_epoch(run.config,
                                                        run.traffic),
                           rc.clip_max_norm)(params)
    out = {"p0": {p: t.detach().clone()
                  for p, t in trainable_leaves(params)}, "losses": []}
    with control_precision(params, precision, fp8_towers):
        for i, batch in enumerate(batches):
            out["losses"].append(reference_step(
                R, rcfg, params, buffers, opt, batch, detr[i], run_seed, i,
                run.device))
            if i == 0:
                out["mu1"] = optimizer_mu(opt, params, trainable_leaves)
    out["p3"] = {p: t.detach().clone() for p, t in trainable_leaves(params)}
    del params, buffers, opt
    _free(run.device)
    return out


@contextlib.contextmanager
def control_precision(params, precision=None, fp8=False):
    """The reference in the control's lower precision while the block
    runs: its f32 products in ``precision`` ("high": TF32) and, with
    ``fp8``, its detector's and DINO's weights of two or more dimensions
    rounded through fp8 (e4m3, one scale a tensor) and every
    convolution's operands too: the steps below the configuration's f32
    and bf16."""
    from .reference.engine import hoi_model as R
    from .reference.engine.partition import named_leaves
    from .reference.models.detr import resnet
    if fp8:
        with torch.no_grad():
            for tower in ("detr", "dino"):
                for _, t in named_leaves(params.get(tower) or {}):
                    if t.dim() >= 2 and t.is_floating_point():
                        t.copy_(resnet.fp8_round(t))
    saved = R.F32_PRECISION, resnet.FP8_OPERANDS
    R.F32_PRECISION = precision or saved[0]
    resnet.FP8_OPERANDS = fp8
    try:
        yield
    finally:
        R.F32_PRECISION, resnet.FP8_OPERANDS = saved


# ------------------------------------------------------------ evaluation
def eval_ready(run, t_start):
    """The ``eval``/``ready`` cell. -> what :func:`check_eval` compares:
    the sampled batches, the window's outputs on them and the detector's
    outputs the timed step made on them."""
    from hoigen_tpu_torch.engine.cuda_graph import graphed
    from hoigen_tpu_torch.engine.hoi_model import make_eval_step
    spans = TR.Spans()
    rc, cfg, params, buffers = M.build_program(
        run.seed, run.config, run.traffic, run.device, run.shrink)
    pool, steps = T.make_batches(run.seed, run.config, run.traffic,
                                 cfg.upt.num_classes,
                                 pixels=M.pixel_maker(run.device),
                                 clip_resolution=cfg.upt.clip_resolution)
    step = graphed(make_eval_step(cfg, run.device))
    with DetectorTap() as tap:

        def one(i):
            with spans.span("eval_call"):
                out = step(params, buffers, pool[i])
            return {k: v.cpu().numpy() for k, v in out.items()}

        index = {id(b): i for i, b in enumerate(pool)}
        for b in warm_ups([], [pool[i] for i in steps]):
            one(index[id(b)])
        _sync(run.device)
        spans.seconds.clear()
        run.setup_s = _now() - t_start
        sample = sorted(np.random.default_rng([run.seed, 23]).choice(
            sorted(set(steps)), size=min(2, len(set(steps))),
            replace=False).tolist())
        last, timed = {}, {}
        order = itertools.cycle(steps)

        def one_batch():
            i = next(order)
            t0 = _now()
            out = one(i)
            run.batch_ms.append((_now() - t0) * 1e3)
            run.window_hw.append(_hw(pool[i]))
            if i in sample:
                last[i], timed[i] = out, tap.take()
            return run.traffic["batch"]

        run_window(run, one_batch)
        run.memory_peak_bytes = _peak(run.device)
        # a sampled batch the window never reached is run now: late, not
        # missing
        for i in sample:
            if i not in last:
                last[i] = one(i)
                timed[i] = tap.take()
        run.spans = {k: list(v) for k, v in spans.seconds.items()}
        if run.trace:
            idx = [next(order) for _ in range(traced_steps(run))]
            run.traced_hw = [_hw(pool[i]) for i in idx]

            def go():
                for i in idx:
                    one(i)
            run.traced = TR.profile(go, run.device)
    batches = [pool[i] for i in sample]
    eager = [program_detector(params, cfg, b, run.device) for b in batches]
    timed = [timed[i] for i in sample]
    del step, params, buffers
    _free(run.device)
    return (cfg, batches, [last[i] for i in sample],
            handed_over(timed, eager), compare.handover_gap(timed, eager))


def reference_eval(run, cfg, batches, detr, precision=None,
                   fp8_towers=False):
    from .reference.engine import hoi_model as R
    rcfg, params, buffers = M.build_reference(run.seed, run.config, cfg,
                                              run.device)
    step = R.make_eval_step(rcfg, run.device)
    with control_precision(params, precision, fp8_towers):
        outs = [{k: v.cpu().numpy() for k, v in step(
            params, buffers, b, detr_out=detr_dict(d, run.device)).items()}
            for b, d in zip(batches, detr)]
    del params, buffers, step
    _free(run.device)
    return outs


def check_eval(run, cfg, batches, prog_outs, prog_detr, handover):
    """The reference's eval step on the sampled batches from the
    detector's outputs on, its detector by itself. -> {name: value}."""
    numbers = compare.eval_numbers(
        prog_outs, reference_eval(run, cfg, batches, prog_detr))
    numbers["handover_gap"] = handover
    numbers.update(compare.detector_numbers(
        prog_detr, reference_detectors(run, cfg, batches, given=prog_detr),
        run.device))
    return numbers
