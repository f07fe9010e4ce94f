"""The ``train``/``jpeg`` mix: training fed from JPEG files through the
CLI's own input path (``DataFactory`` -> ``batches_from_factory``, its
loader threads) into ``Trainer.run_epoch``, epoch after epoch, as
``cli/main_finetune.py::_main`` trains.

Set-up writes a HICO-DET tree (the layout of
``hoigen_tpu_torch/tools/make_hicodet.py::write_hicodet``, whose writer
this is a frozen copy of) into a temporary directory: images of the
configuration's original sizes, smooth random fields saved at the mix's
JPEG quality (50 to 150 KB a file, as Flickr photos; noise would be
larger and slower to decode), 1 to 8 ground-truth pairs each. The
comparison also holds the first three batches the data layer built from
the files against the reference's own decoding of them
(``reference/data.py``), element for element.
"""
import itertools
import json
import os
import pathlib
import shutil
import tempfile

import numpy as np

from . import cells as C, compare, model as M, trace as TR, traffic as T

TABLES = pathlib.Path(__file__).resolve().parent / "tables"


def hico_tables():
    with open(TABLES / "hicodet.json") as f:
        return json.load(f)


def smooth_field(rng, w, h, cells=24):
    """A (h, w, 3) uint8 image: a coarse random field, bicubic-upsampled,
    with mild grain."""
    from PIL import Image
    cw, ch = max(2, w // cells), max(2, h // cells)
    coarse = rng.integers(0, 256, (ch, cw, 3), dtype=np.uint8)
    img = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BICUBIC),
                     np.int16)
    img = img + rng.integers(-12, 13, (h, w, 3), dtype=np.int16)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_tree(root, seed, config, traffic):
    """The train2015 partition of a HICO-DET tree under ``root``. ->
    the number of images."""
    from PIL import Image
    tables = hico_tables()
    corr = tables["correspondence"]
    rng = np.random.default_rng([seed, 31])
    n = traffic["images"]
    sizes = T.original_sizes(rng, n, config["orientations"],
                             config["size_jitter"])
    img_dir = os.path.join(root, "hico_20160224_det", "images", "train2015")
    os.makedirs(img_dir, exist_ok=True)
    lo, hi = traffic["gt_pairs"]
    names, annos = [], []
    for i, (w, h) in enumerate(sizes):
        name = f"HICO_train2015_{i:08d}.jpg"
        Image.fromarray(smooth_field(rng, w, h)).save(
            os.path.join(img_dir, name), quality=traffic["jpeg_quality"])
        names.append(name)
        anno = {"boxes_h": [], "boxes_o": [], "hoi": [], "verb": [],
                "object": []}
        for _ in range(int(rng.integers(lo, hi + 1))):
            for key in ("boxes_h", "boxes_o"):
                x0, y0 = rng.integers(0, w // 2), rng.integers(0, h // 2)
                x1 = rng.integers(x0 + w // 8, w + 1)
                y1 = rng.integers(y0 + h // 8, h + 1)
                anno[key].append([int(x0), int(y0), int(x1), int(y1)])
            hoi, obj, verb = corr[int(rng.integers(0, len(corr)))]
            anno["hoi"].append(hoi)
            anno["verb"].append(verb)
            anno["object"].append(obj)
        annos.append(anno)
    inst = {"annotation": annos, "filenames": names, "empty": [],
            "objects": tables["objects"], "verbs": tables["verbs"],
            "correspondence": corr, "size": [list(s) for s in sizes]}
    with open(os.path.join(root, "instances_train2015.json"), "w") as f:
        json.dump(inst, f)
    return n


def make_factory(root, rc):
    """The training factory as the CLI's ``_main`` builds it."""
    from hoigen_tpu_torch.data.factory import DataFactory
    return DataFactory(
        "hicodet", "train2015", root, training=True, zero_shot=rc.zs,
        zs_type=rc.zs_type, num_classes=rc.num_classes,
        max_gt_pairs=rc.max_gt_pairs, seed=rc.seed,
        host_clip_stream=rc.host_clip_stream)


def loader_batches(run, rc, n=3):
    """The first ``n`` batches of epoch 0 that the CLI's input path builds
    from a tree written for ``run.seed`` (the control's inputs)."""
    from hoigen_tpu_torch.cli.main_finetune import batches_from_factory
    root = tempfile.mkdtemp(prefix="hoibench-jpeg-")
    try:
        write_tree(root, run.seed, run.config, run.traffic)
        feed = batches_from_factory(make_factory(root, rc), rc.batch_size,
                                    rc, seed=rc.seed)
        out = [d for (d, _), _ in zip(feed, range(n))]
        feed.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def repad(batch, hw):
    """``batch`` padded (or cut) to the signature ``hw``: its pixels in the
    top-left corner of zeros, its sizes cut to fit."""
    images = np.asarray(batch["images"])
    out = np.zeros(images.shape[:2] + tuple(hw), images.dtype)
    h, w = min(hw[0], images.shape[2]), min(hw[1], images.shape[3])
    out[:, :, :h, :w] = images[:, :, :h, :w]
    sizes = np.minimum(np.asarray(batch["image_sizes"]),
                       np.asarray(hw, np.asarray(batch["image_sizes"]).dtype))
    return dict(batch, images=out, image_sizes=sizes)


def mix_signatures(run):
    """The padded shapes an epoch of the mix holds
    (``traffic.epoch_layout``), the most common first: the loader draws
    each batch's, and set-up warms them all up."""
    shares = T.signature_shares(run.config, run.traffic)
    main = max(shares, key=shares.get)
    return [main] + sorted(set(T.epoch_layout(
        shares, T.epoch_steps(run.config, run.traffic))) - {main})


def jpeg_warm_ups(run, first):
    """A step of each of the mix's signatures that ``first`` did not run,
    a loader batch re-padded to it, ending on the most common."""
    sigs = mix_signatures(run)
    seen = {C._hw(b) for b in first}
    warm = [repad(first[-1], hw) for hw in sigs[1:] + sigs[:1]
            if hw not in seen]
    if warm and C._hw(warm[-1]) != sigs[0]:
        warm.append(repad(first[-1], sigs[0]))
    return warm


def train_jpeg(run, t_start):
    """Set-up (the tree, the model, the loader, the first three steps, a
    step of each other signature of the mix: a loader batch re-padded),
    the window over epochs of the CLI's input path, the trace. -> what
    :func:`check_train_jpeg` compares, and the tree's directory (removed
    by it)."""
    from hoigen_tpu_torch.cli.main_finetune import batches_from_factory
    spans = TR.Spans()
    root = tempfile.mkdtemp(prefix="hoibench-jpeg-")
    write_tree(root, run.seed, run.config, run.traffic)
    rc, cfg, params, buffers = M.build_program(
        run.seed, run.config, run.traffic, run.device, run.shrink)
    factory = make_factory(root, rc)
    trainer, opt = C.make_trainer(run, rc, cfg, params, buffers)
    run_seed = rc.seed

    def epoch_feed(epoch):
        factory.set_epoch(epoch)
        return (d for d, _ in batches_from_factory(
            factory, rc.batch_size, rc, seed=rc.seed + epoch))

    def epochs():
        epoch = 0
        while True:
            feed = epoch_feed(epoch)
            try:
                yield from spans.wrap_iter("loader_wait", feed)
            finally:
                feed.close()
            epoch += 1

    with C.DetectorTap() as tap:
        probe = C.StepProbe(trainer.step_fn, spans, tap)
        trainer.step_fn = probe
        stream = epochs()
        first = [next(stream) for _ in range(3)]
        state = C.train_setup(trainer, opt, params, first,
                              jpeg_warm_ups(run, first), run_seed)
        C._sync(run.device)
        spans.seconds.clear()
        run.setup_s = C._now() - t_start
        before = C.captures(probe.fn)
        C.train_window(run, trainer, stream, run_seed, rc.batch_size)
        run.counters["graph_captures"] = C.captures(probe.fn) - before
        run.memory_peak_bytes = C._peak(run.device)
        run.spans = {k: list(v) for k, v in spans.seconds.items()}
        if run.trace:
            def traced():
                # the loader's waits inside the traced window
                for batch in itertools.islice(stream, C.traced_steps(run)):
                    run.traced_hw.append(C._hw(batch))
                    yield batch
            run.traced = TR.profile(
                lambda: trainer.run_epoch(traced(), seed=run_seed),
                run.device)
        stream.close()
    state["losses"] = [float(x) for x in probe.losses]
    eager = [C.program_detector(params, cfg, b, run.device) for b in first]
    state["handover_gap"] = compare.handover_gap(probe.detr, eager)
    detr = C.handed_over(probe.detr, eager)
    del trainer, opt, probe, params, buffers
    C._free(run.device)
    return cfg, first, state, detr, run_seed, root


def check_train_jpeg(run, cfg, batches, state, prog_detr, run_seed, root):
    """The first three batches against the reference's own decoding of
    the files (``data_mismatch``: differing elements, exact), then the
    training comparison of ``cells.check_train`` on them."""
    from .reference.data import TrainFiles, collate, epoch_batches
    try:
        rc = M.run_config(run.config, run.traffic)
        tables = hico_tables()
        files = TrainFiles(root, tables["unseen"][rc.zs_type]
                           if rc.zs else None, rc.seed)
        order = epoch_batches(len(files.keep), rc.batch_size, rc.seed)
        mismatch = 0
        for got, idx in zip(batches, order):
            want = collate([files.sample(int(i), 0) for i in idx],
                           rc.max_gt_pairs)
            for k, w in want.items():
                g = np.asarray(got[k])
                mismatch += (w.size if g.shape != w.shape
                             else int((g != w).sum()))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    numbers = C.check_train(run, cfg, batches, state, prog_detr, run_seed)
    numbers["data_mismatch"] = float(mismatch)
    return numbers
