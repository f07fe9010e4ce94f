"""The one traffic generator: batches drawn from ``--seed`` by a mix's
parameters (``traffic/<mix>.json``) and a configuration's image sizes
(``configs/<config>.json``).

Each image's original size is drawn from the configuration's orientation
shares, then sized by the port's transform plan (a copy of
``DualStreamTransform.plan``'s draws and ``_aspect_size``: training draws
a flip, a jitter and either a multi-scale resize or a resize, crop and
resize; evaluation resizes the min side to 800, the max side to 1333). A
batch is padded to the element-wise max of its images' buckets, as
``collate_batch`` and ``pick_bucket`` pad it.

Which padded shape (the batch's signature) a batch gets is the mix's, not
the seed's: :func:`signature_shares` works out each signature's share of
batches from the configuration's shares and the plan, and
:func:`make_batches` lays an epoch's steps out so that each signature
takes its share of them, spread evenly, the same for every seed. The seed
fixes every size within a signature, every pixel, box and label.
"""
import numpy as np

# the DETR stream's (h, w) buckets and the transform's scales, as the
# port's data/factory.py and data/transforms.py define them
BUCKETS = ((800, 1344), (1344, 800), (1088, 1088), (1344, 1344))
TRAIN_SCALES = (480, 512, 544, 576, 608, 640, 672, 704, 736, 768, 800)
CROP_RESIZE = (400, 500, 600)
CROP_RANGE = (384, 600)
EVAL_MIN_SIDE, MAX_SIDE = 800, 1333
CLIP_RESOLUTION = 224
MAX_GT = 32


def aspect_size(w, h, size, max_size):
    """(h, w) after resizing the min side to ``size`` with the max side
    capped at ``max_size`` (None: uncapped)."""
    if max_size is not None:
        mn, mx = float(min(w, h)), float(max(w, h))
        if mx / mn * size > max_size:
            size = int(round(max_size * mn / mx))
    if (w <= h and w == size) or (h <= w and h == size):
        return h, w
    if w < h:
        return int(size * h / w), size
    return size, int(size * w / h)


def out_hw(w0, h0, training, rng=None):
    """The DETR stream's (h, w) of one image of original size (w0, h0),
    drawing from ``rng`` in the transform plan's order."""
    if not training:
        return aspect_size(w0, h0, EVAL_MIN_SIDE, MAX_SIDE)
    rng.random()                       # flip
    rng.permutation(3)                 # jitter order
    for _ in range(3):
        rng.uniform(0.6, 1.4)          # jitter factors
    if rng.random() < 0.5:
        return aspect_size(w0, h0, int(rng.choice(TRAIN_SCALES)), MAX_SIDE)
    oh, ow = aspect_size(w0, h0, int(rng.choice(CROP_RESIZE)), None)
    lo, hi = CROP_RANGE
    cw = int(rng.integers(lo, min(ow, hi) + 1)) if ow > lo else ow
    ch = int(rng.integers(lo, min(oh, hi) + 1)) if oh > lo else oh
    rng.integers(0, oh - ch + 1)
    rng.integers(0, ow - cw + 1)
    return aspect_size(cw, ch, int(rng.choice(TRAIN_SCALES)), MAX_SIDE)


def pick_bucket(h, w, buckets=None):
    buckets = BUCKETS if buckets is None else buckets
    fitting = [b for b in buckets if b[0] >= h and b[1] >= w]
    if not fitting:
        return max(buckets, key=lambda b: b[0] * b[1])
    return min(fitting, key=lambda b: b[0] * b[1])


def bucket_index(h, w):
    """:func:`pick_bucket` over arrays: the index in ``BUCKETS`` of each
    (h, w)'s bucket."""
    area = np.asarray([bh * bw for bh, bw in BUCKETS], np.float64)
    fit = np.stack([(h <= bh) & (w <= bw) for bh, bw in BUCKETS], -1)
    best = np.argmin(np.where(fit, area, np.inf), -1)
    return np.where(fit.any(-1), best, int(np.argmax(area)))


def padded_hw(hws, buckets=None):
    """The batch's padded (H, W): the element-wise max of its buckets."""
    hb = wb = 0
    for h, w in hws:
        bh, bw = pick_bucket(h, w, buckets)
        hb, wb = max(hb, bh), max(wb, bw)
    return hb, wb


def original_wh(rng, n, orientations, jitter):
    """n original (w, h) sizes, as two int arrays: an orientation by its
    share, each side scaled by a factor drawn from [1 - jitter,
    1 + jitter]."""
    shares = np.asarray([o[0] for o in orientations], np.float64)
    kinds = rng.choice(len(orientations), size=n, p=shares / shares.sum())
    f = rng.uniform(1 - jitter, 1 + jitter, size=(n, 2))
    base = np.asarray([o[1:3] for o in orientations], np.float64)[kinds]
    wh = np.maximum(32, np.round(base * f)).astype(np.int64)
    return wh[:, 0], wh[:, 1]


def original_sizes(rng, n, orientations, jitter):
    """n (w, h) original sizes (:func:`original_wh`) as a list."""
    w, h = original_wh(rng, n, orientations, jitter)
    return [(int(a), int(b)) for a, b in zip(w, h)]


def aspect_sizes(w, h, size, max_size):
    """:func:`aspect_size` over arrays: (h, w) arrays."""
    w, h = w.astype(np.float64), h.astype(np.float64)
    size = np.broadcast_to(np.asarray(size, np.int64), w.shape)
    if max_size is not None:
        mn, mx = np.minimum(w, h), np.maximum(w, h)
        size = np.where(mx / mn * size > max_size,
                        np.round(max_size * mn / mx), size).astype(np.int64)
    keep = ((w <= h) & (w == size)) | ((h <= w) & (h == size))
    oh = np.where(w < h, np.trunc(size * h / w), size)
    ow = np.where(w < h, size, np.trunc(size * w / h))
    return (np.where(keep, h, oh).astype(np.int64),
            np.where(keep, w, ow).astype(np.int64))


def out_hws(rng, w0, h0, training):
    """:func:`out_hw` over arrays of original sizes, each draw of the plan
    made for all images at once (the same law, another order of draws)."""
    if not training:
        return aspect_sizes(w0, h0, EVAL_MIN_SIDE, MAX_SIDE)
    n = len(w0)
    multi = rng.random(n) < 0.5
    ah, aw = aspect_sizes(w0, h0, rng.choice(TRAIN_SCALES, n), MAX_SIDE)
    oh, ow = aspect_sizes(w0, h0, rng.choice(CROP_RESIZE, n), None)
    lo, hi = CROP_RANGE
    cw = np.where(ow > lo, rng.integers(lo, np.maximum(
        np.minimum(ow, hi), lo) + 1), ow)
    ch = np.where(oh > lo, rng.integers(lo, np.maximum(
        np.minimum(oh, hi), lo) + 1), oh)
    bh, bw = aspect_sizes(cw, ch, rng.choice(TRAIN_SCALES, n), MAX_SIDE)
    return np.where(multi, ah, bh), np.where(multi, aw, bw)


def signature_shares(config, traffic, draws=1 << 18):
    """{padded (H, W): its share of the mix's batches}. Each image's
    bucket share comes from ``draws`` images drawn by the plan (from a
    fixed stream: the shares are the mix's and the configuration's, the
    same for every seed); a batch of ``traffic["batch"]`` independent
    images then pads to the element-wise max of the buckets it holds, so
    the share of each set of buckets follows exactly (inclusion and
    exclusion over the sets)."""
    rng = np.random.default_rng([draws, 29])
    w0, h0 = original_wh(rng, draws, config["orientations"],
                         config["size_jitter"])
    h, w = out_hws(rng, w0, h0, traffic["mode"] == "train")
    q = {b: float(np.mean(bucket_index(h, w) == i))
         for i, b in enumerate(BUCKETS)}
    used = sorted(b for b in q if q[b] > 0)
    n = traffic["batch"]
    shares = {}
    for mask in range(1, 1 << len(used)):
        subset = [used[i] for i in range(len(used)) if mask >> i & 1]
        exact = 0.0
        for sub in range(1, 1 << len(subset)):
            part = [subset[i] for i in range(len(subset)) if sub >> i & 1]
            exact += (-1) ** (len(subset) - len(part)) * sum(
                q[b] for b in part) ** n
        hw = (max(b[0] for b in subset), max(b[1] for b in subset))
        shares[hw] = shares.get(hw, 0.0) + exact
    return {k: v for k, v in shares.items() if v > 0}


def epoch_layout(shares, steps):
    """The signature of each of an epoch's ``steps``: each signature but
    the most common as many times as its share of the steps rounds to,
    spread evenly (the first at half its spacing), the most common in
    every step left."""
    main = max(shares, key=shares.get)
    layout = [main] * steps
    for sig, share in sorted(shares.items(), key=lambda kv: -kv[1]):
        k = int(round(share * steps)) if sig != main else 0
        for j in range(k):
            i = int((j + 0.5) * steps / k)
            while layout[i % steps] != main:
                i += 1
            layout[i % steps] = sig
    return layout


def gt_pairs(rng, n_pairs, object_verbs, num_classes):
    """Ground-truth pairs of one image: normalised cxcywh human and object
    boxes inside the image, verb ids valid for a drawn object."""
    objs = [o for o, vs in enumerate(object_verbs) if vs]
    boxes = []
    for _ in range(2):
        c = rng.uniform(0.2, 0.8, size=(n_pairs, 2))
        s = rng.uniform(0.1, 0.4, size=(n_pairs, 2))
        boxes.append(np.concatenate([c, s], 1).astype(np.float32))
    obj = rng.choice(objs, size=n_pairs)
    verbs = np.asarray([rng.choice(object_verbs[o]) for o in obj])
    return boxes[0], boxes[1], np.minimum(verbs, num_classes - 1)


def fits(bucket, hw):
    return bucket[0] <= hw[0] and bucket[1] <= hw[1]


def batch_plan(rng, config, traffic, training, want):
    """The sizes of one batch that pads to ``want``: (original (w, h),
    DETR-stream (h, w)) a row. Images are drawn by the plan, a batch's
    worth at a time, and those whose bucket does not fit in ``want`` are
    passed over; a batch whose padding falls short of ``want`` is drawn
    again: the law of the mix's batches of that signature."""
    b = traffic["batch"]
    for _ in range(1000):
        rows = []
        while len(rows) < b:
            for wh in original_sizes(rng, b, config["orientations"],
                                     config["size_jitter"]):
                hw = out_hw(*wh, training, rng)
                if fits(pick_bucket(*hw), want) and len(rows) < b:
                    rows.append((wh, hw))
        if padded_hw([hw for _, hw in rows]) == want:
            return [wh for wh, _ in rows], [hw for _, hw in rows]
    raise ValueError(f"no batch of the mix pads to {want}")


def epoch_steps(config, traffic):
    """An epoch's steps: the configuration's training images over the
    mix's batch."""
    return max(config["train_images"] // traffic["batch"], 1)


def make_batches(seed, config, traffic, num_classes, caches=None,
                 pixels=None, clip_resolution=CLIP_RESOLUTION):
    """The mix's host batches (dicts of numpy arrays as
    ``batches_from_factory`` yields them: uint8 pixels with their sizes,
    the 224 frame, padded gt pairs; in training with ``generated_pairs``,
    one generated pair a row drawn from the caches' rows) and the steps
    of an epoch over them. -> (pool, steps): ``traffic["pool"]`` batches
    of the most common signature, then one of each other signature the
    epoch's layout (:func:`epoch_layout`) holds; ``steps[i]`` is the pool
    index of step i: the most common signature's batches in turn, each
    other signature's batch at its steps. ``pixels(seed, shape)`` makes a
    uint8 (B, 3, H, W) array (the harness draws it on the card); None
    draws it with numpy."""
    rng = np.random.default_rng([seed, 7])
    training = traffic["mode"] == "train"
    shares = signature_shares(config, traffic)
    layout = epoch_layout(shares, epoch_steps(config, traffic))
    main = max(shares, key=shares.get)
    sigs = [main] * traffic["pool"] + sorted(set(layout) - {main})
    pool = [make_batch(rng, config, traffic, num_classes, training, want,
                       caches, pixels, clip_resolution) for want in sigs]
    other = {s: i for i, s in enumerate(sigs) if s != main}
    steps, turn = [], 0
    for sig in layout:
        if sig == main:
            steps.append(turn % traffic["pool"])
            turn += 1
        else:
            steps.append(other[sig])
    return pool, steps


def make_batch(rng, config, traffic, num_classes, training, want, caches,
               pixels, clip_resolution):
    """One host batch that pads to ``want`` (:func:`make_batches`)."""
    b = traffic["batch"]
    lo, hi = traffic["gt_pairs"]
    _, hws = batch_plan(rng, config, traffic, training, want)
    shape = (b, 3) + tuple(want)
    img = (pixels(int(rng.integers(0, 1 << 62)), shape)
           if pixels is not None else
           rng.integers(0, 256, shape, dtype=np.uint8))
    for r, (h, w) in enumerate(hws):
        img[r, :, h:, :] = 0
        img[r, :, :, w:] = 0
    d = {"images": img,
         "image_sizes": np.asarray(hws, np.int32),
         "clip_sizes": np.full((b, 2), float(clip_resolution), np.float32),
         "boxes_h": np.zeros((b, MAX_GT, 4), np.float32),
         "boxes_o": np.zeros((b, MAX_GT, 4), np.float32),
         "labels": np.zeros((b, MAX_GT), np.int32),
         "gt_valid": np.zeros((b, MAX_GT), bool)}
    for r in range(b):
        n = int(rng.integers(lo, hi + 1))
        bh, bo, verbs = gt_pairs(rng, n, config["object_verbs"], num_classes)
        d["boxes_h"][r, :n], d["boxes_o"][r, :n] = bh, bo
        d["labels"][r, :n] = verbs
        d["gt_valid"][r, :n] = True
    if training and traffic.get("generated_pairs") and caches is not None:
        d.update(generated_pairs(rng, b, caches, config["object_verbs"],
                                 num_classes))
    return d


def generated_pairs(rng, b, caches, object_verbs, num_classes):
    """One generated pair a row: a cache row's h, o and u features, its
    verb, and an object for which that verb is valid."""
    shots = caches.cache_h.shape[0] // num_classes
    rows = rng.integers(0, caches.cache_h.shape[0], size=b)
    verbs = rows // shots
    by_verb = {}
    for o, vs in enumerate(object_verbs):
        for v in vs:
            by_verb.setdefault(v, []).append(o)
    objs = np.asarray([rng.choice(by_verb.get(int(v), [0])) for v in verbs])
    mh = np.zeros((b, num_classes), np.float32)
    mh[np.arange(b), verbs] = 1.0
    return {"gen_hum": caches.cache_h[rows].copy(),
            "gen_obj": caches.cache_o[rows].copy(),
            "gen_uni": caches.cache_u[rows].copy(),
            "gen_obj_cls": objs.astype(np.int32),
            "gen_verb_multihot": mh}


def make_caches(seed, config, num_classes, num_shot, num_objects=80):
    """The caches and tables the CLI builds from the pair-embedding pickle,
    the generators and the text tower, drawn from ``seed`` instead: L2-
    normalised rows of every cache, one class a row, at the width of the
    configuration's CLIP embedding (``widths["clip_embed_dim"]``), and the
    configuration's object-verb table. -> a dict of numpy arrays (the
    harness wraps it in the port's ``UPTCaches``)."""
    rng = np.random.default_rng([seed, 3])
    r = num_classes * num_shot
    dim = config["widths"]["clip_embed_dim"]

    def unit(*s):
        x = rng.standard_normal(s).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    one_hots = np.zeros((r, num_classes), np.float32)
    one_hots[np.arange(r), np.repeat(np.arange(num_classes), num_shot)] = 1
    m = np.zeros((num_objects, num_classes), np.float32)
    for o, vs in enumerate(config["object_verbs"]):
        m[o, vs] = 1.0
    # the draws keep this order: at 512 a seed's caches stay as they were
    return dict(cache_h=unit(r, dim), cache_o=unit(r, dim),
                cache_u=unit(r, dim), one_hots=one_hots,
                sample_lens=one_hots.sum(0),
                clip_global_keys=np.ascontiguousarray(unit(r, dim).T),
                dino_keys=np.ascontiguousarray(unit(r, 2048).T),
                object_class_multihot=m,
                object_embedding=unit(num_objects, dim),
                origin_text_embeddings=unit(num_classes, dim),
                clip_global_values=one_hots.copy(),
                dino_values=one_hots.copy())
