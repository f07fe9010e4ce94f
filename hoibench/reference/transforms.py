"""Dual-stream image transforms (PIL + numpy, torchvision-free).

Reproduces the reference's data augmentation stack
(reference/utils_tip_cache_and_union_finetune.py:86-114 and
reference/detr/datasets/transforms_clip.py):

  train:  hflip(0.5) -> color jitter(.4,.4,.4) -> either multi-scale resize
          (min side in {480..800}, max 1333) or resize{400,500,600} +
          random crop(384..600) + multi-scale resize
  eval:   resize min side 800, max 1333
  both:   a second stream resized exactly to (clip_res, clip_res) bicubic;
          both streams ImageNet-normalized (the reference normalizes the
          CLIP stream with ImageNet stats too — kept for parity); targets
          follow the CLIP stream and end as normalized cxcywh in its frame.

Note: the reference's crop keep-filter compares the human box max corner
against the *object* box min corner (transforms_clip.py:86-90, an apparent
typo); we keep pairs whose boxes are both non-degenerate, the evident
intent.

Port of ``hoigen_tpu/data/transforms.py``, the same algorithm in the same order
(the tests hold the two packages equal).
"""
import numpy as np
from PIL import Image, ImageEnhance

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)
TRAIN_SCALES = (480, 512, 544, 576, 608, 640, 672, 704, 736, 768, 800)


def hflip(image, target):
    image = image.transpose(Image.FLIP_LEFT_RIGHT)
    w = image.size[0]
    out = dict(target)
    for k in ("boxes_h", "boxes_o"):
        b = target[k]
        if len(b):
            out[k] = np.stack([w - b[:, 2], b[:, 1], w - b[:, 0], b[:, 3]], 1)
    return image, out


JITTER_OPS = (ImageEnhance.Brightness, ImageEnhance.Contrast,
              ImageEnhance.Color)
JITTER_STRENGTH = 0.4


def color_jitter(image, rng, strength=JITTER_STRENGTH):
    order = rng.permutation(len(JITTER_OPS))
    for i in order:
        factor = float(rng.uniform(1 - strength, 1 + strength))
        image = JITTER_OPS[i](image).enhance(factor)
    return image


def _aspect_size(w, h, size, max_size):
    if max_size is not None:
        mn, mx = float(min(w, h)), float(max(w, h))
        if mx / mn * size > max_size:
            size = int(round(max_size * mn / mx))
    if (w <= h and w == size) or (h <= w and h == size):
        return h, w
    if w < h:
        return int(size * h / w), size
    return size, int(size * w / h)


def resize(image, target, size, max_size=None):
    """size: int (min side, aspect preserved) or (w, h) exact."""
    w0, h0 = image.size
    if isinstance(size, (list, tuple)):
        oh, ow = size[1], size[0]
    else:
        oh, ow = _aspect_size(w0, h0, size, max_size)
    image = image.resize((ow, oh), Image.BICUBIC)
    if target is None:
        return image, None
    rw, rh = ow / w0, oh / h0
    out = dict(target)
    for k in ("boxes_h", "boxes_o"):
        b = target[k]
        if len(b):
            out[k] = b * np.asarray([rw, rh, rw, rh], np.float32)
    return image, out


def _crop_draws(w, h, rng, min_size, max_size):
    """The random-crop rng draws, separated from pixel work so the batch
    geometry can be replayed from metadata (DualStreamTransform.plan)."""
    cw = int(rng.integers(min_size, min(w, max_size) + 1)) \
        if w > min_size else w
    ch = int(rng.integers(min_size, min(h, max_size) + 1)) \
        if h > min_size else h
    ci = int(rng.integers(0, h - ch + 1))
    cj = int(rng.integers(0, w - cw + 1))
    return cw, ch, ci, cj


def crop_apply(image, target, j, i, w, h):
    image = image.crop((j, i, j + w, i + h))
    out = dict(target)
    keep = None
    for k in ("boxes_h", "boxes_o"):
        b = target[k]
        if len(b) == 0:
            continue
        b = b - np.asarray([j, i, j, i], np.float32)
        b = np.clip(b, 0, np.asarray([w, h, w, h], np.float32))
        out[k] = b
        nondegen = (b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])
        keep = nondegen if keep is None else (keep & nondegen)
    if keep is not None:
        for k in ("boxes_h", "boxes_o", "hoi", "verb", "object", "actions",
                  "objects", "labels"):
            if k in out and len(out[k]):
                out[k] = out[k][keep]
    return image, out


def random_size_crop(image, target, rng, min_size=384, max_size=600):
    cw, ch, ci, cj = _crop_draws(image.width, image.height, rng,
                                 min_size, max_size)
    return crop_apply(image, target, cj, ci, cw, ch)


def to_normalized_array(image):
    """PIL -> float32 (3, H, W), ImageNet-normalized."""
    arr = np.asarray(image, np.float32) / 255.0
    arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
    return arr.transpose(2, 0, 1)


def to_chw_uint8(image):
    """PIL -> uint8 (3, H, W). Normalization happens on-device
    (ops/pixels.device_normalize): uint8 frames are 4x cheaper to ship."""
    return np.asarray(image, np.uint8).transpose(2, 0, 1)


def boxes_to_normalized_cxcywh(target, w, h):
    out = dict(target)
    scale = np.asarray([w, h, w, h], np.float32)
    for k in ("boxes_h", "boxes_o"):
        b = target[k]
        if len(b):
            cxcywh = np.stack([(b[:, 0] + b[:, 2]) / 2,
                               (b[:, 1] + b[:, 3]) / 2,
                               b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], 1)
            out[k] = cxcywh / scale
    return out


class DualStreamTransform:
    """image, target -> (detr_image CHW, clip_image CHW, target).

    Augmentation randomness is stateless: callers pass a per-sample ``rng``
    (the factory derives it from (seed, epoch, index)) so parallel loader
    workers are race-free and the sample stream is identical for any
    ``num_workers``. Without one, a shared fallback rng preserves the old
    single-threaded behavior.
    """

    def __init__(self, training: bool, clip_resolution: int = 224,
                 seed: int = 0, eval_min_side: int = 800,
                 max_side: int = 1333, train_scales=TRAIN_SCALES,
                 crop_resize_choices=(400, 500, 600),
                 crop_range=(384, 600), host_clip_stream: bool = True):
        self.training = training
        self.clip_resolution = clip_resolution
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.eval_min_side = eval_min_side
        self.max_side = max_side
        self.train_scales = train_scales
        self.crop_resize_choices = crop_resize_choices
        self.crop_range = crop_range
        # host_clip_stream=False: skip the second host PIL pass — the 224
        # stream is derived on-device from the DETR stream
        # (ops/resize.batch_resize_normalize), which is exactly the
        # reference's semantics since its IResize runs AFTER the DETR
        # resize (utils_tip_cache_and_union_finetune.py:193-196). Only the
        # target math runs here; the clip image slot returns None.
        self.host_clip_stream = host_clip_stream

    def plan(self, w0, h0, rng=None):
        """Every stochastic decision for one sample — drawn in __call__'s
        exact rng order — plus the resulting DETR-frame output size
        ``out_hw``, computed from the original (w0, h0) alone (no pixels).

        This is what lets multi-process collation agree on the GLOBAL
        padded batch shape: each process replays the stateless per-sample
        rng (seed, epoch, index) over dataset size metadata for rows it
        never loads (DataFactory.padded_hw).
        """
        if not self.training or rng is None:
            return {"out_hw": _aspect_size(w0, h0, self.eval_min_side,
                                           self.max_side)}
        p = {"flip": bool(rng.random() < 0.5),
             "jitter_order": [int(i) for i in rng.permutation(3)]}
        p["jitter_factors"] = [
            float(rng.uniform(1 - JITTER_STRENGTH, 1 + JITTER_STRENGTH))
            for _ in range(3)]
        if rng.random() < 0.5:
            size = int(rng.choice(self.train_scales))
            p["steps"] = (("resize", size, self.max_side),)
            out = _aspect_size(w0, h0, size, self.max_side)
        else:
            s1 = int(rng.choice(self.crop_resize_choices))
            oh, ow = _aspect_size(w0, h0, s1, None)
            cw, ch, ci, cj = _crop_draws(ow, oh, rng, *self.crop_range)
            s2 = int(rng.choice(self.train_scales))
            p["steps"] = (("resize", s1, None), ("crop", cj, ci, cw, ch),
                          ("resize", s2, self.max_side))
            out = _aspect_size(cw, ch, s2, self.max_side)
        p["out_hw"] = out
        return p

    def __call__(self, image, target, rng=None):
        rng = self.rng if rng is None else rng
        if self.training:
            p = self.plan(*image.size, rng=rng)
            if p["flip"]:
                image, target = hflip(image, target)
            for i, f in zip(p["jitter_order"], p["jitter_factors"]):
                image = JITTER_OPS[i](image).enhance(f)
            for step in p["steps"]:
                if step[0] == "resize":
                    image, target = resize(image, target, step[1], step[2])
                else:
                    image, target = crop_apply(image, target, *step[1:])
        else:
            image, target = resize(image, target, self.eval_min_side,
                                   self.max_side)
        r = self.clip_resolution
        if self.host_clip_stream:
            clip_image, target = resize(image, target, (r, r))
            target = boxes_to_normalized_cxcywh(target, r, r)
            target["size"] = np.asarray([r, r], np.float32)
            return to_chw_uint8(image), to_chw_uint8(clip_image), target
        # device clip stream: normalize boxes straight from the DETR frame
        # (b * r/w / r == b/w — same floats the 224-frame path produces)
        w, h = image.size
        target = boxes_to_normalized_cxcywh(target, w, h)
        target["size"] = np.asarray([r, r], np.float32)
        return to_chw_uint8(image), None, target
