"""The yardstick's arithmetic: the H100's published peaks, the operations
and bytes of the port's hand-written kernels at any shape (as
``chip_smoke.py``'s ``bound`` and kernel records count them), and the
model FLOPs of a whole eval or training step of the HOI model, by the
precision each part runs in.

A roofline share is the least time the chip could take (the larger of the
bytes over the memory rate and the slowest operation class over its peak)
over the time measured; each input byte is counted once, each output byte
once.
"""
# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12                # outside the tensor cores, TF32 off
N_SM = 132
CLOCK_HZ = 1.98e9                # boost clock
EXP_PER_SM_PER_CLOCK = 16        # special-function units
PEAKS = {"bfloat16": BF16_FLOPS, "float32": F32_FLOPS}


def bound_s(nbytes, op_seconds):
    """(seconds, 'bytes' or 'operations'): the larger of the bytes over
    the memory rate and the slowest operation class."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(op_seconds)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _exp_s(n):
    return n / (EXP_PER_SM_PER_CLOCK * N_SM * CLOCK_HZ)


def k1(b, h, lq, lk, d, itemsize, key_bias=False):
    """K1 (attention forward): q, k, v read and out written once (and the
    f32 key bias); two products on the bf16 tensor cores (f32 operands
    are rounded to bf16) and an exponential a score."""
    n_scores = b * h * lq * lk
    nbytes = itemsize * (2 * b * h * lq * d + 2 * b * h * lk * d)
    if key_bias:
        nbytes += 4 * b * lk
    return bound_s(nbytes, (4 * n_scores * d / BF16_FLOPS,
                            _exp_s(n_scores)))


def k4(b, h, l, d, itemsize):
    """K4 (attention backward, unmasked self-attention): q, k, v, out,
    the incoming gradient and the forward's row statistics read, dq, dk,
    dv written; five products (the scores again, dv, dp, dq, dk) and an
    exponential a score."""
    n_scores = b * h * l * l
    t = b * h * l * d
    nbytes = itemsize * 8 * t + 4 * 2 * b * h * l
    return bound_s(nbytes, (10 * n_scores * d / BF16_FLOPS,
                            _exp_s(n_scores)))


def k2(b, h, w, c=256, m=64, blocks=2):
    """K2 (the fused chain of ``blocks`` stride-1 bottlenecks of width c,
    inner m, bf16): the plane read and written once, each block's bf16
    weights and f32 folded scales and biases read once; the three
    products of every block on the bf16 tensor cores."""
    pix = b * h * w
    flops = 2 * pix * blocks * (2 * c * m + 9 * m * m)
    weights = blocks * (2 * (c * m + 9 * m * m + m * c)
                        + 4 * 2 * (m + m + c))
    return bound_s(2 * 2 * pix * c + weights, (flops / BF16_FLOPS,))


# --------------------------------------------------------------- a step
def _conv(cin, cout, k, ho, wo):
    return 2 * cin * cout * k * k * ho * wo


def _out(n, stride):
    return -(-n // stride)


def resnet50_flops(h, w):
    """The convolutions of ResNet-50 (stem to layer4) on one (h, w)
    image; -> (flops, C5's (h, w))."""
    h, w = _out(h, 2), _out(w, 2)
    f = _conv(3, 64, 7, h, w)
    h, w = _out(h, 2), _out(w, 2)              # max pool
    cin = 64
    for li, (n, m) in enumerate(((3, 64), (4, 128), (6, 256), (3, 512))):
        for bi in range(n):
            stride = 2 if (li > 0 and bi == 0) else 1
            ho, wo = _out(h, stride), _out(w, stride)
            # the stride sits in the 3x3, as in torchvision's ResNet
            f += (_conv(cin, m, 1, h, w) + _conv(m, m, 3, ho, wo)
                  + _conv(m, 4 * m, 1, ho, wo))
            if bi == 0:
                f += _conv(cin, 4 * m, 1, ho, wo)
            h, w, cin = ho, wo, 4 * m
    return f, (h, w)


def _mha(lq, lk, d, q_proj=True):
    """Projections and the two attention products of one layer."""
    return (2 * lq * d * d * (1 if q_proj else 0) + 2 * 2 * lk * d * d
            + 2 * lq * d * d + 2 * 2 * lq * lk * d)


def detr_flops(h, w, hidden=256, ff=2048, enc=6, dec=6, queries=100,
               classes=81):
    """DETR-R50 on one padded (h, w) image."""
    f, (fh, fw) = resnet50_flops(h, w)
    length = fh * fw
    f += 2 * length * 2048 * hidden                          # input_proj
    f += enc * (_mha(length, length, hidden) + 4 * length * hidden * ff)
    f += dec * (_mha(queries, queries, hidden) + _mha(queries, length, hidden)
                + 4 * queries * hidden * ff)
    f += dec * 2 * queries * hidden * (classes + 2 * hidden + 4)  # heads
    return f


def clip_flops(width=768, layers=12, patch=16, resolution=224, embed=512,
               bottleneck=64, prior_tokens=30, adapter_layers=12):
    """(dense flops, the blocks' attention-product flops) of a ViT image
    tower (ViT-B/16 by default) with its instance adapters on
    ``adapter_layers`` blocks, one image; the adapters' attention over the
    prior tokens (plain f32) counts as dense."""
    grid = resolution // patch
    length = grid * grid + 1
    dense = 2 * grid * grid * 3 * patch * patch * width      # patch embed
    block = 2 * length * (4 * width * width + 8 * width * width)
    attn = 4 * length * length * width
    adapter = (2 * length * width * bottleneck * 2           # down, up
               + _mha(length, prior_tokens, bottleneck)
               + 4 * length * bottleneck * 2 * bottleneck)   # FFN
    dense += layers * block + adapter_layers * adapter
    dense += 2 * length * width * embed                      # proj
    return dense, layers * attn


def head_flops(num_classes, rows, pairs=450, slots=30, dim=512,
               dino_dim=2048, prior_in=517):
    """(bf16 cache products, f32 flops) of the UPT head, one image: the
    H, O and U cache branches (K3, bf16 operands), the text branch, the
    global and DINO caches and the priors' MLP."""
    cache = 3 * (2 * pairs * dim * rows + 2 * pairs * rows * num_classes)
    f32 = (2 * pairs * dim * num_classes                     # text
           + 2 * dim * rows + 2 * rows * num_classes         # global
           + 2 * dino_dim * rows + 2 * rows * num_classes    # DINO
           + 2 * slots * (prior_in * 128 + 128 * 128 + 128 * 64))
    return cache, f32


def step_flops(images, hw, training, num_classes, num_shot, widths):
    """{precision: flops} of one step over ``images`` images padded to
    ``hw``, at the configuration's ``widths``. DETR and DINO run in bf16
    and never backward; CLIP in f32 with its attention products in bf16 in
    training (K1/K4) and in f32 at eval (the plain attention); the head in
    f32 with the cache products in bf16. The backward counts what the
    trainable leaves need: the input gradient of every CLIP product (the
    trainable positional embedding sits below the first block; the
    adapters' and the projection's weight gradients, under 2% more, are
    left out, so the count errs low) and the head's input and weight
    gradients."""
    rows = num_classes * num_shot
    detr = detr_flops(*hw, hidden=widths["detr_hidden_dim"],
                      enc=widths["detr_enc_layers"],
                      dec=widths["detr_dec_layers"],
                      queries=widths["detr_queries"],
                      classes=widths["detr_classes"])
    # DINO takes the CLIP stream's frame
    dino, _ = resnet50_flops(widths["clip_resolution"],
                             widths["clip_resolution"])
    dense, attn = clip_flops(
        widths["clip_vision_width"], widths["clip_vision_layers"],
        widths["clip_patch"], widths["clip_resolution"],
        widths["clip_embed_dim"], widths["adapter_bottleneck"],
        adapter_layers=widths["adapter_layers"])
    embed = widths["clip_embed_dim"]
    cache, head = head_flops(num_classes, rows, dim=embed,
                             prior_in=embed + 5)
    bf16 = detr + dino + cache
    f32 = dense + head
    if training:
        attn_b = 2 * attn            # four products against two
        f32 += dense + 2 * head
        bf16 += 2 * cache
        bf16 += attn + attn_b
    else:
        f32 += attn
    return {"bfloat16": images * bf16, "float32": images * f32}


def least_seconds(flops_by_precision):
    """The least time of a step's FLOPs at each precision's peak."""
    return sum(f / PEAKS[p] for p, f in flops_by_precision.items())


def detr_tokens(hw):
    """The DETR encoder's sequence length at a padded (h, w)."""
    _, (fh, fw) = resnet50_flops(*hw)
    return fh * fw


def k2_plane(hw):
    """The layer1 plane's (h, w) at a padded (h, w)."""
    return _out(_out(hw[0], 2), 2), _out(_out(hw[1], 2), 2)

