"""Frozen-BN convolution epilogue (NHWC): scale, bias, residual add and ReLU
in one pass.

No TPU kernel matches it: XLA fuses these epilogues into the convolutions on
the TPU. On a CUDA tensor :func:`conv_epilogue` launches the hand-written
kernel of ``csrc/conv_epilogue.cu`` (one read of each input, one write);
on a CPU tensor it runs :func:`conv_epilogue_reference`, the ATen chain it
replaces, which ``models/detr/resnet.py`` also runs, with its gradient,
where autograd records. Two modes:

- a site (the stem, conv1, conv2): ``relu(r(r(y * s) + b))``;
- a block end (conv3 with ``identity`` or ``down``):
  ``relu(r(r(r(y * s) + b) + id))``, ``id`` the block input or
  ``r(r(yd * sd) + bd)`` of the downsample's raw output ``yd``;

``r`` rounds to the activation dtype (bf16 or f32): each ATen pass computes
in f32 and rounds its result, and the kernel rounds at the same points.
"""
import ctypes
import functools

import torch

from . import _build

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def conv_epilogue_reference(y, scale, bias, identity=None, down=None):
    """Plain version of the kernel: the ATen chain ``relu(y * s + b)``, at a
    block end ``relu(y * s + b + id)`` with ``id = yd * sd + bd`` for
    ``down`` = (yd, sd, bd). Differentiable."""
    out = y * scale + bias
    if down is not None:
        yd, sd, bd = down
        identity = yd * sd + bd
    if identity is not None:
        out = out + identity
    return torch.relu(out)


@functools.cache
def _launcher():
    return _build.function("conv_epilogue", "conv_epilogue",
                           [ctypes.c_int] + [ctypes.c_void_p] * 7
                           + [ctypes.c_longlong] + [ctypes.c_int] * 2
                           + [ctypes.c_void_p])


@functools.cache
def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(y, operands):
    """What the kernel takes; raises on anything else. ``operands``: (name,
    tensor, shape) of every other tensor."""
    if y.dtype not in _DTYPES or y.dim() != 4 or y.shape[-1] % 8:
        raise ValueError("conv_epilogue: the CUDA kernel takes a bf16 or f32 "
                         "(B, H, W, C) tensor with C a multiple of 8; got "
                         f"{y.dtype} {tuple(y.shape)}")
    for name, t, shape in [("y", y, y.shape)] + operands:
        if (t.device != y.device or t.dtype != y.dtype
                or t.shape != shape or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(
                f"conv_epilogue: {name} is {t.dtype} {tuple(t.shape)} on "
                f"{t.device} (contiguous {t.is_contiguous()}, address mod 16 "
                f"{t.data_ptr() % 16}); expected a contiguous, 16-byte "
                f"aligned {y.dtype} {tuple(shape)} on {y.device}")


def conv_epilogue(y, scale, bias, identity=None, down=None):
    """The frozen-BN epilogue of the conv output ``y`` (B, H, W, C):
    ``scale`` and ``bias`` (C,) in y's dtype; at a block end either
    ``identity`` (the block input, y's shape) or ``down`` = (yd, sd, bd),
    the downsample's raw output and its scale and bias. Returns the result
    in y's dtype.

    On a CUDA tensor the kernel writes the result over ``y`` (the conv's
    temporary: read nothing from it afterwards) and allocates nothing;
    every tensor must be contiguous, 16-byte aligned, on y's device and in
    y's dtype (bf16 or f32), with C a multiple of 8. Anything else raises.
    On a CPU tensor it returns :func:`conv_epilogue_reference`."""
    if identity is not None and down is not None:
        raise ValueError("conv_epilogue: a block end takes identity or "
                         "down, not both")
    if not y.is_cuda:
        return conv_epilogue_reference(y, scale, bias, identity, down)
    res, sd, bd = (identity, None, None) if down is None else down
    c = y.shape[-1:]
    _check(y, [("scale", scale, c), ("bias", bias, c)]
           + ([("residual", res, y.shape)] if res is not None else [])
           + ([("down scale", sd, c), ("down bias", bd, c)]
              if sd is not None else []))

    def ptr(t):
        return None if t is None else t.data_ptr()
    _build.check(_launcher()(
        _DTYPES[y.dtype], y.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        ptr(res), ptr(sd), ptr(bd), y.data_ptr(), y.numel(), y.shape[-1],
        _sms(y.device), torch.cuda.current_stream(y.device).cuda_stream),
        "conv_epilogue")
    conv_epilogue.launches += 1
    return y


conv_epilogue.launches = 0
