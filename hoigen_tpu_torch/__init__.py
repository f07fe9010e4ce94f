"""hoigen_tpu_torch — the PyTorch/CUDA port of ``hoigen_tpu`` for NVIDIA
Hopper (H100).

The module layout mirrors ``hoigen_tpu`` (``ops/``, ``models/detr/``,
``models/clip/``, ``models/``, ``engine/``) so that each function has an
obvious counterpart, and parameters keep the JAX package's key paths and
layouts. The package imports ``torch`` and ``numpy`` only: never ``jax``
and nothing of ``hoigen_tpu``. The TPU's Pallas kernels are hand-written
CUDA kernels under ``csrc/``, built with ``nvcc`` at first use.
"""
