"""Label and metadata tables for HICO-DET and V-COCO (port of
``hoigen_tpu/labels``). The JSON tables under ``labels/data`` are copies of
the JAX package's."""
from .hico import HICO  # noqa: F401
from .vcoco import VCOCO_LABELS  # noqa: F401
