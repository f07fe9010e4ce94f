"""DETR-R50 (port of hoigen_tpu.models.detr)."""
