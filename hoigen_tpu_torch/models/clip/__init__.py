"""Adapter-CLIP ViT image tower (port of hoigen_tpu.models.clip)."""
