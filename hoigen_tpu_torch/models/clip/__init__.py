"""Adapter-CLIP: the ViT image tower, the text tower, the BPE tokenizer
and the checkpoint converter (port of hoigen_tpu.models.clip)."""
