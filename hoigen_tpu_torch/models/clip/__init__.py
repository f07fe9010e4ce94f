"""Adapter-CLIP: the ViT and ModifiedResNet image towers, the text tower,
the BPE tokenizer and the checkpoint converter (port of
hoigen_tpu.models.clip)."""
