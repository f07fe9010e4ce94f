"""CLIP configuration (port of ``hoigen_tpu/models/clip/config.py``, with
its defaults): the ViT or ModifiedResNet image tower and the text
tower, and the OpenAI models the CLI's ``--clip-model`` names
(:data:`CLIP_MODELS`)."""
import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    image_resolution: int = 224
    vision_layers: int = 12
    vision_width: int = 768
    vision_patch_size: int = 16
    # ModifiedResNet image tower: block counts of its four stages; None is
    # the ViT. For an RN tower vision_width is the stem width (64 for
    # RN50) and vision_patch_size is 32 (the tower's total stride), so
    # that grid_size holds
    rn_layers: Optional[Tuple[int, int, int, int]] = None
    # the causal text transformer (class-text encodes, feature synthesis)
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_heads: int = 8
    transformer_layers: int = 12
    # instance-adapter settings (CLIP_models_adapter_prior2.py:423-459,934-967)
    use_adapter: bool = True
    adapter_layers: Tuple[int, ...] = tuple(range(12))
    adapter_num_layers: int = 1
    adapter_bottleneck: int = 64
    adapter_heads: int = 2
    # dropout inside the adapters' decoder layers, in training only
    adapter_dropout: float = 0.1
    # route the ViT blocks' self-attention through the fused attention
    # kernels (ops/attention.py: K1 forward, K4 backward); the training step
    # takes it, the eval step turns it off (engine/hoi_model.py)
    fused_attention: bool = True

    @property
    def is_resnet(self) -> bool:
        return self.rn_layers is not None

    @property
    def vision_heads(self) -> int:
        # RN: the attention pool's heads over its embed dim, width * 32
        if self.is_resnet:
            return self.vision_width * 32 // 64
        return self.vision_width // 64

    @property
    def grid_size(self) -> int:
        return self.image_resolution // self.vision_patch_size

    @staticmethod
    def adapter_layer_ids(adapter_pos: str, vision_layers: int, rng=None):
        """'all' | 'front' | 'end' | 'last' | 'random' -> layer index tuple
        (CLIP_models_adapter_prior2.py:958-967); 'random' draws from
        ``rng`` (a ``random.Random``), else from the ``random`` module."""
        if adapter_pos == "all":
            return tuple(range(vision_layers))
        if adapter_pos == "front":
            return tuple(range(vision_layers // 2))
        if adapter_pos == "end":
            return tuple(range(vision_layers // 2, vision_layers))
        if adapter_pos == "last":
            return (vision_layers - 1,)
        if adapter_pos == "random":
            import random as _random
            r = rng or _random
            return tuple(r.randint(0, vision_layers - 1)
                         for _ in range(vision_layers // 2))
        raise ValueError(adapter_pos)


VIT_B16 = CLIPConfig()
# OpenAI's ViT-L/14@336px (CLIP, arXiv:2103.00020, Table 20): 24 blocks of
# 1024 in 16 heads, patch 14 at 336 (577 tokens), a 768-wide embedding
# and a text tower of 12 blocks of 768 in 12 heads
VIT_L14_336 = CLIPConfig(
    embed_dim=768, image_resolution=336, vision_layers=24,
    vision_width=1024, vision_patch_size=14, transformer_width=768,
    transformer_heads=12, adapter_layers=tuple(range(24)))

# --clip-model: OpenAI's own names
CLIP_MODELS = {"ViT-B/16": VIT_B16, "ViT-L/14@336px": VIT_L14_336}


def clip_model(name: str) -> CLIPConfig:
    """The preset ``--clip-model`` names; raises on any other name."""
    if name not in CLIP_MODELS:
        raise ValueError(f"--clip-model {name!r}: not one of "
                         f"{', '.join(CLIP_MODELS)}")
    return CLIP_MODELS[name]


def _image_tower(cfg: CLIPConfig):
    return (cfg.rn_layers, cfg.vision_width, cfg.vision_layers,
            cfg.vision_patch_size, cfg.image_resolution, cfg.embed_dim)


def tower_name(cfg: CLIPConfig) -> str:
    """The name of ``cfg``'s image tower: the preset's whose tower it is
    (widths, depth, patch or stages, resolution, embedding), else one
    made of those."""
    for name, preset in CLIP_MODELS.items():
        if _image_tower(preset) == _image_tower(cfg):
            return name
    if cfg.is_resnet:
        return (f"RN-{cfg.vision_width}-"
                f"{'-'.join(map(str, cfg.rn_layers))}@{cfg.image_resolution}px")
    return (f"ViT-{cfg.vision_width}x{cfg.vision_layers}/"
            f"{cfg.vision_patch_size}@{cfg.image_resolution}px")
