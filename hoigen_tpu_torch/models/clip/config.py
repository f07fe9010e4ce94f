"""CLIP configuration: the ViT image tower's and the text tower's fields
of ``hoigen_tpu/models/clip/config.py``, with its defaults (the
ModifiedResNet tower is not part of the port yet)."""
import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    image_resolution: int = 224
    vision_layers: int = 12
    vision_width: int = 768
    vision_patch_size: int = 16
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
    def vision_heads(self) -> int:
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
