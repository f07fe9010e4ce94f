"""CLIP image-tower configuration (the ViT fields of
``hoigen_tpu/models/clip/config.py``; the text tower and the ModifiedResNet
tower are not part of the port yet)."""
import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    image_resolution: int = 224
    vision_layers: int = 12
    vision_width: int = 768
    vision_patch_size: int = 16
    # instance-adapter settings (CLIP_models_adapter_prior2.py:423-459,934-967)
    use_adapter: bool = True
    adapter_layers: Tuple[int, ...] = tuple(range(12))
    adapter_num_layers: int = 1
    adapter_bottleneck: int = 64
    adapter_heads: int = 2

    @property
    def vision_heads(self) -> int:
        return self.vision_width // 64

    @property
    def grid_size(self) -> int:
        return self.image_resolution // self.vision_patch_size


VIT_B16 = CLIPConfig()
