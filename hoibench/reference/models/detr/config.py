"""DETR architecture configuration (copy of
``hoigen_tpu/models/detr/config.py``; defaults = DETR-R50 as used by the
HOI pipeline). The JAX config's ``nchw_backbone``, a layout experiment
that computes the same function, has no counterpart here."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class DETRConfig:
    num_classes: int = 81        # 80 + no-object for the HICO-DET checkpoint
    hidden_dim: int = 256
    nheads: int = 8
    enc_layers: int = 6
    dec_layers: int = 6
    dim_feedforward: int = 2048
    num_queries: int = 100
    backbone_dim: int = 2048     # ResNet-50 C5
    dropout: float = 0.1
    # run the encoder self-attention through the fused attention kernel
    # (ops/attention.py); taken only on CUDA with a bf16 tower, otherwise
    # the plain attention runs (detr/model.py::transformer_forward)
    fused_encoder_attention: bool = True
    # residual layers whose stride-1 tail blocks run the fused
    # bottleneck-chain kernel (ops/fused_resnet.py); taken only on CUDA with
    # a bf16 tower and no remat (detr/model.py::detr_forward). The CUDA
    # kernels take every layer's tail: layer1's (2 blocks, C=256, M=64) by
    # the fused route, the others by the layered one.
    fused_resnet_tail: tuple = (0,)
    # recompute each backbone block in the backward
    # (torch.utils.checkpoint) instead of keeping its activations: the
    # offline DETR finetune (cli/train_detr.py) sets it; it also turns the
    # fused tail off. The HOI pipeline runs DETR frozen and leaves it off
    remat_backbone: bool = False
