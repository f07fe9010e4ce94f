"""DINO ResNet-50 global image features (port of ``hoigen_tpu/models/dino.py``).

torchvision resnet50 with fc=Identity in eval mode: the DETR backbone's
architecture (BN folded) plus a global average pool, on the CLIP-stream
images.
"""
from .detr.convert import resnet50_state_dict_to_params
from .detr.resnet import init_resnet50_params, resnet50_forward_nhwc


def dino_forward(params, images):
    """images (B, 3, H, W) -> (B, 2048) global features, NHWC and unfused,
    as the JAX package's eval step runs DINO."""
    feat = resnet50_forward_nhwc(params, images.permute(0, 2, 3, 1)
                                 .contiguous())
    return feat.mean(dim=(1, 2))


init_dino_params = init_resnet50_params


def torch_dino_state_dict_to_params(sd):
    """A torchvision resnet50 state dict (keys conv1/bn1/layerX.Y..., as
    the reference's DINO loader leaves them after its key cleanup) -> the
    folded parameters, on the CPU."""
    return resnet50_state_dict_to_params(sd)
