"""Model zoo of the PyTorch port (the reference's sample notebooks as
library code, plus the CNN, decoder and encoder families): the same names
as ``int8inferenceengine_tpu.models``."""

from .densenet import DenseNet121, torch_densenet121
from .mobilenet import (MobileNetV1, MobileNetV2, torch_mobilenet_v1,
                        torch_mobilenet_v2)
from .mobilenet_v3 import MobileNetV3, torch_mobilenet_v3
from .efficientnet import EfficientNetB0, torch_efficientnet_b0
from .shufflenet import ShuffleNetV2, torch_shufflenet_v2
from .vit import ViT, torch_vit
from .text_transformer import TextTransformer, torch_text_transformer
from .googlenet import GoogLeNet, torch_googlenet
from .squeezenet import SqueezeNet, torch_squeezenet
from .llama import LlamaDecoder, torch_llama
from .moe import MoEDecoder, torch_moe
from .resnet import (ResNet18, ResNet34, ResNet50, ResNet101, ResNet152,
                     torch_resnet18, torch_resnet34, torch_resnet50,
                     torch_resnet101, torch_resnet152)
from .zoo import (MODEL_SPECS, VGG11, VGG16, VGG19, AlexNet, FCMnist, LeNet,
                  SimpleConv, build, torch_twin)

__all__ = [
    "FCMnist", "SimpleConv", "AlexNet", "LeNet", "VGG11", "VGG16", "VGG19",
    "ResNet18",
    "MobileNetV1", "torch_mobilenet_v1", "MobileNetV2", "torch_mobilenet_v2",
    "MobileNetV3", "torch_mobilenet_v3",
    "EfficientNetB0", "torch_efficientnet_b0",
    "ShuffleNetV2", "torch_shufflenet_v2",
    "ViT", "torch_vit",
    "TextTransformer", "torch_text_transformer",
    "LlamaDecoder", "torch_llama", "MoEDecoder", "torch_moe",
    "ResNet34", "torch_resnet34",
    "ResNet50", "torch_resnet50",
    "ResNet101", "torch_resnet101", "ResNet152", "torch_resnet152",
    "build", "torch_twin", "MODEL_SPECS", "torch_resnet18",
    "SqueezeNet", "torch_squeezenet", "GoogLeNet", "torch_googlenet",
    "DenseNet121", "torch_densenet121",
]
