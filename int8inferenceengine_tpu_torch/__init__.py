"""PyTorch/CUDA port of the INT8 post-training-quantization inference engine.

The same ``Module``/``Linear``/``Conv2d``/``tensor`` API and
``load -> prepare -> calibrate -> convert`` lifecycle as the JAX package
``int8inferenceengine_tpu``, with the same numerics (u8 asymmetric
activations, s8 symmetric weights, i32 accumulation, trunc/nearest requant
epilogues), running on an NVIDIA Hopper card through hand-written CUDA
kernels (``csrc/``): the CNN zoo (the reference's four nets, VGG,
ResNet, MobileNet V1-V3, EfficientNet-B0, ShuffleNetV2, SqueezeNet,
GoogLeNet, DenseNet-121), the GPT-style ``TextDecoder`` and the
llama-family ``LlamaDecoder`` with their u8 KV cache and greedy
``generate``, and 4-bit weights (W4A8 and W4 weight-only).  Its input
pipeline is ``DataLoader`` over the native host ops (``native``: resize,
normalize, quantize and the first conv's space-to-depth on the host).
Entry points run on the card unless the caller passes ``device="cpu"``.

TF32 is switched off for float32 matmuls and cuDNN convolutions at import:
the FP32 calibration forward decides every quantization scale, and TF32
keeps only about three decimal digits.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from . import native  # noqa: E402
from .config import DEFAULT_CONFIG, QuantConfig  # noqa: E402
from .data import DataLoader  # noqa: E402
from .layers import (Conv2d, Layer, Linear, QuantAct,  # noqa: E402
                     QuantAdd, QuantConcat, QuantEmbed, QuantLayerNorm,
                     QuantMatmul, QuantMul, QuantPosEmbed, QuantRMSNorm,
                     QuantRoPE, QuantSoftmax)
from .module import Module, TruncDepthWarning  # noqa: E402
from .ops.functional import (  # noqa: E402
    adaptive_avg_pool2d_1x1, argmax, avg_pool2d, channel_shuffle, dequantize,
    max_pool2d, quantize, relu, split_channels)
from .tensor import Tensor, tensor  # noqa: E402

__all__ = [
    "tensor", "argmax", "relu", "max_pool2d", "avg_pool2d",
    "adaptive_avg_pool2d_1x1", "channel_shuffle", "split_channels",
    "Linear", "Conv2d", "Tensor", "Layer", "Module",
    "QuantAct", "QuantAdd", "QuantConcat", "QuantEmbed", "QuantLayerNorm",
    "QuantMatmul", "QuantMul", "QuantPosEmbed", "QuantRMSNorm", "QuantRoPE",
    "QuantSoftmax",
    "quantize", "dequantize",
    "QuantConfig", "DEFAULT_CONFIG", "TruncDepthWarning",
    "DataLoader", "native",
]
