"""Model zoo: the reference's sample models, the CNN families and the
decoder families as framework Modules (counterpart of
``int8inferenceengine_tpu.models.zoo``: every CNN name of its ``build()``,
``gpt_tiny``, ``opt_tiny``, ``llama_tiny``, ``mistral_tiny``,
``gemma_tiny``, ``moe_tiny``, ``neox_tiny`` and ``bloom_tiny``).

``torch_twin(name)`` builds the matching ``torch.nn`` model, with layer
attribute names equal to the framework model's, so
``model.load(torch_twin(name).state_dict())`` works as-is — the reference
notebooks' differential workflow (the ResNets' twins carry BatchNorm, which
``load`` folds).

The CNNs take NCHW float input via ``tensor()`` and return logits
[batch, classes]; ``gpt_tiny`` (``models.text_decoder.TextDecoder``) takes
token ids [batch, T] and returns logits [batch, T, vocab], as does
``llama_tiny`` (``models.llama.LlamaDecoder``, 4 query heads over 2 kv heads
by default), ``mistral_tiny`` (the same with a sliding window of 16),
``gemma_tiny`` (``models.gemma.GemmaDecoder``, 2 kv heads, a window of 32 on
its odd blocks), ``opt_tiny`` (``TextDecoder(act="relu")``: learned
positions, pre-LN, a ReLU MLP), ``moe_tiny`` (``models.moe.MoEDecoder``, 2
kv heads, 4 experts, top-2), ``neox_tiny`` (``models.neox.NeoXDecoder``:
parallel residual, rotary on a quarter of each head) and ``bloom_tiny``
(``models.bloom.BloomDecoder``: ALiBi, an embedding LayerNorm).
"""

from __future__ import annotations

from ..config import DEFAULT_CONFIG, QuantConfig
from ..layers import Conv2d, Linear
from ..module import Module
from ..ops import functional as F
from . import (densenet, efficientnet, googlenet, mobilenet, mobilenet_v3,
               resnet, shufflenet, squeezenet)
from .bloom import BloomDecoder, torch_bloom
from .gemma import GemmaDecoder, torch_gemma
from .llama import LlamaDecoder, torch_llama
from .moe import MoEDecoder, torch_moe
from .neox import NeoXDecoder, torch_neox
from .text_decoder import TextDecoder, torch_text_decoder

__all__ = ["FCMnist", "SimpleConv", "AlexNet", "LeNet", "VGG11", "VGG16",
           "VGG19", "TextDecoder", "LlamaDecoder", "GemmaDecoder",
           "MoEDecoder", "NeoXDecoder", "BloomDecoder", "build",
           "torch_twin", "MODEL_SPECS"]


class FCMnist(Module):
    """One-layer MNIST classifier (Fully_Connected_mnist.ipynb cell 0)."""

    INPUT_SHAPE = (1, 28, 28)

    def __init__(self, config: QuantConfig = DEFAULT_CONFIG, device=None):
        super().__init__(config, device)
        self.fc1 = Linear(784, 10, config=config, device=self.device)

    def forward(self, x):
        if len(x.shape) != 2:
            x = x.reshape(-1, 784)
        return self.fc1(x)


class SimpleConv(Module):
    """3-conv CIFAR10 net (Simple_Convolution_cifar10.ipynb cell 0).

    conv(3->20,k5)-relu-conv(20->50,k5)-relu-maxpool(2,2)-
    conv(50->120,k5)-relu-fc(7680->10); 32x32 input.
    """

    INPUT_SHAPE = (3, 32, 32)

    def __init__(self, config: QuantConfig = DEFAULT_CONFIG, device=None):
        super().__init__(config, device)
        d = self.device
        self.conv1 = Conv2d(3, 20, kernel_size=5, config=config, device=d)
        self.conv2 = Conv2d(20, 50, kernel_size=5, config=config, device=d)
        self.conv3 = Conv2d(50, 120, kernel_size=5, config=config, device=d)
        self.fc1 = Linear(7680, 10, config=config, device=d)

    def forward(self, x):
        x = F.relu(self.conv1(x))
        x = F.relu(self.conv2(x))
        x = F.max_pool2d(x, kernel_size=2, stride=2)
        x = F.relu(self.conv3(x))
        x = x.reshape(-1, 7680)
        return self.fc1(x)


class AlexNet(Module):
    """AlexNet for CIFAR10 resized to 224 (AlexNet_cifar10_resize224.ipynb
    cell 0) — the reference's headline benchmark model."""

    INPUT_SHAPE = (3, 224, 224)

    def __init__(self, num_classes: int = 10,
                 config: QuantConfig = DEFAULT_CONFIG, device=None):
        super().__init__(config, device)
        d = self.device
        self.conv1 = Conv2d(3, 96, kernel_size=11, stride=4, padding=2,
                            config=config, device=d)
        self.conv2 = Conv2d(96, 256, kernel_size=5, padding=2, config=config,
                            device=d)
        self.conv3 = Conv2d(256, 384, kernel_size=3, padding=1,
                            config=config, device=d)
        self.conv4 = Conv2d(384, 384, kernel_size=3, padding=1,
                            config=config, device=d)
        self.conv5 = Conv2d(384, 256, kernel_size=3, padding=1,
                            config=config, device=d)
        self.fc1 = Linear(256 * 6 * 6, 4096, config=config, device=d)
        self.fc2 = Linear(4096, 4096, config=config, device=d)
        self.fc3 = Linear(4096, num_classes, config=config, device=d)

    def forward(self, x):
        x = F.relu(self.conv1(x))
        x = F.max_pool2d(x, kernel_size=3, stride=2)
        x = F.relu(self.conv2(x))
        x = F.max_pool2d(x, kernel_size=3, stride=2)
        x = F.relu(self.conv3(x))
        x = F.relu(self.conv4(x))
        x = F.relu(self.conv5(x))
        x = F.max_pool2d(x, kernel_size=3, stride=2)
        x = x.reshape(-1, 256 * 6 * 6)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.fc3(x)


# VGG configurations A/D/E: convs per stage; every stage ends in a 2x2/2
# max-pool and widths are fixed (64, 128, 256, 512, 512).
_VGG_STAGES = {11: (1, 1, 2, 2, 2), 16: (2, 2, 3, 3, 3), 19: (2, 2, 4, 4, 4)}
_VGG_WIDTHS = (64, 128, 256, 512, 512)


class _VGG(Module):
    """Config-driven VGG for 224x224 input: deep plain-conv chains (long
    sequences of requant boundaries, 3x3 convs up to 512 channels).
    conv1..convN / fc1..fc3 naming (flat, reference-style single-dot
    keys); weights load from ``torch_twin('vggN')``."""

    INPUT_SHAPE = (3, 224, 224)
    DEPTH = None  # set by subclasses

    def __init__(self, num_classes: int = 10,
                 config: QuantConfig = DEFAULT_CONFIG, device=None):
        super().__init__(config, device)
        kw = dict(config=config, device=self.device)
        idx, in_ch = 1, 3
        for n_convs, width in zip(_VGG_STAGES[self.DEPTH], _VGG_WIDTHS):
            for _ in range(n_convs):
                setattr(self, f"conv{idx}",
                        Conv2d(in_ch, width, 3, padding=1, **kw))
                in_ch, idx = width, idx + 1
        self.fc1 = Linear(512 * 7 * 7, 4096, **kw)
        self.fc2 = Linear(4096, 4096, **kw)
        self.fc3 = Linear(4096, num_classes, **kw)

    def forward(self, x):
        idx = 1
        for n_convs in _VGG_STAGES[self.DEPTH]:
            for _ in range(n_convs):
                x = F.relu(getattr(self, f"conv{idx}")(x))
                idx += 1
            x = F.max_pool2d(x, 2, 2)
        x = x.reshape(-1, 512 * 7 * 7)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.fc3(x)


class VGG11(_VGG):
    """VGG-11 (configuration A): conv1..conv8."""
    DEPTH = 11


class VGG16(_VGG):
    """VGG-16 (configuration D): conv1..conv13."""
    DEPTH = 16


class VGG19(_VGG):
    """VGG-19 (configuration E): conv1..conv16."""
    DEPTH = 19


class LeNet(Module):
    """LeNet-style MNIST net (unittest/test_quantized_layer.py:26-42)."""

    INPUT_SHAPE = (1, 28, 28)

    def __init__(self, config: QuantConfig = DEFAULT_CONFIG, device=None):
        super().__init__(config, device)
        d = self.device
        self.conv1 = Conv2d(1, 20, kernel_size=5, config=config, device=d)
        self.conv2 = Conv2d(20, 50, kernel_size=5, config=config, device=d)
        self.fc1 = Linear(800, 500, config=config, device=d)
        self.fc2 = Linear(500, 10, config=config, device=d)

    def forward(self, x):
        x = self.conv1(x)
        x = F.max_pool2d(x, kernel_size=2, stride=2)
        x = self.conv2(x)
        x = F.max_pool2d(x, kernel_size=2, stride=2)
        x = x.reshape(-1, 800)
        x = F.relu(self.fc1(x))
        return self.fc2(x)


def _llama_tiny(**kw):
    kw.setdefault("kv_heads", 2)          # GQA by default (4 heads over 2)
    return LlamaDecoder(**kw)


def _mistral_tiny(**kw):
    # the llama topology with sliding-window attention
    kw.setdefault("kv_heads", 2)
    kw.setdefault("sliding_window", 16)
    return LlamaDecoder(**kw)


def _gemma_tiny(**kw):
    kw.setdefault("kv_heads", 2)
    return GemmaDecoder(**kw)


def _moe_tiny(**kw):
    kw.setdefault("kv_heads", 2)
    return MoEDecoder(**kw)


def _opt_tiny(**kw):
    # OPT: the gpt block (learned positions, pre-LN) with a ReLU MLP
    kw.setdefault("act", "relu")
    return TextDecoder(**kw)


def _mobilenet_v3(variant):
    def make(**kw):
        return mobilenet_v3.MobileNetV3(variant=variant, **kw)
    return make


MODEL_SPECS = {
    "fc_mnist": FCMnist,
    "simple_conv": SimpleConv,
    "alexnet": AlexNet,
    "lenet": LeNet,
    "vgg11": VGG11,
    "vgg16": VGG16,
    "vgg19": VGG19,
    "resnet18": resnet.ResNet18,
    "resnet34": resnet.ResNet34,
    "resnet50": resnet.ResNet50,
    "resnet101": resnet.ResNet101,
    "resnet152": resnet.ResNet152,
    "mobilenet_v1": mobilenet.MobileNetV1,
    "mobilenet_v2": mobilenet.MobileNetV2,
    "mobilenet_v3_large": _mobilenet_v3("large"),
    "mobilenet_v3_small": _mobilenet_v3("small"),
    "efficientnet_b0": efficientnet.EfficientNetB0,
    "shufflenet_v2": shufflenet.ShuffleNetV2,
    "squeezenet": squeezenet.SqueezeNet,
    "googlenet": googlenet.GoogLeNet,
    "densenet121": densenet.DenseNet121,
    "gpt_tiny": TextDecoder,
    "llama_tiny": _llama_tiny,
    "mistral_tiny": _mistral_tiny,
    "gemma_tiny": _gemma_tiny,
    "moe_tiny": _moe_tiny,
    "neox_tiny": NeoXDecoder,
    "opt_tiny": _opt_tiny,
    "bloom_tiny": BloomDecoder,
}

# the families whose torch twins live in their own modules
_TWINS = {
    "gpt_tiny": lambda seed: torch_text_decoder(seed=seed),
    "opt_tiny": lambda seed: torch_text_decoder(seed=seed, act="relu"),
    "llama_tiny": lambda seed: torch_llama(kv_heads=2, seed=seed),
    "mistral_tiny": lambda seed: torch_llama(kv_heads=2, sliding_window=16,
                                             seed=seed),
    "gemma_tiny": lambda seed: torch_gemma(kv_heads=2, seed=seed),
    "moe_tiny": lambda seed: torch_moe(kv_heads=2, seed=seed),
    "neox_tiny": lambda seed: torch_neox(seed=seed),
    "bloom_tiny": lambda seed: torch_bloom(seed=seed),
    "resnet18": lambda seed: resnet.torch_resnet18(seed=seed),
    "resnet34": lambda seed: resnet.torch_resnet34(seed=seed),
    "resnet50": lambda seed: resnet.torch_resnet50(seed=seed),
    "resnet101": lambda seed: resnet.torch_resnet101(seed=seed),
    "resnet152": lambda seed: resnet.torch_resnet152(seed=seed),
    "mobilenet_v1": lambda seed: mobilenet.torch_mobilenet_v1(seed=seed),
    "mobilenet_v2": lambda seed: mobilenet.torch_mobilenet_v2(seed=seed),
    "mobilenet_v3_large": lambda seed: mobilenet_v3.torch_mobilenet_v3(
        variant="large", seed=seed),
    "mobilenet_v3_small": lambda seed: mobilenet_v3.torch_mobilenet_v3(
        variant="small", seed=seed),
    "efficientnet_b0": lambda seed: efficientnet.torch_efficientnet_b0(
        seed=seed),
    "shufflenet_v2": lambda seed: shufflenet.torch_shufflenet_v2(seed=seed),
    "squeezenet": lambda seed: squeezenet.torch_squeezenet(seed=seed),
    "googlenet": lambda seed: googlenet.torch_googlenet(seed=seed),
    "densenet121": lambda seed: densenet.torch_densenet121(seed=seed),
}


def build(name: str, config: QuantConfig = DEFAULT_CONFIG, device=None,
          **kw) -> Module:
    """Build a zoo model by name."""
    try:
        make = MODEL_SPECS[name]
    except KeyError:
        raise ValueError(
            f"unknown model {name!r}; available: {sorted(MODEL_SPECS)}")
    return make(config=config, device=device, **kw)


def torch_twin(name: str, seed: int = 42):
    """Build the matching ``torch.nn`` model (the differential oracle), on
    the CPU; ``torch.manual_seed(seed)`` fixes its initial weights."""
    import torch
    import torch.nn as nn
    import torch.nn.functional as tF

    if name in _TWINS:
        return _TWINS[name](seed)

    torch.manual_seed(seed)

    if name == "fc_mnist":
        class Net(nn.Module):
            def __init__(self):
                super().__init__()
                self.fc1 = nn.Linear(784, 10)

            def forward(self, x):
                return self.fc1(x.reshape(-1, 784))

    elif name == "simple_conv":
        class Net(nn.Module):
            def __init__(self):
                super().__init__()
                self.conv1 = nn.Conv2d(3, 20, 5)
                self.conv2 = nn.Conv2d(20, 50, 5)
                self.conv3 = nn.Conv2d(50, 120, 5)
                self.fc1 = nn.Linear(7680, 10)

            def forward(self, x):
                x = tF.relu(self.conv1(x))
                x = tF.relu(self.conv2(x))
                x = tF.max_pool2d(x, 2, 2)
                x = tF.relu(self.conv3(x))
                return self.fc1(x.reshape(-1, 7680))

    elif name == "alexnet":
        class Net(nn.Module):
            def __init__(self):
                super().__init__()
                self.conv1 = nn.Conv2d(3, 96, 11, stride=4, padding=2)
                self.conv2 = nn.Conv2d(96, 256, 5, padding=2)
                self.conv3 = nn.Conv2d(256, 384, 3, padding=1)
                self.conv4 = nn.Conv2d(384, 384, 3, padding=1)
                self.conv5 = nn.Conv2d(384, 256, 3, padding=1)
                self.fc1 = nn.Linear(9216, 4096)
                self.fc2 = nn.Linear(4096, 4096)
                self.fc3 = nn.Linear(4096, 10)

            def forward(self, x):
                x = tF.max_pool2d(tF.relu(self.conv1(x)), 3, 2)
                x = tF.max_pool2d(tF.relu(self.conv2(x)), 3, 2)
                x = tF.relu(self.conv3(x))
                x = tF.relu(self.conv4(x))
                x = tF.max_pool2d(tF.relu(self.conv5(x)), 3, 2)
                x = x.reshape(-1, 9216)
                x = tF.relu(self.fc1(x))
                x = tF.relu(self.fc2(x))
                return self.fc3(x)

    elif name in ("vgg11", "vgg16", "vgg19"):
        stages = _VGG_STAGES[int(name[3:])]

        class Net(nn.Module):
            def __init__(self):
                super().__init__()
                idx, in_ch = 1, 3
                for n_convs, width in zip(stages, _VGG_WIDTHS):
                    for _ in range(n_convs):
                        setattr(self, f"conv{idx}",
                                nn.Conv2d(in_ch, width, 3, padding=1))
                        in_ch, idx = width, idx + 1
                self.fc1 = nn.Linear(512 * 7 * 7, 4096)
                self.fc2 = nn.Linear(4096, 4096)
                self.fc3 = nn.Linear(4096, 10)

            def forward(self, x):
                idx = 1
                for n_convs in stages:
                    for _ in range(n_convs):
                        x = tF.relu(getattr(self, f"conv{idx}")(x))
                        idx += 1
                    x = tF.max_pool2d(x, 2, 2)
                x = x.reshape(-1, 512 * 7 * 7)
                x = tF.relu(self.fc1(x))
                x = tF.relu(self.fc2(x))
                return self.fc3(x)

    elif name == "lenet":
        class Net(nn.Module):
            def __init__(self):
                super().__init__()
                self.conv1 = nn.Conv2d(1, 20, 5)
                self.conv2 = nn.Conv2d(20, 50, 5)
                self.fc1 = nn.Linear(800, 500)
                self.fc2 = nn.Linear(500, 10)

            def forward(self, x):
                x = tF.max_pool2d(self.conv1(x), 2, 2)
                x = tF.max_pool2d(self.conv2(x), 2, 2)
                x = x.reshape(-1, 800)
                x = tF.relu(self.fc1(x))
                return self.fc2(x)

    else:
        raise ValueError(f"unknown model {name!r}")

    return Net()
