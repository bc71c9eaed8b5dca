"""Model zoo: the reference's sample models and the GPT-style and llama
decoders as framework Modules (counterpart of
``int8inferenceengine_tpu.models.zoo``, for the four reference-parity
models, ``gpt_tiny`` and ``llama_tiny``).

``torch_twin(name)`` builds the matching ``torch.nn`` model, with layer
attribute names equal to the framework model's, so
``model.load(torch_twin(name).state_dict())`` works as-is — the reference
notebooks' differential workflow.

The CNNs take NCHW float input via ``tensor()`` and return logits
[batch, classes]; ``gpt_tiny`` (``models.text_decoder.TextDecoder``) takes
token ids [batch, T] and returns logits [batch, T, vocab], as does
``llama_tiny`` (``models.llama.LlamaDecoder``, 4 query heads over 2 kv heads
by default).
"""

from __future__ import annotations

from ..config import DEFAULT_CONFIG, QuantConfig
from ..layers import Conv2d, Linear
from ..module import Module
from ..ops import functional as F
from .llama import LlamaDecoder, torch_llama
from .text_decoder import TextDecoder, torch_text_decoder

__all__ = ["FCMnist", "SimpleConv", "AlexNet", "LeNet", "TextDecoder",
           "LlamaDecoder", "build", "torch_twin", "MODEL_SPECS"]


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


MODEL_SPECS = {
    "fc_mnist": FCMnist,
    "simple_conv": SimpleConv,
    "alexnet": AlexNet,
    "lenet": LeNet,
    "gpt_tiny": TextDecoder,
    "llama_tiny": _llama_tiny,
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

    if name == "gpt_tiny":
        return torch_text_decoder(seed=seed)
    if name == "llama_tiny":
        return torch_llama(kv_heads=2, seed=seed)

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
