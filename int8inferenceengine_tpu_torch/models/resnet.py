"""ResNet-18/34/50/101/152 (counterpart of
``int8inferenceengine_tpu.models.resnet``).

Residual connections are calibrated quantized adds (``layers.QuantAdd``);
BatchNorm is folded into the preceding conv's weights at load time (the
PTQ-standard fold; the reference has no BN anywhere), and per-channel
weight scales (``QuantConfig(weight_per_channel=True)``) recover the
accuracy one per-tensor scale loses on deep nets.

``ResNet*.load`` accepts a torchvision-layout ``state_dict`` (the key layout
of ``torchvision.models.resnet*``): when it holds BN running statistics they
are folded (``fold_resnet_state_dict``, a numpy copy of the JAX package's,
with the same float32 operations in the same order) and the result is
dispatched to this module's ``Conv2d``/``Linear`` layers.  The torch twins
``torch_resnet18 ... torch_resnet152`` build such a state dict with BN
statistics from one train-mode forward on random data.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, QuantConfig
from ..layers import Conv2d, Linear, QuantAdd
from ..module import Module
from ..ops import functional as F

__all__ = ["ResNet18", "ResNet34", "ResNet50", "ResNet101", "ResNet152",
           "fold_bn", "fold_resnet_state_dict", "torch_resnet18",
           "torch_resnet34", "torch_resnet50", "torch_resnet101",
           "torch_resnet152"]


def fold_bn(w_oihw, b, gamma, beta, mean, var, eps: float = 1e-5):
    """Fold an inference-mode BatchNorm into the preceding conv.

    y = gamma * (conv(x) + b - mean) / sqrt(var + eps) + beta
      = conv(x; w * s) + ((b - mean) * s + beta),  s = gamma / sqrt(var+eps)
    """
    s = gamma / np.sqrt(var + eps)
    w2 = w_oihw * s[:, None, None, None]
    b2 = (b - mean) * s + beta
    return np.float32(w2), np.float32(b2)


def _bn_to_conv_key(bn_prefix: str) -> str:
    """A BN module's path -> its preceding conv's path (torchvision resnet
    layout): bn1 -> conv1, bn2 -> conv2, downsample.1 -> downsample.0."""
    head, _, leaf = bn_prefix.rpartition(".")
    if leaf.startswith("bn"):
        conv_leaf = "conv" + leaf[2:]
        return f"{head}.{conv_leaf}" if head else conv_leaf
    if leaf == "1" and head.endswith("downsample"):
        return f"{head}.0"
    raise KeyError(f"cannot locate conv for BN module {bn_prefix!r}")


def _numpy(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def fold_resnet_state_dict(sd: dict) -> dict:
    """torchvision-style state_dict -> flat {'name.weight'/'name.bias'} with
    every BatchNorm folded into its conv."""
    sd = {k: _numpy(v) for k, v in sd.items()}
    bn_prefixes = sorted(
        k[: -len(".running_mean")] for k in sd if k.endswith(".running_mean"))
    out, consumed = {}, set()
    for bn in bn_prefixes:
        conv = _bn_to_conv_key(bn)
        w = sd[f"{conv}.weight"]
        b = sd.get(f"{conv}.bias", np.zeros(w.shape[0], np.float32))
        w2, b2 = fold_bn(w, b, sd[f"{bn}.weight"], sd[f"{bn}.bias"],
                         sd[f"{bn}.running_mean"], sd[f"{bn}.running_var"])
        out[f"{conv}.weight"] = w2
        out[f"{conv}.bias"] = b2
        consumed.update({
            f"{conv}.weight", f"{conv}.bias", f"{bn}.weight", f"{bn}.bias",
            f"{bn}.running_mean", f"{bn}.running_var",
            f"{bn}.num_batches_tracked",
        })
    for k, v in sd.items():
        if k not in consumed and not k.endswith("num_batches_tracked"):
            out[k] = v
    return out


class _Block(Module):
    """A sub-module of a model: called inside its parent's forward, so its
    call runs ``forward`` alone (no input quantization, no dequantize)."""

    def __call__(self, x):
        return self.forward(x)


class _Downsample(_Block):
    """1x1 strided conv on the skip path (torchvision key: downsample.0)."""

    def __init__(self, in_c, out_c, stride, config, device):
        super().__init__(config, device)
        setattr(self, "0", Conv2d(in_c, out_c, 1, stride=stride, padding=0,
                                  config=config, device=self.device))

    def forward(self, x):
        return getattr(self, "0")(x)


class BasicBlock(_Block):
    def __init__(self, in_c: int, out_c: int, stride: int = 1,
                 config: QuantConfig = DEFAULT_CONFIG, device=None):
        super().__init__(config, device)
        d = self.device
        self.conv1 = Conv2d(in_c, out_c, 3, stride=stride, padding=1,
                            config=config, device=d)
        self.conv2 = Conv2d(out_c, out_c, 3, stride=1, padding=1,
                            config=config, device=d)
        if stride != 1 or in_c != out_c:
            self.downsample = _Downsample(in_c, out_c, stride, config, d)
        self.add = QuantAdd(config=config, device=d)

    def forward(self, x):
        identity = self.downsample(x) if hasattr(self, "downsample") else x
        out = F.relu(self.conv1(x))
        out = self.conv2(out)
        return F.relu(self.add(out, identity))


class Bottleneck(_Block):
    """1x1 -> 3x3 (stride) -> 1x1 (expansion 4) residual block (the
    ResNet-50 family, torchvision's v1.5 stride placement)."""

    EXPANSION = 4

    def __init__(self, in_c: int, width: int, stride: int = 1,
                 config: QuantConfig = DEFAULT_CONFIG, device=None):
        super().__init__(config, device)
        d = self.device
        out_c = width * self.EXPANSION
        self.conv1 = Conv2d(in_c, width, 1, config=config, device=d)
        self.conv2 = Conv2d(width, width, 3, stride=stride, padding=1,
                            config=config, device=d)
        self.conv3 = Conv2d(width, out_c, 1, config=config, device=d)
        if stride != 1 or in_c != out_c:
            self.downsample = _Downsample(in_c, out_c, stride, config, d)
        self.add = QuantAdd(config=config, device=d)

    def forward(self, x):
        identity = self.downsample(x) if hasattr(self, "downsample") else x
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        out = self.conv3(out)
        return F.relu(self.add(out, identity))


class _Stage(_Block):
    """``n_blocks`` BasicBlocks, the first of stride ``stride``."""

    def __init__(self, in_c, out_c, stride, config, n_blocks: int = 2,
                 device=None):
        super().__init__(config, device)
        self._n = n_blocks
        setattr(self, "0", BasicBlock(in_c, out_c, stride, config,
                                      self.device))
        for i in range(1, n_blocks):
            setattr(self, str(i), BasicBlock(out_c, out_c, 1, config,
                                             self.device))

    def forward(self, x):
        for i in range(self._n):
            x = getattr(self, str(i))(x)
        return x


class _BottleneckStage(_Stage):
    """``n_blocks`` Bottlenecks of ``width``, the first of stride
    ``stride``."""

    def __init__(self, n_blocks, in_c, width, stride, config, device=None):
        _Block.__init__(self, config, device)
        self._n = n_blocks
        setattr(self, "0", Bottleneck(in_c, width, stride, config,
                                      self.device))
        for i in range(1, n_blocks):
            setattr(self, str(i),
                    Bottleneck(width * Bottleneck.EXPANSION, width, 1, config,
                               self.device))


class _ResNet(Module):
    """The stem, four stages and the head shared by the family; ``load``
    folds BatchNorm when the state dict carries running statistics."""

    INPUT_SHAPE = (3, 224, 224)

    def _stem(self, config):
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, config=config,
                            device=self.device)

    def load(self, state_dict):
        if any(str(k).endswith(".running_mean") for k in state_dict.keys()):
            state_dict = fold_resnet_state_dict(dict(state_dict))
        super().load(state_dict)

    def forward(self, x):
        x = F.relu(self.conv1(x))
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = F.adaptive_avg_pool2d_1x1(x)
        x = x.reshape(-1, self.fc.in_channels)
        return self.fc(x)


class ResNet18(_ResNet):
    """torchvision-layout ResNet-18 (BasicBlock x [2, 2, 2, 2])."""

    LAYERS = (2, 2, 2, 2)

    def __init__(self, num_classes: int = 10,
                 config: QuantConfig = DEFAULT_CONFIG, device=None):
        super().__init__(config, device)
        d = self.device
        n1, n2, n3, n4 = self.LAYERS
        self._stem(config)
        self.layer1 = _Stage(64, 64, 1, config, n1, d)
        self.layer2 = _Stage(64, 128, 2, config, n2, d)
        self.layer3 = _Stage(128, 256, 2, config, n3, d)
        self.layer4 = _Stage(256, 512, 2, config, n4, d)
        self.fc = Linear(512, num_classes, config=config, device=d)


class ResNet34(ResNet18):
    """torchvision-layout ResNet-34 (BasicBlock x [3, 4, 6, 3])."""

    LAYERS = (3, 4, 6, 3)


class ResNet50(_ResNet):
    """torchvision-layout bottleneck ResNet (depths [3, 4, 6, 3] =
    ResNet-50; ResNet101/ResNet152 set their stage depths)."""

    LAYERS = (3, 4, 6, 3)

    def __init__(self, num_classes: int = 10,
                 config: QuantConfig = DEFAULT_CONFIG, device=None):
        super().__init__(config, device)
        d = self.device
        n1, n2, n3, n4 = self.LAYERS
        self._stem(config)
        self.layer1 = _BottleneckStage(n1, 64, 64, 1, config, d)
        self.layer2 = _BottleneckStage(n2, 256, 128, 2, config, d)
        self.layer3 = _BottleneckStage(n3, 512, 256, 2, config, d)
        self.layer4 = _BottleneckStage(n4, 1024, 512, 2, config, d)
        self.fc = Linear(2048, num_classes, config=config, device=d)


class ResNet101(ResNet50):
    """ResNet-101: Bottleneck x [3, 4, 23, 3]."""

    LAYERS = (3, 4, 23, 3)


class ResNet152(ResNet50):
    """ResNet-152: Bottleneck x [3, 8, 36, 3]."""

    LAYERS = (3, 8, 36, 3)


# -- torch twins (torchvision key layout, BN statistics from one train-mode
# forward on random data; nothing is downloaded) ----------------------------

def torch_resnet18(num_classes: int = 10, seed: int = 42):
    """torchvision-compatible ResNet-18 oracle in plain torch.nn."""
    return _torch_basic_resnet((2, 2, 2, 2), num_classes, seed)


def torch_resnet34(num_classes: int = 10, seed: int = 42):
    """torchvision-compatible ResNet-34 oracle (BasicBlock x [3,4,6,3])."""
    return _torch_basic_resnet((3, 4, 6, 3), num_classes, seed)


def _torch_basic_resnet(depths, num_classes: int = 10, seed: int = 42):
    import torch.nn as nn
    import torch.nn.functional as tF

    torch.manual_seed(seed)

    class BasicBlockT(nn.Module):
        def __init__(self, in_c, out_c, stride=1):
            super().__init__()
            self.conv1 = nn.Conv2d(in_c, out_c, 3, stride, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(out_c)
            self.conv2 = nn.Conv2d(out_c, out_c, 3, 1, 1, bias=False)
            self.bn2 = nn.BatchNorm2d(out_c)
            self.downsample = None
            if stride != 1 or in_c != out_c:
                self.downsample = nn.Sequential(
                    nn.Conv2d(in_c, out_c, 1, stride, bias=False),
                    nn.BatchNorm2d(out_c))

        def forward(self, x):
            idn = self.downsample(x) if self.downsample is not None else x
            out = tF.relu(self.bn1(self.conv1(x)))
            out = self.bn2(self.conv2(out))
            return tF.relu(out + idn)

    def stage(n, in_c, out_c, stride):
        blocks = [BasicBlockT(in_c, out_c, stride)]
        blocks += [BasicBlockT(out_c, out_c) for _ in range(n - 1)]
        return nn.Sequential(*blocks)

    class ResNetT(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
            self.bn1 = nn.BatchNorm2d(64)
            self.layer1 = stage(depths[0], 64, 64, 1)
            self.layer2 = stage(depths[1], 64, 128, 2)
            self.layer3 = stage(depths[2], 128, 256, 2)
            self.layer4 = stage(depths[3], 256, 512, 2)
            self.fc = nn.Linear(512, num_classes)

        def forward(self, x):
            x = tF.relu(self.bn1(self.conv1(x)))
            x = tF.max_pool2d(x, 3, 2, padding=1)
            x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
            x = tF.adaptive_avg_pool2d(x, (1, 1)).reshape(-1, 512)
            return self.fc(x)

    net = ResNetT()
    net.train()
    with torch.no_grad():
        net(torch.randn(4, 3, 64, 64))  # populate running stats
    net.eval()
    return net


def torch_resnet50(num_classes: int = 10, seed: int = 42,
                   layers=(3, 4, 6, 3)):
    """torchvision-compatible bottleneck-ResNet oracle (BN running stats
    from one train-mode forward, as with torch_resnet18)."""
    import torch.nn as nn
    import torch.nn.functional as tF

    torch.manual_seed(seed)

    class BottleneckT(nn.Module):
        def __init__(self, in_c, width, stride=1):
            super().__init__()
            out_c = width * 4
            self.conv1 = nn.Conv2d(in_c, width, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(width)
            self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
            self.bn2 = nn.BatchNorm2d(width)
            self.conv3 = nn.Conv2d(width, out_c, 1, bias=False)
            self.bn3 = nn.BatchNorm2d(out_c)
            self.downsample = None
            if stride != 1 or in_c != out_c:
                self.downsample = nn.Sequential(
                    nn.Conv2d(in_c, out_c, 1, stride, bias=False),
                    nn.BatchNorm2d(out_c))

        def forward(self, x):
            idn = self.downsample(x) if self.downsample is not None else x
            out = tF.relu(self.bn1(self.conv1(x)))
            out = tF.relu(self.bn2(self.conv2(out)))
            out = self.bn3(self.conv3(out))
            return tF.relu(out + idn)

    def stage(n, in_c, width, stride):
        blocks = [BottleneckT(in_c, width, stride)]
        blocks += [BottleneckT(width * 4, width) for _ in range(n - 1)]
        return nn.Sequential(*blocks)

    class ResNet50T(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
            self.bn1 = nn.BatchNorm2d(64)
            self.layer1 = stage(layers[0], 64, 64, 1)
            self.layer2 = stage(layers[1], 256, 128, 2)
            self.layer3 = stage(layers[2], 512, 256, 2)
            self.layer4 = stage(layers[3], 1024, 512, 2)
            self.fc = nn.Linear(2048, num_classes)

        def forward(self, x):
            x = tF.relu(self.bn1(self.conv1(x)))
            x = tF.max_pool2d(x, 3, 2, padding=1)
            x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
            x = tF.adaptive_avg_pool2d(x, (1, 1)).reshape(-1, 2048)
            return self.fc(x)

    net = ResNet50T()
    net.train()
    with torch.no_grad():
        net(torch.randn(2, 3, 64, 64))
    net.eval()
    return net


def torch_resnet101(num_classes: int = 10, seed: int = 42):
    return torch_resnet50(num_classes, seed, layers=(3, 4, 23, 3))


def torch_resnet152(num_classes: int = 10, seed: int = 42):
    return torch_resnet50(num_classes, seed, layers=(3, 8, 36, 3))
