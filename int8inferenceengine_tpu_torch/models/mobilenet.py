"""MobileNetV1/V2: depthwise-separable conv families (counterpart of
``int8inferenceengine_tpu.models.mobilenet``).

Every depthwise conv is a ``Conv2d(groups=channels)``: on the card kernel
G1 (``csrc/conv_grouped.cu``), with the same zero-point-offset/requant
pipeline as any conv (the per-output-channel rowsum already spans only
that channel's own taps, so the offset math is unchanged); the pointwise
convs run on B1's gathered conv.  V2 additionally exercises *linear*
bottlenecks — quantized layer outputs with no ReLU, so the calibrated
range is two-sided — and residual adds between them (``QuantAdd``).

These are the BN-free variants (convs carry bias; ReLU where the paper has
ReLU/ReLU6), with matching hand-written torch twins for differential
testing — the BN-folding workflow is exercised by the ResNet family.
"""

from __future__ import annotations

from ..config import DEFAULT_CONFIG, QuantConfig
from ..layers import Conv2d, Linear, QuantAdd
from ..module import Module
from ..ops import functional as F

__all__ = ["MobileNetV1", "torch_mobilenet_v1", "MOBILENET_CFG",
           "MobileNetV2", "torch_mobilenet_v2", "MOBILENET_V2_BLOCKS"]

# (out_channels, stride) per depthwise-separable block, MobileNetV1-1.0.
MOBILENET_CFG = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1),
                 (512, 2), (512, 1), (512, 1), (512, 1), (512, 1), (512, 1),
                 (1024, 2), (1024, 1)]


class MobileNetV1(Module):
    INPUT_SHAPE = (3, 224, 224)

    def __init__(self, num_classes: int = 10,
                 config: QuantConfig = DEFAULT_CONFIG, device=None):
        super().__init__(config, device)
        kw = dict(config=config, device=self.device)
        self.conv1 = Conv2d(3, 32, 3, stride=2, padding=1, **kw)
        c = 32
        for i, (c_out, stride) in enumerate(MOBILENET_CFG, start=1):
            setattr(self, f"dw{i}", Conv2d(c, c, 3, stride=stride, padding=1,
                                           groups=c, **kw))
            setattr(self, f"pw{i}", Conv2d(c, c_out, 1, **kw))
            c = c_out
        self.fc = Linear(1024, num_classes, **kw)

    def forward(self, x):
        x = F.relu(self.conv1(x))
        for i in range(1, len(MOBILENET_CFG) + 1):
            x = F.relu(getattr(self, f"dw{i}")(x))
            x = F.relu(getattr(self, f"pw{i}")(x))
        x = F.adaptive_avg_pool2d_1x1(x)
        x = x.reshape(-1, 1024)
        return self.fc(x)


# MobileNetV2-1.0 inverted-residual stages as (expansion t, out c, repeat n,
# first-stride s) — the paper's Table 2.
_V2_STAGES = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
              (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]


def _v2_blocks():
    """Flatten the stage table to per-block (in_c, out_c, t, stride, res)."""
    blocks, c = [], 32
    for t, c_out, n, s in _V2_STAGES:
        for j in range(n):
            stride = s if j == 0 else 1
            blocks.append((c, c_out, t, stride,
                           stride == 1 and c == c_out))
            c = c_out
    return blocks


MOBILENET_V2_BLOCKS = _v2_blocks()


class MobileNetV2(Module):
    """MobileNetV2: inverted residuals with linear bottlenecks.

    Per block i: ``exp{i}`` 1x1 expand (skipped when t=1) + ReLU, ``dw{i}``
    3x3 depthwise + ReLU, ``pw{i}`` 1x1 *linear* projection (no ReLU — the
    calibrated output range is two-sided), and ``add{i}`` (QuantAdd) when
    the block keeps shape.  Flat attribute naming so the torch twin's
    state_dict loads reference-style (single-dot keys).
    """

    INPUT_SHAPE = (3, 224, 224)

    def __init__(self, num_classes: int = 10,
                 config: QuantConfig = DEFAULT_CONFIG, device=None):
        super().__init__(config, device)
        kw = dict(config=config, device=self.device)
        self.conv1 = Conv2d(3, 32, 3, stride=2, padding=1, **kw)
        for i, (c_in, c_out, t, stride, res) in enumerate(
                MOBILENET_V2_BLOCKS, start=1):
            hid = c_in * t
            if t != 1:
                setattr(self, f"exp{i}", Conv2d(c_in, hid, 1, **kw))
            setattr(self, f"dw{i}", Conv2d(hid, hid, 3, stride=stride,
                                           padding=1, groups=hid,
                                           **kw))
            setattr(self, f"pw{i}", Conv2d(hid, c_out, 1, **kw))
            if res:
                setattr(self, f"add{i}", QuantAdd(**kw))
        self.conv_last = Conv2d(320, 1280, 1, **kw)
        self.fc = Linear(1280, num_classes, **kw)

    def forward(self, x):
        x = F.relu(self.conv1(x))
        for i, (c_in, c_out, t, stride, res) in enumerate(
                MOBILENET_V2_BLOCKS, start=1):
            identity = x
            if t != 1:
                x = F.relu(getattr(self, f"exp{i}")(x))
            x = F.relu(getattr(self, f"dw{i}")(x))
            x = getattr(self, f"pw{i}")(x)
            if res:
                x = getattr(self, f"add{i}")(x, identity)
        x = F.relu(self.conv_last(x))
        x = F.adaptive_avg_pool2d_1x1(x)
        x = x.reshape(-1, 1280)
        return self.fc(x)


def torch_mobilenet_v2(num_classes: int = 10, seed: int = 42):
    """Matching torch oracle (same attribute names -> state_dict loads)."""
    import torch
    import torch.nn as nn
    import torch.nn.functional as tF

    torch.manual_seed(seed)

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2d(3, 32, 3, stride=2, padding=1)
            for i, (c_in, c_out, t, stride, res) in enumerate(
                    MOBILENET_V2_BLOCKS, start=1):
                hid = c_in * t
                if t != 1:
                    setattr(self, f"exp{i}", nn.Conv2d(c_in, hid, 1))
                setattr(self, f"dw{i}", nn.Conv2d(hid, hid, 3, stride=stride,
                                                  padding=1, groups=hid))
                setattr(self, f"pw{i}", nn.Conv2d(hid, c_out, 1))
            self.conv_last = nn.Conv2d(320, 1280, 1)
            self.fc = nn.Linear(1280, num_classes)

        def forward(self, x):
            x = tF.relu(self.conv1(x))
            for i, (c_in, c_out, t, stride, res) in enumerate(
                    MOBILENET_V2_BLOCKS, start=1):
                identity = x
                if t != 1:
                    x = tF.relu(getattr(self, f"exp{i}")(x))
                x = tF.relu(getattr(self, f"dw{i}")(x))
                x = getattr(self, f"pw{i}")(x)
                if res:
                    x = x + identity
            x = tF.relu(self.conv_last(x))
            x = tF.adaptive_avg_pool2d(x, (1, 1)).reshape(-1, 1280)
            return self.fc(x)

    return Net()


def torch_mobilenet_v1(num_classes: int = 10, seed: int = 42):
    """Matching torch oracle (same attribute names -> state_dict loads)."""
    import torch
    import torch.nn as nn
    import torch.nn.functional as tF

    torch.manual_seed(seed)

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2d(3, 32, 3, stride=2, padding=1)
            c = 32
            for i, (c_out, stride) in enumerate(MOBILENET_CFG, start=1):
                setattr(self, f"dw{i}", nn.Conv2d(c, c, 3, stride=stride,
                                                  padding=1, groups=c))
                setattr(self, f"pw{i}", nn.Conv2d(c, c_out, 1))
                c = c_out
            self.fc = nn.Linear(1024, num_classes)

        def forward(self, x):
            x = tF.relu(self.conv1(x))
            for i in range(1, len(MOBILENET_CFG) + 1):
                x = tF.relu(getattr(self, f"dw{i}")(x))
                x = tF.relu(getattr(self, f"pw{i}")(x))
            x = tF.adaptive_avg_pool2d(x, (1, 1)).reshape(-1, 1024)
            return self.fc(x)

    return Net()
