"""DenseNet-121: dense connectivity via repeated calibrated concats
(counterpart of ``int8inferenceengine_tpu.models.densenet``).

Dense blocks
stress the one quantized structural op no other family repeats at depth —
``QuantConcat``.  Every dense layer appends its ``growth_rate`` new channels
to the running feature map, so the prefix is re-requantized at each of the
58 concat boundaries; calibrating every one of them (rather than assuming a
shared scale) is exactly the per-boundary-requant discipline the reference
applies at layer outputs.

This is the BN-free variant (convs carry bias, conv→ReLU ordering instead
of the paper's BN→ReLU→conv pre-activation), with a matching hand-written
torch twin for differential testing — the BN-folding workflow is exercised
by the ResNet family.
"""

from __future__ import annotations

from ..config import DEFAULT_CONFIG, QuantConfig
from ..layers import Conv2d, Linear, QuantConcat
from ..module import Module
from ..ops import functional as F

__all__ = ["DenseNet121", "torch_densenet121", "DENSENET121_BLOCKS"]

DENSENET121_BLOCKS = (6, 12, 24, 16)
_GROWTH = 32
_BOTTLENECK = 4   # 1x1 bottleneck width = _BOTTLENECK * growth


class DenseNet121(Module):
    """DenseNet-121: blocks of (1x1 bottleneck → 3x3 growth) dense layers.

    Flat naming so the torch twin's state_dict loads reference-style:
    ``conv0`` stem; block b layer l: ``b{b}l{l}c1`` (1x1), ``b{b}l{l}c2``
    (3x3), ``b{b}l{l}cat`` (QuantConcat, weightless); transition t after
    block b: ``t{b}`` (1x1 halving conv, then 2x2 avg-pool); ``fc`` head.
    """

    INPUT_SHAPE = (3, 224, 224)

    def __init__(self, num_classes: int = 10,
                 config: QuantConfig = DEFAULT_CONFIG, device=None):
        super().__init__(config, device)
        kw = dict(config=config, device=self.device)
        self.conv0 = Conv2d(3, 64, 7, stride=2, padding=3, **kw)
        c = 64
        for b, n_layers in enumerate(DENSENET121_BLOCKS, start=1):
            for l in range(1, n_layers + 1):
                setattr(self, f"b{b}l{l}c1",
                        Conv2d(c, _BOTTLENECK * _GROWTH, 1, **kw))
                setattr(self, f"b{b}l{l}c2",
                        Conv2d(_BOTTLENECK * _GROWTH, _GROWTH, 3, padding=1,
                               **kw))
                setattr(self, f"b{b}l{l}cat", QuantConcat(**kw))
                c += _GROWTH
            if b < len(DENSENET121_BLOCKS):
                setattr(self, f"t{b}", Conv2d(c, c // 2, 1, **kw))
                c //= 2
        self.fc = Linear(c, num_classes, **kw)
        self._final_c = c

    def forward(self, x):
        x = F.relu(self.conv0(x))
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
        for b, n_layers in enumerate(DENSENET121_BLOCKS, start=1):
            for l in range(1, n_layers + 1):
                f = F.relu(getattr(self, f"b{b}l{l}c1")(x))
                f = F.relu(getattr(self, f"b{b}l{l}c2")(f))
                x = getattr(self, f"b{b}l{l}cat")(x, f)
            if b < len(DENSENET121_BLOCKS):
                x = getattr(self, f"t{b}")(x)
                x = F.avg_pool2d(x, kernel_size=2, stride=2)
        x = F.adaptive_avg_pool2d_1x1(x)
        x = x.reshape(-1, self._final_c)
        return self.fc(x)


def torch_densenet121(num_classes: int = 10, seed: int = 42):
    """Matching torch oracle (same attribute names -> state_dict loads)."""
    import torch
    import torch.nn as nn
    import torch.nn.functional as tF

    torch.manual_seed(seed)

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv0 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
            c = 64
            for b, n_layers in enumerate(DENSENET121_BLOCKS, start=1):
                for l in range(1, n_layers + 1):
                    setattr(self, f"b{b}l{l}c1",
                            nn.Conv2d(c, _BOTTLENECK * _GROWTH, 1))
                    setattr(self, f"b{b}l{l}c2",
                            nn.Conv2d(_BOTTLENECK * _GROWTH, _GROWTH, 3,
                                      padding=1))
                    c += _GROWTH
                if b < len(DENSENET121_BLOCKS):
                    setattr(self, f"t{b}", nn.Conv2d(c, c // 2, 1))
                    c //= 2
            self.fc = nn.Linear(c, num_classes)
            self._final_c = c

        def forward(self, x):
            x = tF.relu(self.conv0(x))
            x = tF.max_pool2d(x, 3, 2, padding=1)
            for b, n_layers in enumerate(DENSENET121_BLOCKS, start=1):
                for l in range(1, n_layers + 1):
                    f = tF.relu(getattr(self, f"b{b}l{l}c1")(x))
                    f = tF.relu(getattr(self, f"b{b}l{l}c2")(f))
                    x = torch.cat([x, f], dim=1)
                if b < len(DENSENET121_BLOCKS):
                    x = getattr(self, f"t{b}")(x)
                    x = tF.avg_pool2d(x, 2, 2)
            x = tF.adaptive_avg_pool2d(x, (1, 1)).reshape(-1, self._final_c)
            return self.fc(x)

    return Net()
