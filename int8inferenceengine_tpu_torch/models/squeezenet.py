"""SqueezeNet v1.1: the Fire-module family (counterpart of
``int8inferenceengine_tpu.models.squeezenet``).

Fire modules are the simplest branching topology — each
block SPLITS an activation through two parallel expand convs and CONCATS the
results — which exercises ``layers.QuantConcat`` (per-input requantization to
one calibrated output range) and ``max_pool2d(ceil_mode=True)``, neither of
which a chain model touches.  Architecture follows the v1.1 variant
(Iandola et al. 2016; torchvision squeezenet1_1 geometry), with a matching
hand-written torch twin for the differential workflow.

The classifier is the fully-convolutional head: conv10 1x1 to num_classes,
ReLU, global average pool — no Linear at all, so this model also covers the
conv-only end-to-end path.
"""

from __future__ import annotations

from ..config import DEFAULT_CONFIG, QuantConfig
from ..layers import Conv2d, QuantConcat
from ..module import Module
from ..ops import functional as F

__all__ = ["SqueezeNet", "torch_squeezenet", "FIRE_CFG"]

# (squeeze, expand1x1, expand3x3) per Fire module, SqueezeNet v1.1.
FIRE_CFG = [(16, 64, 64), (16, 64, 64),
            (32, 128, 128), (32, 128, 128),
            (48, 192, 192), (48, 192, 192),
            (64, 256, 256), (64, 256, 256)]
# Fire indices (2..9) after which a ceil-mode max-pool runs, v1.1 placement.
_POOL_AFTER = {1, 3}   # pool after fire3 and fire5 (0-based cfg index 1, 3)


class Fire(Module):
    """squeeze 1x1 -> relu -> [expand 1x1 || expand 3x3] -> relu -> concat."""

    def __init__(self, c_in: int, squeeze: int, e1: int, e3: int,
                 config: QuantConfig = DEFAULT_CONFIG, device=None):
        super().__init__(config, device)
        kw = dict(config=config, device=self.device)
        self.squeeze = Conv2d(c_in, squeeze, 1, **kw)
        self.expand1 = Conv2d(squeeze, e1, 1, **kw)
        self.expand3 = Conv2d(squeeze, e3, 3, padding=1, **kw)
        self.cat = QuantConcat(**kw)

    def forward(self, x):
        s = F.relu(self.squeeze(x))
        return self.cat(F.relu(self.expand1(s)), F.relu(self.expand3(s)))

    def __call__(self, x):  # plain sub-module call, no quant wrapping
        return self.forward(x)


class SqueezeNet(Module):
    INPUT_SHAPE = (3, 224, 224)

    def __init__(self, num_classes: int = 10,
                 config: QuantConfig = DEFAULT_CONFIG, device=None):
        super().__init__(config, device)
        kw = dict(config=config, device=self.device)
        self.conv1 = Conv2d(3, 64, 3, stride=2, **kw)
        c = 64
        for i, (sq, e1, e3) in enumerate(FIRE_CFG, start=2):
            setattr(self, f"fire{i}", Fire(c, sq, e1, e3, **kw))
            c = e1 + e3
        self.conv10 = Conv2d(c, num_classes, 1, **kw)
        self.num_classes = num_classes

    def forward(self, x):
        x = F.relu(self.conv1(x))
        x = F.max_pool2d(x, 3, 2, ceil_mode=True)
        for i in range(2, 2 + len(FIRE_CFG)):
            x = getattr(self, f"fire{i}")(x)
            if (i - 2) in _POOL_AFTER:
                x = F.max_pool2d(x, 3, 2, ceil_mode=True)
        x = F.relu(self.conv10(x))
        x = F.adaptive_avg_pool2d_1x1(x)
        return x.reshape(-1, self.num_classes)


def torch_squeezenet(num_classes: int = 10, seed: int = 42):
    """Matching torch oracle (same attribute paths -> state_dict loads)."""
    import torch
    import torch.nn as nn
    import torch.nn.functional as tF

    torch.manual_seed(seed)

    class TorchFire(nn.Module):
        def __init__(self, c_in, sq, e1, e3):
            super().__init__()
            self.squeeze = nn.Conv2d(c_in, sq, 1)
            self.expand1 = nn.Conv2d(sq, e1, 1)
            self.expand3 = nn.Conv2d(sq, e3, 3, padding=1)

        def forward(self, x):
            s = tF.relu(self.squeeze(x))
            return torch.cat([tF.relu(self.expand1(s)),
                              tF.relu(self.expand3(s))], dim=1)

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2d(3, 64, 3, stride=2)
            c = 64
            for i, (sq, e1, e3) in enumerate(FIRE_CFG, start=2):
                setattr(self, f"fire{i}", TorchFire(c, sq, e1, e3))
                c = e1 + e3
            self.conv10 = nn.Conv2d(c, num_classes, 1)
            self.num_classes = num_classes

        def forward(self, x):
            x = tF.relu(self.conv1(x))
            x = tF.max_pool2d(x, 3, 2, ceil_mode=True)
            for i in range(2, 2 + len(FIRE_CFG)):
                x = getattr(self, f"fire{i}")(x)
                if (i - 2) in _POOL_AFTER:
                    x = tF.max_pool2d(x, 3, 2, ceil_mode=True)
            x = tF.relu(self.conv10(x))
            x = tF.adaptive_avg_pool2d(x, (1, 1))
            return x.reshape(-1, self.num_classes)

    return Net()
