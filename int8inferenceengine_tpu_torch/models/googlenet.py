"""GoogLeNet (Inception v1): the 4-way branch-and-concat family
(counterpart of ``int8inferenceengine_tpu.models.googlenet``).

Exercises ``QuantConcat`` with
four parallel branches per block — including a branch whose first op is a
stride-1 padded max-pool (scale/zp pass-through INTO a conv) — the most
branch-heavy topology in the zoo.  Geometry follows torchvision's
``googlenet`` (aux classifiers omitted — inference engine), but BN-free:
convs carry bias and ReLU directly, with a matching hand-written torch twin
(same pattern as models/mobilenet.py — the BN-folding workflow is covered by
the ResNet family).
"""

from __future__ import annotations

from ..config import DEFAULT_CONFIG, QuantConfig
from ..layers import Conv2d, Linear, QuantConcat
from ..module import Module
from ..ops import functional as F

__all__ = ["GoogLeNet", "torch_googlenet", "INCEPTION_CFG"]

# (in_c, b1, b2_squeeze, b2, b3_squeeze, b3, b4) per inception block,
# torchvision googlenet geometry.
INCEPTION_CFG = {
    "3a": (192, 64, 96, 128, 16, 32, 32),
    "3b": (256, 128, 128, 192, 32, 96, 64),
    "4a": (480, 192, 96, 208, 16, 48, 64),
    "4b": (512, 160, 112, 224, 24, 64, 64),
    "4c": (512, 128, 128, 256, 24, 64, 64),
    "4d": (512, 112, 144, 288, 32, 64, 64),
    "4e": (528, 256, 160, 320, 32, 128, 128),
    "5a": (832, 256, 160, 320, 32, 128, 128),
    "5b": (832, 384, 192, 384, 48, 128, 128),
}
_POOL_AFTER = {"3b": (3, 2), "4e": (2, 2)}  # (kernel, stride), ceil mode


class Inception(Module):
    """[1x1 || 1x1->3x3 || 1x1->5x5 || maxpool3s1p1->1x1] -> concat."""

    def __init__(self, c_in, b1, sq3, b3, sq5, b5, b4,
                 config: QuantConfig = DEFAULT_CONFIG, device=None):
        super().__init__(config, device)
        kw = dict(config=config, device=self.device)
        self.branch1 = Conv2d(c_in, b1, 1, **kw)
        self.branch2a = Conv2d(c_in, sq3, 1, **kw)
        self.branch2b = Conv2d(sq3, b3, 3, padding=1, **kw)
        self.branch3a = Conv2d(c_in, sq5, 1, **kw)
        self.branch3b = Conv2d(sq5, b5, 5, padding=2, **kw)
        self.branch4 = Conv2d(c_in, b4, 1, **kw)
        self.cat = QuantConcat(**kw)

    def forward(self, x):
        p1 = F.relu(self.branch1(x))
        p2 = F.relu(self.branch2b(F.relu(self.branch2a(x))))
        p3 = F.relu(self.branch3b(F.relu(self.branch3a(x))))
        p4 = F.relu(self.branch4(F.max_pool2d(x, 3, 1, padding=1)))
        return self.cat(p1, p2, p3, p4)

    def __call__(self, x):  # plain sub-module call, no quant wrapping
        return self.forward(x)


class GoogLeNet(Module):
    INPUT_SHAPE = (3, 224, 224)

    def __init__(self, num_classes: int = 10,
                 config: QuantConfig = DEFAULT_CONFIG, device=None):
        super().__init__(config, device)
        kw = dict(config=config, device=self.device)
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, **kw)
        self.conv2 = Conv2d(64, 64, 1, **kw)
        self.conv3 = Conv2d(64, 192, 3, padding=1, **kw)
        for name, (c_in, b1, sq3, b3, sq5, b5, b4) in INCEPTION_CFG.items():
            setattr(self, f"inception{name}",
                    Inception(c_in, b1, sq3, b3, sq5, b5, b4, **kw))
        self.fc = Linear(1024, num_classes, **kw)

    def forward(self, x):
        x = F.relu(self.conv1(x))
        x = F.max_pool2d(x, 3, 2, ceil_mode=True)
        x = F.relu(self.conv2(x))
        x = F.relu(self.conv3(x))
        x = F.max_pool2d(x, 3, 2, ceil_mode=True)
        for name in INCEPTION_CFG:
            x = getattr(self, f"inception{name}")(x)
            if name in _POOL_AFTER:
                k, s = _POOL_AFTER[name]
                x = F.max_pool2d(x, k, s, ceil_mode=True)
        x = F.adaptive_avg_pool2d_1x1(x)
        return self.fc(x.reshape(-1, 1024))


def torch_googlenet(num_classes: int = 10, seed: int = 42):
    """Matching torch oracle (same attribute paths -> state_dict loads)."""
    import torch
    import torch.nn as nn
    import torch.nn.functional as tF

    torch.manual_seed(seed)

    class TorchInception(nn.Module):
        def __init__(self, c_in, b1, sq3, b3, sq5, b5, b4):
            super().__init__()
            self.branch1 = nn.Conv2d(c_in, b1, 1)
            self.branch2a = nn.Conv2d(c_in, sq3, 1)
            self.branch2b = nn.Conv2d(sq3, b3, 3, padding=1)
            self.branch3a = nn.Conv2d(c_in, sq5, 1)
            self.branch3b = nn.Conv2d(sq5, b5, 5, padding=2)
            self.branch4 = nn.Conv2d(c_in, b4, 1)

        def forward(self, x):
            p1 = tF.relu(self.branch1(x))
            p2 = tF.relu(self.branch2b(tF.relu(self.branch2a(x))))
            p3 = tF.relu(self.branch3b(tF.relu(self.branch3a(x))))
            p4 = tF.relu(self.branch4(tF.max_pool2d(x, 3, 1, padding=1)))
            return torch.cat([p1, p2, p3, p4], dim=1)

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
            self.conv2 = nn.Conv2d(64, 64, 1)
            self.conv3 = nn.Conv2d(64, 192, 3, padding=1)
            for name, (c_in, b1, sq3, b3, sq5, b5, b4) in \
                    INCEPTION_CFG.items():
                setattr(self, f"inception{name}",
                        TorchInception(c_in, b1, sq3, b3, sq5, b5, b4))
            self.fc = nn.Linear(1024, num_classes)

        def forward(self, x):
            x = tF.relu(self.conv1(x))
            x = tF.max_pool2d(x, 3, 2, ceil_mode=True)
            x = tF.relu(self.conv2(x))
            x = tF.relu(self.conv3(x))
            x = tF.max_pool2d(x, 3, 2, ceil_mode=True)
            for name in INCEPTION_CFG:
                x = getattr(self, f"inception{name}")(x)
                if name in _POOL_AFTER:
                    k, s = _POOL_AFTER[name]
                    x = tF.max_pool2d(x, k, s, ceil_mode=True)
            x = tF.adaptive_avg_pool2d(x, (1, 1))
            return self.fc(x.reshape(-1, 1024))

    return Net()
