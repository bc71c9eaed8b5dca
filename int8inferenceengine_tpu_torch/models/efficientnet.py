"""EfficientNet-B0: MBConv (SE + SiLU) compound-scaled CNN family
(counterpart of ``int8inferenceengine_tpu.models.efficientnet``).

The most demanding PTQ workload
in this zoo — *every* activation is an unbounded SiLU (calibrated
``QuantAct``) and every block carries a squeeze-excite branch whose gate is
a true sigmoid (``QuantAct("sigmoid")``) feeding a calibrated ``QuantMul``.
Like the rest of the zoo this is the BN-free variant (convs carry bias)
with a matching hand-written torch twin, flat attribute naming so the
twin's state_dict loads reference-style (single-dot keys).
"""

from __future__ import annotations

from ..config import DEFAULT_CONFIG, QuantConfig
from ..layers import Conv2d, Linear, QuantAct, QuantAdd, QuantMul
from ..module import Module
from ..ops import functional as F

__all__ = ["EfficientNetB0", "torch_efficientnet_b0", "B0_BLOCKS"]

# B0 stage table (expansion t, out_c, repeats n, first-stride s, kernel k)
# — the paper's Table 1 (arXiv:1905.11946); stem out is 32.
_B0_STAGES = [
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
]


def _b0_blocks():
    """Flatten stages to per-block (in_c, out_c, t, stride, k, residual)."""
    blocks, c = [], 32
    for t, c_out, n, s, k in _B0_STAGES:
        for j in range(n):
            stride = s if j == 0 else 1
            blocks.append((c, c_out, t, stride, k,
                           stride == 1 and c == c_out))
            c = c_out
    return blocks


B0_BLOCKS = _b0_blocks()


class EfficientNetB0(Module):
    """EfficientNet-B0: MBConv blocks with SE on every block.

    Per block i: optional ``exp{i}`` 1x1 expand + SiLU, ``dw{i}`` kxk
    depthwise + SiLU, SE branch (``sefc1_{i}`` + SiLU, ``sefc2_{i}`` +
    sigmoid gate, ``semul{i}``; squeeze width = in_c/4 of the *block input*,
    the paper's rule), ``pw{i}`` linear 1x1 projection, ``add{i}`` residual
    when shape is kept.  SiLU sites are ``si{i}e``/``si{i}d``/``si{i}s``
    QuantActs.
    """

    INPUT_SHAPE = (3, 224, 224)

    def __init__(self, num_classes: int = 10,
                 config: QuantConfig = DEFAULT_CONFIG, device=None):
        super().__init__(config, device)
        kw = dict(config=config, device=self.device)
        self.conv1 = Conv2d(3, 32, 3, stride=2, padding=1, **kw)
        self.si_stem = QuantAct("silu", **kw)
        for i, (c_in, c_out, t, stride, k, res) in enumerate(
                B0_BLOCKS, start=1):
            hid = c_in * t
            if t != 1:
                setattr(self, f"exp{i}", Conv2d(c_in, hid, 1, **kw))
                setattr(self, f"si{i}e", QuantAct("silu", **kw))
            setattr(self, f"dw{i}", Conv2d(hid, hid, k, stride=stride,
                                           padding=k // 2, groups=hid,
                                           **kw))
            setattr(self, f"si{i}d", QuantAct("silu", **kw))
            sc = max(1, c_in // 4)
            setattr(self, f"sefc1_{i}", Conv2d(hid, sc, 1, **kw))
            setattr(self, f"si{i}s", QuantAct("silu", **kw))
            setattr(self, f"sefc2_{i}", Conv2d(sc, hid, 1, **kw))
            setattr(self, f"segate{i}", QuantAct("sigmoid", **kw))
            setattr(self, f"semul{i}", QuantMul(**kw))
            setattr(self, f"pw{i}", Conv2d(hid, c_out, 1, **kw))
            if res:
                setattr(self, f"add{i}", QuantAdd(**kw))
        self.conv_last = Conv2d(320, 1280, 1, **kw)
        self.si_last = QuantAct("silu", **kw)
        self.fc = Linear(1280, num_classes, **kw)

    def forward(self, x):
        x = self.si_stem(self.conv1(x))
        for i, (c_in, c_out, t, stride, k, res) in enumerate(
                B0_BLOCKS, start=1):
            identity = x
            if t != 1:
                x = getattr(self, f"si{i}e")(getattr(self, f"exp{i}")(x))
            x = getattr(self, f"si{i}d")(getattr(self, f"dw{i}")(x))
            g = F.adaptive_avg_pool2d_1x1(x)
            g = getattr(self, f"si{i}s")(getattr(self, f"sefc1_{i}")(g))
            g = getattr(self, f"segate{i}")(getattr(self, f"sefc2_{i}")(g))
            x = getattr(self, f"semul{i}")(x, g)
            x = getattr(self, f"pw{i}")(x)
            if res:
                x = getattr(self, f"add{i}")(x, identity)
        x = self.si_last(self.conv_last(x))
        x = F.adaptive_avg_pool2d_1x1(x)
        x = x.reshape(-1, 1280)
        return self.fc(x)


def torch_efficientnet_b0(num_classes: int = 10, seed: int = 42):
    """Matching torch oracle (same attribute names -> state_dict loads)."""
    import torch
    import torch.nn as nn
    import torch.nn.functional as tF

    torch.manual_seed(seed)

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2d(3, 32, 3, stride=2, padding=1)
            for i, (c_in, c_out, t, stride, k, res) in enumerate(
                    B0_BLOCKS, start=1):
                hid = c_in * t
                if t != 1:
                    setattr(self, f"exp{i}", nn.Conv2d(c_in, hid, 1))
                setattr(self, f"dw{i}", nn.Conv2d(hid, hid, k, stride=stride,
                                                  padding=k // 2, groups=hid))
                sc = max(1, c_in // 4)
                setattr(self, f"sefc1_{i}", nn.Conv2d(hid, sc, 1))
                setattr(self, f"sefc2_{i}", nn.Conv2d(sc, hid, 1))
                setattr(self, f"pw{i}", nn.Conv2d(hid, c_out, 1))
            self.conv_last = nn.Conv2d(320, 1280, 1)
            self.fc = nn.Linear(1280, num_classes)

        def forward(self, x):
            x = tF.silu(self.conv1(x))
            for i, (c_in, c_out, t, stride, k, res) in enumerate(
                    B0_BLOCKS, start=1):
                identity = x
                if t != 1:
                    x = tF.silu(getattr(self, f"exp{i}")(x))
                x = tF.silu(getattr(self, f"dw{i}")(x))
                g = tF.adaptive_avg_pool2d(x, (1, 1))
                g = tF.silu(getattr(self, f"sefc1_{i}")(g))
                g = torch.sigmoid(getattr(self, f"sefc2_{i}")(g))
                x = x * g
                x = getattr(self, f"pw{i}")(x)
                if res:
                    x = x + identity
            x = tF.silu(self.conv_last(x))
            x = tF.adaptive_avg_pool2d(x, (1, 1)).reshape(-1, 1280)
            return self.fc(x)

    return Net()
