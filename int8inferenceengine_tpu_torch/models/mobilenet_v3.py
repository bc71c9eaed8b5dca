"""MobileNetV3 (Small/Large): hardswish + squeeze-excite CNN family
(counterpart of ``int8inferenceengine_tpu.models.mobilenet_v3``).

V3 is the first family whose quantization needs *calibrated nonlinearities*: hardswish and
the SE gate's hardsigmoid change the value distribution (unlike ReLU, which
is exact at the zero_point), so each site is a ``QuantAct`` with its own
observed output range, and the SE channel gating is a calibrated
``QuantMul``.  Everything else reuses the depthwise/pointwise machinery
from MobileNetV1/V2.

Like the rest of the zoo these are the BN-free variants (convs carry bias),
with matching hand-written torch twins for differential testing, flat
attribute naming so the twin's state_dict loads reference-style
(single-dot keys).
"""

from __future__ import annotations

from ..config import DEFAULT_CONFIG, QuantConfig
from ..layers import Conv2d, Linear, QuantAct, QuantAdd, QuantMul
from ..module import Module
from ..ops import functional as F

__all__ = ["MobileNetV3", "torch_mobilenet_v3", "V3_LARGE", "V3_SMALL"]


def _make_divisible(v, divisor=8):
    """Round channels to the nearest multiple of ``divisor`` (paper's rule)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


# Per-block (kernel, expanded_c, out_c, squeeze_excite, nonlinearity, stride)
# — the paper's Tables 1 and 2 (arXiv:1905.02244).  Stem in_c is 16.
V3_LARGE = [
    (3, 16, 16, False, "RE", 1),
    (3, 64, 24, False, "RE", 2),
    (3, 72, 24, False, "RE", 1),
    (5, 72, 40, True, "RE", 2),
    (5, 120, 40, True, "RE", 1),
    (5, 120, 40, True, "RE", 1),
    (3, 240, 80, False, "HS", 2),
    (3, 200, 80, False, "HS", 1),
    (3, 184, 80, False, "HS", 1),
    (3, 184, 80, False, "HS", 1),
    (3, 480, 112, True, "HS", 1),
    (3, 672, 112, True, "HS", 1),
    (5, 672, 160, True, "HS", 2),
    (5, 960, 160, True, "HS", 1),
    (5, 960, 160, True, "HS", 1),
]
V3_SMALL = [
    (3, 16, 16, True, "RE", 2),
    (3, 72, 24, False, "RE", 2),
    (3, 88, 24, False, "RE", 1),
    (5, 96, 40, True, "HS", 2),
    (5, 240, 40, True, "HS", 1),
    (5, 240, 40, True, "HS", 1),
    (5, 120, 48, True, "HS", 1),
    (5, 144, 48, True, "HS", 1),
    (5, 288, 96, True, "HS", 2),
    (5, 576, 96, True, "HS", 1),
    (5, 576, 96, True, "HS", 1),
]

# (blocks, last_conv_c, head_hidden_c) per variant
_VARIANTS = {
    "large": (V3_LARGE, 960, 1280),
    "small": (V3_SMALL, 576, 1024),
}


def _se_channels(exp_c):
    return _make_divisible(exp_c // 4, 8)


class MobileNetV3(Module):
    """MobileNetV3: inverted residuals + SE blocks + hardswish.

    Per block i: optional ``exp{i}`` 1x1 expand, ``dw{i}`` kxk depthwise,
    optional SE branch (``sefc1_{i}``/``sefc2_{i}`` 1x1 convs, ``segate{i}``
    hardsigmoid QuantAct, ``semul{i}`` QuantMul), ``pw{i}`` linear 1x1
    projection, ``add{i}`` residual when shape is kept.  HS sites get a
    dedicated ``QuantAct("hardswish")`` (``hs*`` attrs); RE sites use the
    calibration-free relu-at-zp.
    """

    INPUT_SHAPE = (3, 224, 224)

    def __init__(self, variant: str = "large", num_classes: int = 10,
                 config: QuantConfig = DEFAULT_CONFIG, device=None):
        super().__init__(config, device)
        kw = dict(config=config, device=self.device)
        if variant not in _VARIANTS:
            raise ValueError(f"variant must be one of {sorted(_VARIANTS)}")
        self.variant = variant
        blocks, last_c, head_c = _VARIANTS[variant]
        self.conv1 = Conv2d(3, 16, 3, stride=2, padding=1, **kw)
        self.hs_stem = QuantAct("hardswish", **kw)
        c = 16
        for i, (k, exp, out, se, nl, s) in enumerate(blocks, start=1):
            if exp != c:
                setattr(self, f"exp{i}", Conv2d(c, exp, 1, **kw))
            if nl == "HS":
                if exp != c:
                    setattr(self, f"hs{i}e", QuantAct("hardswish",
                                                      **kw))
                setattr(self, f"hs{i}d", QuantAct("hardswish", **kw))
            setattr(self, f"dw{i}", Conv2d(exp, exp, k, stride=s,
                                           padding=k // 2, groups=exp,
                                           **kw))
            if se:
                sc = _se_channels(exp)
                setattr(self, f"sefc1_{i}", Conv2d(exp, sc, 1, **kw))
                setattr(self, f"sefc2_{i}", Conv2d(sc, exp, 1, **kw))
                setattr(self, f"segate{i}", QuantAct("hardsigmoid",
                                                     **kw))
                setattr(self, f"semul{i}", QuantMul(**kw))
            setattr(self, f"pw{i}", Conv2d(exp, out, 1, **kw))
            if s == 1 and c == out:
                setattr(self, f"add{i}", QuantAdd(**kw))
            c = out
        self.conv_last = Conv2d(c, last_c, 1, **kw)
        self.hs_last = QuantAct("hardswish", **kw)
        self.fc1 = Linear(last_c, head_c, **kw)
        self.hs_fc1 = QuantAct("hardswish", **kw)
        self.fc2 = Linear(head_c, num_classes, **kw)
        self._blocks = blocks
        self._last_c = last_c

    def forward(self, x):
        x = self.hs_stem(self.conv1(x))
        c = 16
        for i, (k, exp, out, se, nl, s) in enumerate(self._blocks, start=1):
            identity = x
            if exp != c:
                x = getattr(self, f"exp{i}")(x)
                x = (getattr(self, f"hs{i}e")(x) if nl == "HS"
                     else F.relu(x))
            x = getattr(self, f"dw{i}")(x)
            x = getattr(self, f"hs{i}d")(x) if nl == "HS" else F.relu(x)
            if se:
                g = F.adaptive_avg_pool2d_1x1(x)
                g = F.relu(getattr(self, f"sefc1_{i}")(g))
                g = getattr(self, f"segate{i}")(
                    getattr(self, f"sefc2_{i}")(g))
                x = getattr(self, f"semul{i}")(x, g)
            x = getattr(self, f"pw{i}")(x)
            if s == 1 and c == out:
                x = getattr(self, f"add{i}")(x, identity)
            c = out
        x = self.hs_last(self.conv_last(x))
        x = F.adaptive_avg_pool2d_1x1(x)
        x = x.reshape(-1, self._last_c)
        x = self.hs_fc1(self.fc1(x))
        return self.fc2(x)


def torch_mobilenet_v3(variant: str = "large", num_classes: int = 10,
                       seed: int = 42):
    """Matching torch oracle (same attribute names -> state_dict loads)."""
    import torch
    import torch.nn as nn
    import torch.nn.functional as tF

    torch.manual_seed(seed)
    blocks, last_c, head_c = _VARIANTS[variant]

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2d(3, 16, 3, stride=2, padding=1)
            c = 16
            for i, (k, exp, out, se, nl, s) in enumerate(blocks, start=1):
                if exp != c:
                    setattr(self, f"exp{i}", nn.Conv2d(c, exp, 1))
                setattr(self, f"dw{i}", nn.Conv2d(exp, exp, k, stride=s,
                                                  padding=k // 2, groups=exp))
                if se:
                    sc = _se_channels(exp)
                    setattr(self, f"sefc1_{i}", nn.Conv2d(exp, sc, 1))
                    setattr(self, f"sefc2_{i}", nn.Conv2d(sc, exp, 1))
                setattr(self, f"pw{i}", nn.Conv2d(exp, out, 1))
                c = out
            self.conv_last = nn.Conv2d(c, last_c, 1)
            self.fc1 = nn.Linear(last_c, head_c)
            self.fc2 = nn.Linear(head_c, num_classes)

        def forward(self, x):
            x = tF.hardswish(self.conv1(x))
            c = 16
            for i, (k, exp, out, se, nl, s) in enumerate(blocks, start=1):
                act = tF.hardswish if nl == "HS" else tF.relu
                identity = x
                if exp != c:
                    x = act(getattr(self, f"exp{i}")(x))
                x = act(getattr(self, f"dw{i}")(x))
                if se:
                    g = tF.adaptive_avg_pool2d(x, (1, 1))
                    g = tF.relu(getattr(self, f"sefc1_{i}")(g))
                    g = tF.hardsigmoid(getattr(self, f"sefc2_{i}")(g))
                    x = x * g
                x = getattr(self, f"pw{i}")(x)
                if s == 1 and c == out:
                    x = x + identity
                c = out
            x = tF.hardswish(self.conv_last(x))
            x = tF.adaptive_avg_pool2d(x, (1, 1)).reshape(-1, last_c)
            x = tF.hardswish(self.fc1(x))
            return self.fc2(x)

    return Net()
