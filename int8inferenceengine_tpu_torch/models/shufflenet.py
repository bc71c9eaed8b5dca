"""ShuffleNetV2 (x1.0): channel-split / channel-shuffle CNN family
(counterpart of ``int8inferenceengine_tpu.models.shufflenet``).

Its primitives
are pure *layout* ops in the quantized domain — ``F.split_channels`` (both
halves inherit the trunk's (scale, zp)) and ``F.channel_shuffle`` (a
permutation; quantization-transparent) — while the branch merge is a
calibrated ``QuantConcat``: after the right branch's convs the two halves
carry different scales, so the concat is a real requant boundary.  Its
depthwise convs (24, 58, 116 and 232 channels) run on kernel G1.

Like the rest of the zoo this is the BN-free variant (convs carry bias)
with a matching hand-written torch twin, flat attribute naming so the
twin's state_dict loads reference-style (single-dot keys).
"""

from __future__ import annotations

from ..config import DEFAULT_CONFIG, QuantConfig
from ..layers import Conv2d, Linear, QuantConcat
from ..module import Module
from ..ops import functional as F

__all__ = ["ShuffleNetV2", "torch_shufflenet_v2", "SHUFFLENET_V2_BLOCKS"]

# x1.0 stage widths (paper Table 5): stem 24, stages 116/232/464, head 1024.
_STAGES = [(116, 4), (232, 8), (464, 4)]


def _blocks():
    """Flatten stages to per-block (in_c, out_c, stride)."""
    blocks, c = [], 24
    for c_out, n in _STAGES:
        for j in range(n):
            blocks.append((c, c_out, 2 if j == 0 else 1))
            c = c_out
    return blocks


SHUFFLENET_V2_BLOCKS = _blocks()


class ShuffleNetV2(Module):
    """ShuffleNetV2 x1.0.

    Basic unit (stride 1): channel-split; right half runs 1x1+relu ->
    3x3 depthwise (linear) -> 1x1+relu; calibrated concat with the
    untouched left half; shuffle(2).  Downsample unit (stride 2): both
    branches run (left: depthwise s2 -> 1x1+relu; right: 1x1+relu ->
    depthwise s2 -> 1x1+relu), concat doubles channels, shuffle(2).
    """

    INPUT_SHAPE = (3, 224, 224)

    def __init__(self, num_classes: int = 10,
                 config: QuantConfig = DEFAULT_CONFIG, device=None):
        super().__init__(config, device)
        kw = dict(config=config, device=self.device)
        self.conv1 = Conv2d(3, 24, 3, stride=2, padding=1, **kw)
        for i, (c_in, c_out, s) in enumerate(SHUFFLENET_V2_BLOCKS, start=1):
            half = c_out // 2
            if s == 2:
                setattr(self, f"ldw{i}", Conv2d(c_in, c_in, 3, stride=2,
                                                padding=1, groups=c_in,
                                                **kw))
                setattr(self, f"l1_{i}", Conv2d(c_in, half, 1, **kw))
                r_in = c_in
            else:
                r_in = c_in // 2
            setattr(self, f"r1_{i}", Conv2d(r_in, half, 1, **kw))
            setattr(self, f"rdw{i}", Conv2d(half, half, 3, stride=s,
                                            padding=1, groups=half,
                                            **kw))
            setattr(self, f"r2_{i}", Conv2d(half, half, 1, **kw))
            setattr(self, f"cat{i}", QuantConcat(**kw))
        self.conv5 = Conv2d(464, 1024, 1, **kw)
        self.fc = Linear(1024, num_classes, **kw)

    def forward(self, x):
        x = F.relu(self.conv1(x))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for i, (c_in, c_out, s) in enumerate(SHUFFLENET_V2_BLOCKS, start=1):
            if s == 2:
                left = getattr(self, f"l1_{i}")(getattr(self, f"ldw{i}")(x))
                left = F.relu(left)
                right = x
            else:
                left, right = F.split_channels(x, 2)
            right = F.relu(getattr(self, f"r1_{i}")(right))
            right = getattr(self, f"rdw{i}")(right)
            right = F.relu(getattr(self, f"r2_{i}")(right))
            x = getattr(self, f"cat{i}")(left, right)
            x = F.channel_shuffle(x, 2)
        x = F.relu(self.conv5(x))
        x = F.adaptive_avg_pool2d_1x1(x)
        x = x.reshape(-1, 1024)
        return self.fc(x)


def torch_shufflenet_v2(num_classes: int = 10, seed: int = 42):
    """Matching torch oracle (same attribute names -> state_dict loads)."""
    import torch
    import torch.nn as nn
    import torch.nn.functional as tF

    torch.manual_seed(seed)

    def shuffle(x, g=2):
        n, c, h, w = x.shape
        return (x.reshape(n, g, c // g, h, w).transpose(1, 2)
                .reshape(n, c, h, w))

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2d(3, 24, 3, stride=2, padding=1)
            for i, (c_in, c_out, s) in enumerate(SHUFFLENET_V2_BLOCKS,
                                                 start=1):
                half = c_out // 2
                if s == 2:
                    setattr(self, f"ldw{i}", nn.Conv2d(c_in, c_in, 3,
                                                       stride=2, padding=1,
                                                       groups=c_in))
                    setattr(self, f"l1_{i}", nn.Conv2d(c_in, half, 1))
                    r_in = c_in
                else:
                    r_in = c_in // 2
                setattr(self, f"r1_{i}", nn.Conv2d(r_in, half, 1))
                setattr(self, f"rdw{i}", nn.Conv2d(half, half, 3, stride=s,
                                                   padding=1, groups=half))
                setattr(self, f"r2_{i}", nn.Conv2d(half, half, 1))
            self.conv5 = nn.Conv2d(464, 1024, 1)
            self.fc = nn.Linear(1024, num_classes)

        def forward(self, x):
            x = tF.relu(self.conv1(x))
            x = tF.max_pool2d(x, 3, 2, padding=1)
            for i, (c_in, c_out, s) in enumerate(SHUFFLENET_V2_BLOCKS,
                                                 start=1):
                if s == 2:
                    left = tF.relu(getattr(self, f"l1_{i}")(
                        getattr(self, f"ldw{i}")(x)))
                    right = x
                else:
                    left, right = x.chunk(2, dim=1)
                right = tF.relu(getattr(self, f"r1_{i}")(right))
                right = getattr(self, f"rdw{i}")(right)
                right = tF.relu(getattr(self, f"r2_{i}")(right))
                x = shuffle(torch.cat([left, right], dim=1))
            x = tF.relu(self.conv5(x))
            x = tF.adaptive_avg_pool2d(x, (1, 1)).reshape(-1, 1024)
            return self.fc(x)

    return Net()
