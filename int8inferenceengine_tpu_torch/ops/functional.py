"""Functional tensor ops: relu, max_pool2d, argmax, module-level quant ops
(counterpart of ``int8inferenceengine_tpu.ops.functional``).

They preserve quantization metadata exactly like the reference:

* ``relu`` on a quantized tensor clamps at the *zero_point* — quantized zero —
  and propagates (scale, zp).
* ``max_pool2d`` is a window max with scale/zp pass-through; the u8 identity
  element is 0.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..tensor import Tensor
from . import quant
from .conv import windows_nhwc


def relu(x: Tensor) -> Tensor:
    if x.quantized:
        out = x.data.clamp_min(x.zero_point)
    else:
        out = x.data.clamp_min(0)
    return Tensor(out, x.scale, x.zero_point, _nhwc=x._nhwc)


def _pool_extra_pad(size: int, k: int, s: int, p: int) -> int:
    """Extra high-side padding emulating torch's ceil_mode=True: output
    ceil((size+2p-k)/s)+1, with the torch constraint that the last window
    must start inside the input-or-left-pad region."""
    o = -(-(size + 2 * p - k) // s) + 1
    if (o - 1) * s >= size + p:
        o -= 1
    return max(0, (o - 1) * s + k - (size + 2 * p))


def max_pool2d(x: Tensor, kernel_size: int, stride: int,
               padding: int = 0, ceil_mode: bool = False) -> Tensor:
    """NCHW-semantics window max (square window), either layout.

    Floats go through ``torch.nn.functional.max_pool2d``, whose padding and
    ``ceil_mode`` are the semantics the reference follows.  Integer codes,
    which it does not take on CUDA, take one ``amax`` over the strided
    window view (``conv.windows_nhwc``); padded taps hold the dtype's least
    value (0 for u8 codes), so they never win.  A max is exact either way."""
    if x.dtype.is_floating_point:
        out = F.max_pool2d(x.logical_data, kernel_size, stride, padding,
                           ceil_mode=ceil_mode)
        if x._nhwc:
            out = out.permute(0, 2, 3, 1)
        return Tensor(out, x.scale, x.zero_point, _nhwc=x._nhwc)
    d = x.as_nhwc_data()
    eh = ew = 0
    if ceil_mode:
        eh = _pool_extra_pad(int(d.shape[1]), kernel_size, stride, padding)
        ew = _pool_extra_pad(int(d.shape[2]), kernel_size, stride, padding)
    if padding or eh or ew:
        d = F.pad(d, (0, 0, padding, padding + ew, padding, padding + eh),
                  value=torch.iinfo(d.dtype).min)
    out = windows_nhwc(d, kernel_size, kernel_size, stride).amax(dim=(3, 4))
    if not x._nhwc:
        out = out.permute(0, 3, 1, 2).contiguous()
    return Tensor(out, x.scale, x.zero_point, _nhwc=x._nhwc)


def argmax(x: Tensor, *args, **kwargs) -> Tensor:
    """Matches i8ie.argmax — numpy semantics, float32 result tensor."""
    res = np.float32(x.numpy().argmax(*args, **kwargs))
    return Tensor(torch.tensor(res, device=x.device))


def quantize(x: Tensor, scale: float, zero_point: int,
             rounding: str = "trunc") -> Tensor:
    """Module-level asymmetric u8 quantization."""
    q = quant.quantize_u8(x.data, scale, zero_point, rounding)
    return Tensor(q, scale, zero_point, _nhwc=x._nhwc)


def dequantize(x: Tensor) -> Tensor:
    """u8 -> f32 using the tensor's own (scale, zp)."""
    out = quant.dequantize_u8(x.data, x.scale, x.zero_point)
    return Tensor(out, _nhwc=x._nhwc)
