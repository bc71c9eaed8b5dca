"""Functional tensor ops: relu, max_pool2d, argmax, module-level quant ops,
the activation table and the attention head layout ops (split, merge and
the grouped-query ``repeat_kv``)
(counterpart of ``int8inferenceengine_tpu.ops.functional``).

They preserve quantization metadata exactly like the reference:

* ``relu`` on a quantized tensor clamps at the *zero_point* — quantized zero —
  and propagates (scale, zp).
* ``max_pool2d`` is a window max with scale/zp pass-through; the u8 identity
  element is 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..tensor import Tensor
from . import quant
from .conv import windows_nhwc
from .quant import f32

_SQRT_HALF = float(np.float32(math.sqrt(0.5)))
_SQRT_2_OVER_PI = float(np.float32(math.sqrt(2 / math.pi)))


def _relu6(x):
    return x.clamp(0.0, 6.0)


def _hardsigmoid(x):
    return _relu6(x + f32(3.0, x.device)) / f32(6.0, x.device)


def rounded64(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` (``torch.exp``, ``torch.erfc``) of float32 ``x`` evaluated in
    float64 and rounded once to float32: the correctly rounded result, the
    same on the card and on the CPU, whose float32 libms differ by an ULP.
    That ULP moved a code on a truncation boundary and a decoder's logits
    on the card then differed from its CPU copy's (``chip_smoke.py``)."""
    return fn(x.to(torch.float64)).to(torch.float32)


def _sigmoid(x):
    one = f32(1.0, x.device)
    return one / (one + rounded64(torch.exp, -x))


def _gelu(x):
    # 0.5*x*erfc(-x*sqrt(1/2)): the exact form jax.nn.gelu(approximate=
    # False) evaluates, in its order, not x*0.5*(1+erf(x/sqrt(2)))
    return (f32(0.5, x.device) * x) * rounded64(
        torch.erfc, -x * f32(_SQRT_HALF, x.device))


def _gelu_tanh(x):
    inner = x + f32(0.044715, x.device) * (x * x * x)
    cdf = f32(0.5, x.device) * (f32(1.0, x.device) + torch.tanh(
        f32(_SQRT_2_OVER_PI, x.device) * inner))
    return x * cdf


# Float-domain activations of QuantAct's FP32 and INT8 paths and of the GEMM
# kernel's fused act epilogue: each replays the JAX package's formula of the
# same name (ops/functional.ACTIVATIONS there) op for op, with every scalar a
# float32 tensor on the operand's device (see ops/quant.py).
ACTIVATIONS = {
    "relu": lambda x: x.clamp_min(0.0),
    "relu6": _relu6,
    "hardsigmoid": _hardsigmoid,
    "hardswish": lambda x: x * _hardsigmoid(x),
    "sigmoid": _sigmoid,
    "silu": lambda x: x * _sigmoid(x),
    "gelu": _gelu,
    "gelu_tanh": _gelu_tanh,
}


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


def split_heads(x: Tensor, num_heads: int) -> Tensor:
    """[B, T, C] -> [B, H, T, C/H] (quantization-transparent layout op)."""
    b, t, c = x.data.shape
    if c % num_heads:
        raise ValueError(f"dim {c} not divisible by heads {num_heads}")
    d = x.data.reshape(b, t, num_heads, c // num_heads)
    return Tensor(d.permute(0, 2, 1, 3), x.scale, x.zero_point)


def repeat_kv(x: Tensor, group: int) -> Tensor:
    """[B, Hkv, T, D] -> [B, Hkv*group, T, D]: query head h reads kv head
    h // group (grouped-query attention, repeat-interleave order).  Used on
    the prefill path only; the decode attention keeps the cache
    kv-compact."""
    if group == 1:
        return x
    b, hkv, t, d = x.data.shape
    out = x.data[:, :, None].expand(b, hkv, group, t, d)
    return Tensor(out.reshape(b, hkv * group, t, d), x.scale, x.zero_point)


def merge_heads(x: Tensor) -> Tensor:
    """[B, H, T, D] -> [B, T, H*D] (inverse of ``split_heads``)."""
    b, h, t, d = x.data.shape
    out = x.data.permute(0, 2, 1, 3).reshape(b, t, h * d)
    return Tensor(out, x.scale, x.zero_point)


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
