"""Functional tensor ops: relu, the pools, argmax, module-level quant ops,
the activation table, the channel layout ops (shuffle, split), the token
layout ops of the encoders (``to_tokens``, ``select_token``) and the
attention head layout ops (split, merge and the grouped-query
``repeat_kv``) (counterpart of ``int8inferenceengine_tpu.ops.functional``).

They preserve quantization metadata exactly like the reference:

* ``relu`` on a quantized tensor clamps at the *zero_point* — quantized zero —
  and propagates (scale, zp).
* ``max_pool2d`` is a window max with scale/zp pass-through; the u8 identity
  element is 0.
* ``avg_pool2d`` and ``adaptive_avg_pool2d_1x1`` average the u8 codes and
  truncate back to u8 at the same (scale, zp).
* ``channel_shuffle`` and ``split_channels`` move channels only.
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
    float64 and rounded once to float32 (a bfloat16 ``x``, the glue under
    ``QuantConfig.glue_dtype``, to bfloat16): the correctly rounded result, the
    same on the card and on the CPU, whose float32 libms differ by an ULP.
    That ULP moved a code on a truncation boundary and a decoder's logits
    on the card then differed from its CPU copy's (``chip_smoke.py``)."""
    return fn(x.to(torch.float64)).to(x.dtype)


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
    x._no_ingest("relu")
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
    x._no_ingest("max_pool2d")
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


def _mean_cast(total: torch.Tensor, count: int, like: Tensor) -> Tensor:
    """``total / count`` in float32 (a true division by a float32 tensor on
    the operand's device, never a Python float), cast back to ``like``'s
    dtype: u8 codes truncate, at ``like``'s (scale, zp)."""
    out = (total / f32(float(count), total.device)).to(like.dtype)
    return Tensor(out, like.scale, like.zero_point, _nhwc=like._nhwc)


def avg_pool2d(x: Tensor, kernel_size: int, stride: int) -> Tensor:
    """VALID window mean (square window), either layout.  On u8 codes the
    window sum is taken in float32, exact in any order (below 2^24), so the
    one rounding is the division; the truncated mean keeps the input's
    (scale, zp), as the JAX package's does (mean(x) = (mean(q) - zp) * s)."""
    x._no_ingest("avg_pool2d")
    d = x.as_nhwc_data().to(torch.float32)
    total = windows_nhwc(d, kernel_size, kernel_size, stride).sum(dim=(3, 4))
    if not x._nhwc:
        total = total.permute(0, 3, 1, 2)
    return _mean_cast(total, kernel_size * kernel_size, x)


def adaptive_avg_pool2d_1x1(x: Tensor) -> Tensor:
    """Global average pool to 1 x 1 (the CNN heads, squeeze-excite): the
    float32 sum over H and W divided by H * W, then cast as ``avg_pool2d``
    does.  u8 codes are summed as int32 (exact) before the float32
    division."""
    x._no_ingest("adaptive_avg_pool2d_1x1")
    axes = (1, 2) if x._nhwc else (2, 3)
    if x.quantized:
        total = x.data.sum(dim=axes, keepdim=True, dtype=torch.int32).to(
            torch.float32)
    else:
        total = x.data.to(torch.float32).sum(dim=axes, keepdim=True)
    return _mean_cast(total, x.data.shape[axes[0]] * x.data.shape[axes[1]],
                      x)


def channel_shuffle(x: Tensor, groups: int) -> Tensor:
    """ShuffleNet's channel permutation: the channels as [groups, C/groups],
    transposed.  A layout op: (scale, zp) pass through."""
    x._no_ingest("channel_shuffle")
    axis = 3 if x._nhwc else 1
    shape = tuple(x.data.shape)
    c = shape[axis]
    if c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    split = shape[:axis] + (groups, c // groups) + shape[axis + 1:]
    out = x.data.reshape(split).transpose(axis, axis + 1).reshape(shape)
    return Tensor(out, x.scale, x.zero_point, _nhwc=x._nhwc)


def split_channels(x: Tensor, sections: int) -> tuple:
    """The channel axis cut into ``sections`` equal parts (ShuffleNetV2's
    channel split), each a view at the input's (scale, zp)."""
    x._no_ingest("split_channels")
    axis = 3 if x._nhwc else 1
    c = x.data.shape[axis]
    if c % sections:
        raise ValueError(f"channels {c} not divisible into {sections} parts")
    return tuple(Tensor(p, x.scale, x.zero_point, _nhwc=x._nhwc)
                 for p in torch.split(x.data, c // sections, dim=axis))


def to_tokens(x: Tensor) -> Tensor:
    """Image feature map -> token sequence [B, H*W, C] (the ViT patch
    stem).  A converted conv's output is NHWC internally, which is already
    token-major: a reshape; a logical NCHW tensor (the FP32 path) is
    transposed first.  (scale, zp) pass through."""
    x._no_ingest("to_tokens")
    if x._nhwc:
        n, h, w, c = x.data.shape
        d = x.data.reshape(n, h * w, c)
    else:
        n, c, h, w = x.data.shape
        d = x.data.permute(0, 2, 3, 1).reshape(n, h * w, c)
    return Tensor(d, x.scale, x.zero_point)


def select_token(x: Tensor, index: int) -> Tensor:
    """[B, T, C] -> [B, C]: one token (the class token at 0) for the head."""
    x._no_ingest("select_token")
    return Tensor(x.data[:, index, :], x.scale, x.zero_point)


def split_heads(x: Tensor, num_heads: int) -> Tensor:
    """[B, T, C] -> [B, H, T, C/H] (quantization-transparent layout op)."""
    x._no_ingest("split_heads")
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
    x._no_ingest("repeat_kv")
    if group == 1:
        return x
    b, hkv, t, d = x.data.shape
    out = x.data[:, :, None].expand(b, hkv, group, t, d)
    return Tensor(out.reshape(b, hkv * group, t, d), x.scale, x.zero_point)


def merge_heads(x: Tensor) -> Tensor:
    """[B, H, T, D] -> [B, T, H*D] (inverse of ``split_heads``)."""
    x._no_ingest("merge_heads")
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
    x._no_ingest("quantize")
    q = quant.quantize_u8(x.data, scale, zero_point, rounding)
    return Tensor(q, scale, zero_point, _nhwc=x._nhwc)


def dequantize(x: Tensor) -> Tensor:
    """u8 -> f32 using the tensor's own (scale, zp)."""
    x._no_ingest("dequantize")
    out = quant.dequantize_u8(x.data, x.scale, x.zero_point)
    return Tensor(out, _nhwc=x._nhwc)
