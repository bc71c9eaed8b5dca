"""Quantize / dequantize / requantize primitives
(counterpart of ``int8inferenceengine_tpu.ops.quant``).

Numerics are bit-compatible with the reference engine's scalar loops:

* asymmetric u8 activation quantization  ``q = trunc(clip(x/s + zp, 0, 255))``
* symmetric s8 weight quantization       ``q = trunc(clip(x/s, -127, 127))``
* the requantization epilogue ``down_scale``:
  ``u8 = trunc(clip(acc * s_a * s_w / s_c + zp_c, 0, 255))``

Every scalar operand is a float32 0-dim tensor on the operand's own device
(``f32``), never a Python float: on CUDA, dividing by a CPU scalar
multiplies by its reciprocal, which is one ULP off on a few percent of
values and moves codes that sit on a truncation boundary; and scalar
arithmetic in Python runs in float64, where the reference rounds every step
to float32.
"""

from __future__ import annotations

import torch


def f32(value, device) -> torch.Tensor:
    """``value`` as a float32 tensor on ``device``: a number becomes a 0-dim
    tensor (filled on the device, no host sync); a tensor is moved/cast."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32)
    return torch.full((), value, dtype=torch.float32, device=device)


def quantize_u8(x: torch.Tensor, scale: float, zero_point,
                rounding: str = "trunc") -> torch.Tensor:
    """Asymmetric affine quantization float32 -> uint8 (activations).

    'trunc' is the reference's C cast; 'nearest' adds 0.5 before the
    (toward-zero, but now non-negative) cast, i.e. rounds half up."""
    t = x / f32(scale, x.device) + f32(zero_point, x.device)
    t = torch.clamp(t, 0.0, 255.0)
    if rounding == "nearest":
        t = t + f32(0.5, x.device)
    return t.to(torch.uint8)


def quantize_s8(x: torch.Tensor, scale, rounding: str = "trunc"
                ) -> torch.Tensor:
    """Symmetric quantization float32 -> int8 (weights / biases).

    'nearest' is round-half-to-even here, as ``jnp.round`` is."""
    t = x / f32(scale, x.device)
    if rounding == "nearest":
        t = torch.round(t)
    t = torch.clamp(t, -127.0, 127.0)
    return t.to(torch.int8)


def dequantize_u8(q: torch.Tensor, scale: float, zero_point) -> torch.Tensor:
    """uint8 -> float32: ``x = (q - zp) * s``."""
    return ((q.to(torch.float32) - f32(zero_point, q.device))
            * f32(scale, q.device))


def down_scale(acc: torch.Tensor, scale_a: float, scale_w, scale_c: float,
               zp_c, rounding: str = "trunc") -> torch.Tensor:
    """Requantization epilogue: s32 accum -> u8 at the consumer scale.

    ``u8 = trunc(clip(acc * s_a * s_w / s_c + zp_c, 0, 255))`` in this
    float32 association.  ``scale_w`` is a float (per-tensor) or an [N]
    tensor (per-channel) broadcasting over the trailing channel axis."""
    dev = acc.device
    deq = acc.to(torch.float32) * f32(scale_a, dev) * f32(scale_w, dev)
    q = deq / f32(scale_c, dev) + f32(zp_c, dev)
    q = torch.clamp(q, 0.0, 255.0)
    if rounding == "nearest":
        q = q + f32(0.5, dev)
    return q.to(torch.uint8)


def _weight_scale(w_min: torch.Tensor, w_max: torch.Tensor) -> torch.Tensor:
    scale = (w_max - w_min) / f32(127.0, w_min.device)
    # Degenerate all-zero layer: keep scale positive.
    return torch.where(scale == 0, f32(1.0, w_min.device), scale)


def quantize_weight_joint_scale(weight: torch.Tensor, bias: torch.Tensor,
                                rounding: str = "trunc"):
    """Per-tensor symmetric s8 weight+bias quantization with a joint scale.

    ``scale = (max - min) / 127`` over the union of weight AND bias values;
    the bias is quantized to s8 with the same scale.  Returns
    ``(q_w, q_b, scale)`` with ``scale`` a Python float (exactly float32)."""
    w_min = torch.minimum(weight.min(), bias.min())
    w_max = torch.maximum(weight.max(), bias.max())
    scale = _weight_scale(w_min, w_max)
    return (quantize_s8(weight, scale, rounding),
            quantize_s8(bias, scale, rounding), float(scale))


def quantize_weight_per_channel(weight: torch.Tensor, bias: torch.Tensor,
                                channel_axis: int = 0,
                                rounding: str = "trunc"):
    """Per-output-channel symmetric s8 scales; returns ``(q_w, q_b, scale)``
    with ``scale`` a float32 [C] tensor."""
    reduce_dims = tuple(i for i in range(weight.dim()) if i != channel_axis)
    w_min = torch.minimum(torch.amin(weight, dim=reduce_dims), bias)
    w_max = torch.maximum(torch.amax(weight, dim=reduce_dims), bias)
    scale = _weight_scale(w_min, w_max)
    shape = [1] * weight.dim()
    shape[channel_axis] = -1
    return (quantize_s8(weight, scale.reshape(shape), rounding),
            quantize_s8(bias, scale, rounding), scale)


def quantize_dynamic(x: torch.Tensor, dims) -> tuple:
    """Dynamic symmetric s8 quantization with one scale per slice over
    ``dims`` (a Linear's rows: ``dims=(1,)``; a conv's images: ``(1, 2,
    3)``): ``s = max(max|x|, 1e-8) / 127`` (kept dims, float32) and ``q =
    clip(round_half_even(x / s), -127, 127)`` as int8, in the JAX package's
    order.  Returns ``(q, s)``."""
    dev = x.device
    s = torch.maximum(torch.amax(torch.abs(x), dim=dims, keepdim=True),
                      f32(1e-8, dev)) / f32(127.0, dev)
    q = torch.clamp(torch.round(x / s), -127.0, 127.0)
    return q.to(torch.int8), s


def dequantize_dynamic(acc: torch.Tensor, s_a: torch.Tensor,
                       s_w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The dynamic epilogue: ``acc.f32 * (s_a * s_w) + bias`` in that
    order, each operation rounded on its own (no fused multiply-add);
    ``s_a``, ``s_w`` and ``bias`` broadcast against the s32 ``acc``."""
    return acc.to(torch.float32) * (s_a * s_w) + bias
