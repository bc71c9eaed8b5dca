"""Quantize / dequantize / requantize primitives
(counterpart of ``int8inferenceengine_tpu.ops.quant``).

Numerics are bit-compatible with the reference engine's scalar loops:

* asymmetric u8 activation quantization  ``q = trunc(clip(x/s + zp, 0, 255))``
* symmetric s8 weight quantization       ``q = trunc(clip(x/s, -127, 127))``
* the requantization epilogue ``down_scale``:
  ``u8 = trunc(clip(acc * s_a * s_w / s_c + zp_c, 0, 255))``, or its
  bfloat16 order (``requant_bf16``) under ``QuantConfig.epilogue_dtype``

Every scalar operand is a float32 0-dim tensor on the operand's own device
(``f32``; a bfloat16 one where the glue or the epilogue computes in
bfloat16), never a Python float: on CUDA, dividing by a CPU scalar
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
    return scalar(value, device, torch.float32)


def scalar(value, device, dtype) -> torch.Tensor:
    """``value`` as a ``dtype`` tensor on ``device`` (``f32``'s rule for any
    float dtype): the operand of one op in that dtype, as the JAX package's
    ``one * value`` is."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype)
    return torch.full((), value, dtype=dtype, device=device)


def _to_u8(t: torch.Tensor) -> torch.Tensor:
    """Clipped codes -> u8, truncating.  A bfloat16 ``t`` may hold 256 after
    the +0.5 of 'nearest' (255.5 rounds to even); the JAX package's cast
    saturates there, as this does."""
    if t.dtype != torch.float32:
        t = t.clamp_max(255.0)
    return t.to(torch.uint8)


def quantize_u8(x: torch.Tensor, scale: float, zero_point,
                rounding: str = "trunc") -> torch.Tensor:
    """Asymmetric affine quantization float -> uint8 (activations).

    Computes in ``x``'s own float dtype (float32 normally; bfloat16 when a
    caller dequantized at bfloat16 under ``QuantConfig.glue_dtype``), as the
    JAX package's does.  'trunc' is the reference's C cast; 'nearest' adds
    0.5 before the (toward-zero, but now non-negative) cast, i.e. rounds
    half up."""
    dev = x.device
    dt = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    t = x / scalar(scale, dev, dt) + scalar(zero_point, dev, dt)
    t = torch.clamp(t, 0.0, 255.0)
    if rounding == "nearest":
        t = t + scalar(0.5, dev, dt)
    return _to_u8(t)


def quantize_s8(x: torch.Tensor, scale, rounding: str = "trunc"
                ) -> torch.Tensor:
    """Symmetric quantization float32 -> int8 (weights / biases).

    'nearest' is round-half-to-even here, as ``jnp.round`` is."""
    t = x / f32(scale, x.device)
    if rounding == "nearest":
        t = torch.round(t)
    t = torch.clamp(t, -127.0, 127.0)
    return t.to(torch.int8)


def dequantize_u8(q: torch.Tensor, scale: float, zero_point,
                  dtype=torch.float32) -> torch.Tensor:
    """uint8 -> float: ``x = (q - zp) * s``, every op in ``dtype`` (bfloat16
    under ``QuantConfig.glue_dtype``)."""
    return ((q.to(dtype) - scalar(zero_point, q.device, dtype))
            * scalar(scale, q.device, dtype))


def down_scale(acc: torch.Tensor, scale_a: float, scale_w, scale_c: float,
               zp_c, rounding: str = "trunc",
               compute_dtype=torch.float32) -> torch.Tensor:
    """Requantization epilogue: s32 accum -> u8 at the consumer scale.

    ``u8 = trunc(clip(acc * s_a * s_w / s_c + zp_c, 0, 255))`` in this
    float32 association.  ``scale_w`` is a float (per-tensor) or an [N]
    tensor (per-channel) broadcasting over the trailing channel axis.
    ``compute_dtype=torch.bfloat16`` (``QuantConfig.epilogue_dtype``) runs
    the JAX package's bfloat16 order instead (``requant_bf16``)."""
    dev = acc.device
    if compute_dtype == torch.bfloat16:
        return requant_bf16(acc, bf16_multiplier(scale_a, scale_w, scale_c,
                                                 dev), zp_c, rounding)
    deq = acc.to(torch.float32) * f32(scale_a, dev) * f32(scale_w, dev)
    q = deq / f32(scale_c, dev) + f32(zp_c, dev)
    q = torch.clamp(q, 0.0, 255.0)
    if rounding == "nearest":
        q = q + f32(0.5, dev)
    return q.to(torch.uint8)


def bf16_multiplier(scale_a, scale_w, scale_c, device) -> torch.Tensor:
    """The bfloat16 epilogue's multiplier ``bf16(f32(s_a) * s_w / f32(s_c))``
    (0-dim, or [N] for an [N] ``scale_w``)."""
    return (f32(scale_a, device) * f32(scale_w, device)
            / f32(scale_c, device)).to(torch.bfloat16)


def requant_bf16(acc: torch.Tensor, mult: torch.Tensor, zp_c,
                 rounding: str = "trunc") -> torch.Tensor:
    """The bfloat16 conv epilogue on an s32 accumulator (which already
    holds the offset vector): ``q = bf16(acc) * mult + bf16(zp_c)``, clip to
    [0, 255], ``+ bf16(0.5)`` under 'nearest', then the saturating cast, as
    the JAX package's ``down_scale(compute_dtype=bfloat16)`` orders it.
    Each op runs in float32 and rounds to bfloat16 (nearest-even), as
    PyTorch's bfloat16 arithmetic does: the port replays the eager order,
    every op rounded.  ``bf16(acc)`` goes through float32 (two roundings
    where |acc| >= 2^24), as PyTorch's int -> bfloat16 cast does.
    ``mult`` is ``bf16_multiplier``'s (bfloat16 values in any float
    dtype)."""
    dev, bf16 = acc.device, torch.bfloat16
    q = acc.to(torch.float32).to(bf16) * mult.to(bf16)
    q = q + scalar(zp_c, dev, bf16)
    q = torch.clamp(q, 0.0, 255.0)
    if rounding == "nearest":
        q = q + scalar(0.5, dev, bf16)
    return _to_u8(q)


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
