"""Quantized activation x activation batched matmul (attention GEMMs)
(counterpart of ``int8inferenceengine_tpu.ops.qmatmul``).

Both operands are quantized activations, so the zero-point correction is
data-dependent.  The JAX package folds it into row/column sums next to an
s8 dot; the integer it computes is simply

    acc[m, n] = sum_k (a[m,k] - zp_a) * (b[k,n] - zp_b)

which this module forms directly: the zero points are subtracted in float64
and the product accumulates in float64, exact here (|acc| <= 255*255*K <
2**53) and the same on the CPU and on CUDA (PyTorch has no CUDA int32
matmul, and a float32 product on the card would round).  The requant
epilogue then replays the reference's float32 order:

    mult = s_a * s_b * alpha / s_c          (left to right, float32)
    u8   = trunc(clip(f32(acc) * mult + zp_c, 0, 255) [+ 0.5 'nearest'])

The JAX package runs this product outside any Pallas kernel, so it stays a
plain PyTorch product here: the prefill's QK^T and P@V, and the composed
decode attention.
"""

from __future__ import annotations

import torch

from .quant import f32


def act_mult(scale_a, scale_b, alpha, scale_c, device) -> torch.Tensor:
    """``s_a * s_b * alpha / s_c`` in float32, in that order (0-dim)."""
    return (f32(scale_a, device) * f32(scale_b, device)
            * f32(alpha, device) / f32(scale_c, device))


def qmatmul_act(a_u8: torch.Tensor, b_u8: torch.Tensor, *, scale_a, zp_a,
                scale_b, zp_b, scale_c, zp_c, alpha: float = 1.0,
                transpose_b: bool = False, rounding: str = "trunc"
                ) -> torch.Tensor:
    """u8[..., M, K] x u8[..., K, N] (or [..., N, K] with transpose_b)
    -> u8[..., M, N] requantized to (scale_c, zp_c).  Leading dims are batch
    dims (shared by both operands)."""
    if a_u8.dtype != torch.uint8 or b_u8.dtype != torch.uint8:
        raise TypeError(f"qmatmul_act operands must be uint8 codes, got "
                        f"{a_u8.dtype} x {b_u8.dtype}")
    a = a_u8.to(torch.float64) - float(int(zp_a))
    b = b_u8.to(torch.float64) - float(int(zp_b))
    if transpose_b:
        b = b.transpose(-1, -2)
    return requant_act(torch.matmul(a, b).to(torch.int32), scale_a=scale_a,
                       scale_b=scale_b, scale_c=scale_c, zp_c=zp_c,
                       alpha=alpha, rounding=rounding)


def requant_act(acc: torch.Tensor, *, scale_a, scale_b, scale_c, zp_c,
                alpha: float = 1.0, rounding: str = "trunc") -> torch.Tensor:
    """The int32 accumulator ``acc`` requantized to (scale_c, zp_c) in the
    reference's float32 order."""
    dev = acc.device
    q = (acc.to(torch.float32) * act_mult(scale_a, scale_b, alpha, scale_c,
                                          dev) + f32(zp_c, dev))
    q = torch.clamp(q, 0.0, 255.0)
    if rounding == "nearest":
        q = q + f32(0.5, dev)
    return q.to(torch.int32).to(torch.uint8)
