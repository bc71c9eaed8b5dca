"""The s8-weight, float-activation routes of ``QuantConfig(weight_only=True)``
(counterpart of the weight-only branches of the JAX package's
``Linear._forward_fp32``, ``layers.py:367-413``).

* **W8F** (``w8f_matmul``), the W8-float Linear: the s8 weight is
  dequantized at every call, ``q * s_w``, and multiplied in float32,
  ``x @ w^T + bias``, as the JAX package does (dequantize first, then one
  float32 product).  TF32 stays off (``__init__``).  At a decode step this
  writes and reads the whole weight in float32 every call: the mode's
  known cost, kept as it is (storing float32 weights would be another
  mode).
* **DA** (``s8_matmul``), the dynamic Linear's product: s8 [M, K] x s8
  [N, K] -> s32 [M, N], exact.  On a CUDA tensor it is ``torch._int_mm``
  with the operands padded with zeros to the shapes its CUDA path takes
  (more than 16 rows, K and N multiples of 8; ``int_mm_shape``), which adds
  nothing to any sum; on a CPU tensor it is ``s8_matmul_plain``.

The JAX package leaves both to XLA (no ``pallas_call``), so the port uses
stock PyTorch for them.  Each counts its calls in ``.calls``, the number
``graphs.Captured`` replays as it replays kernel launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["dequant_w8", "w8f_matmul", "s8_matmul", "s8_product",
           "s8_matmul_plain", "int_mm_shape"]

# the operand shape ``torch._int_mm``'s CUDA path takes: rows above this,
# K and N multiples of INT_MM_ALIGN
INT_MM_MIN_ROWS = 16
INT_MM_ALIGN = 8


def dequant_w8(q_w: torch.Tensor, s_w: torch.Tensor) -> torch.Tensor:
    """s8 weights with their output channels on axis 0 -> float32 ``q *
    s`` (``s_w`` float32 [N], one scale per output channel; a per-tensor
    scale is the same value repeated)."""
    shape = (-1,) + (1,) * (q_w.dim() - 1)
    return q_w.to(torch.float32) * s_w.reshape(shape)


def w8f_matmul(x: torch.Tensor, q_w: torch.Tensor, s_w: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """W8F: float32 ``x [M, K] @ (q_w [N, K] * s_w)^T + bias`` -> [M, N]."""
    w8f_matmul.calls += 1
    return torch.matmul(x, dequant_w8(q_w, s_w).t()) + bias.reshape(1, -1)


w8f_matmul.calls = 0


def s8_matmul_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """s8 [M, K] x s8 [N, K]^T -> s32 [M, N] through float64, which is
    exact here: every partial sum is an integer of magnitude at most
    127 * 127 * K < 2^53."""
    return torch.matmul(a.to(torch.float64),
                        w.to(torch.float64).t()).to(torch.int32)


def int_mm_shape(m: int, k: int, n: int) -> tuple:
    """The (M, K, N) to which DA pads an s8 product for ``torch._int_mm``:
    rows above ``INT_MM_MIN_ROWS``, K and N up to multiples of
    ``INT_MM_ALIGN``."""
    def up(v):
        return -(-v // INT_MM_ALIGN) * INT_MM_ALIGN
    return max(m, INT_MM_MIN_ROWS + 1), up(k), up(n)


def _check(a: torch.Tensor, w: torch.Tensor) -> None:
    if a.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"s8_matmul takes int8 operands, got {a.dtype} and "
                        f"{w.dtype}")
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[1]:
        raise ValueError(f"s8_matmul shapes: a {tuple(a.shape)} vs w "
                         f"{tuple(w.shape)} (want [M, K] and [N, K])")
    if a.device != w.device:
        raise ValueError(f"s8_matmul: a on {a.device}, w on {w.device}")


def s8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """DA: exact s8 [M, K] x s8 [N, K]^T -> s32 [M, N] (``s8_product``),
    counted in ``.calls``."""
    s8_matmul.calls += 1
    return s8_product(a, w)


def s8_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact s8 [M, K] x s8 [N, K]^T -> s32 [M, N]: on CUDA tensors
    ``torch._int_mm`` on zero-padded operands (``int_mm_shape``); on CPU
    tensors ``s8_matmul_plain``.  The tensor-parallel products
    (``ops/gemm_int8.qgemm_row_parallel``, ``parallel/overlap.ring_qgemm``)
    use it too, uncounted here."""
    _check(a, w)
    if a.device.type == "cpu":
        return s8_matmul_plain(a, w)
    m, k = a.shape
    n = w.shape[0]
    mp, kp, np_ = int_mm_shape(m, k, n)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        w = F.pad(w, (0, kp - k, 0, np_ - n))
    out = torch._int_mm(a.contiguous(), w.contiguous().t())
    return out[:m, :n]


s8_matmul.calls = 0
