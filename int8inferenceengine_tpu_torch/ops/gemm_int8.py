"""Quantized GEMM: u8 activations x s8 weights -> u8 outputs
(counterpart of ``int8inferenceengine_tpu.ops.gemm_int8``).

Activations are *unsigned* u8; the int8 tensor cores multiply s8 x s8.  The
kernel recenters them on the fly, ``a' = a - 128``, and the recentering term
folds into the per-output-channel offset the reference already computes for
zero-point correction:

    C[m,n] = sum_k (a[m,k]-128) * w[n,k]  +  (128 - zp_a) * rowsum_w[n]
             + trunc(q_bias[n] / s_a)                      <- bias in s32

Everything after the s32 accumulator is the reference's requant epilogue in
one of two float orders (``order``):

* ``"gemm"`` (Linear): ``q = f32(C) * mult[n] + zp_c`` with
  ``mult = s_a * s_w[n] / s_c`` computed once in float32 (``_mult_vector``);
* ``"conv"`` (Conv2d): ``q = f32(C) * s_a * s_w[n] / s_c + zp_c`` — the
  reference's ``down_scale`` association, which the JAX package's native
  integer conv uses.

then clip to [0, 255], +0.5 under 'nearest', truncate, optional ReLU at the
zero point.  ``epilogue_vector`` gives the f32 [N] vector each order reads
(``mult`` or ``s_w``), so the kernel and ``qgemm_plain`` share it as they
share ``oc``.

``qgemm`` is the wrapper of the hand-written CUDA kernel
(``csrc/qgemm_int8.cu``); ``qgemm_plain`` is the plain PyTorch version of the
same function.  The wrapper takes the plain version for a CPU tensor only;
for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from .quant import down_scale, f32

ORDERS = ("gemm", "conv")


def compute_offset(q_bias: torch.Tensor, rowsum_w: torch.Tensor,
                   scale_a: float, zp_a, *, recentered: bool) -> torch.Tensor:
    """Per-output-channel s32 offset: zero-point correction + bias fold
    (+128*rowsum when the kernel consumes recentered activations)."""
    base = 128 if recentered else 0
    zp_term = (base - int(zp_a)) * rowsum_w.to(torch.int32)
    bias_term = (q_bias.to(torch.float32) / f32(scale_a, q_bias.device)
                 ).to(torch.int32)
    return zp_term + bias_term


def _mult_vector(scale_a, scale_w, scale_c, n: int, device) -> torch.Tensor:
    """Requant multiplier ``s_a * s_w / s_c`` as an f32 [N] vector."""
    mult = (f32(scale_a, device) * f32(scale_w, device)
            / f32(scale_c, device))
    return mult.expand(n).contiguous()


def epilogue_vector(scale_a, scale_w, scale_c, n: int, device,
                    order: str = "gemm") -> torch.Tensor:
    """The f32 [N] vector the epilogue of ``order`` reads: ``mult`` for
    'gemm', ``s_w`` for 'conv'.  ``scale_w`` is a float or an [N] tensor."""
    if order == "gemm":
        return _mult_vector(scale_a, scale_w, scale_c, n, device)
    if order == "conv":
        return f32(scale_w, device).expand(n).contiguous()
    raise ValueError(f"unknown epilogue order {order!r}; one of {ORDERS}")


def _requant_epilogue(c: torch.Tensor, ep: torch.Tensor, *, scale_a,
                      scale_c, zp_c, relu=False, rounding: str = "trunc",
                      order: str = "gemm") -> torch.Tensor:
    """The requant tail on an s32 accumulator that already includes the
    offset vector.  ``ep`` is ``epilogue_vector(..., order=order)``."""
    if order == "conv":
        out = down_scale(c, scale_a, ep, scale_c, zp_c, rounding)
        return out.clamp_min(int(zp_c)) if relu else out
    q = c.to(torch.float32) * ep.reshape(1, -1) + f32(zp_c, c.device)
    q = torch.clamp(q, 0.0, 255.0)
    if rounding == "nearest":
        q = q + f32(0.5, c.device)
    qi = q.to(torch.int32)
    if relu:
        qi = qi.clamp_min(int(zp_c))
    return qi.to(torch.uint8)


def qgemm_plain(a_u8: torch.Tensor, w_s8_nk: torch.Tensor, oc: torch.Tensor,
                ep: torch.Tensor, *, scale_a, scale_c, zp_c, relu=False,
                rounding: str = "trunc", order: str = "gemm"
                ) -> torch.Tensor:
    """u8[M,K] x s8[N,K] (+oc[N]) -> u8[M,N], in plain PyTorch.

    The product accumulates in float64, which is exact here
    (|acc| <= 128*127*K < 2**53) and runs on the CPU and on CUDA alike
    (PyTorch has no int32 matmul on CUDA); it is then cast to int32."""
    a = a_u8.to(torch.float64) - 128.0          # widen before recentering
    acc = torch.matmul(a, w_s8_nk.to(torch.float64).t()).to(torch.int32)
    return _requant_epilogue(acc + oc.reshape(1, -1), ep, scale_a=scale_a,
                             scale_c=scale_c, zp_c=zp_c, relu=relu,
                             rounding=rounding, order=order)


def _check_operands(a_u8, w_s8_nk, oc, ep, order):
    if a_u8.dtype != torch.uint8:
        raise TypeError(f"qgemm activations must be uint8 codes, got "
                        f"{a_u8.dtype}")
    if w_s8_nk.dtype != torch.int8:
        raise TypeError(f"qgemm weights must be int8, got {w_s8_nk.dtype}")
    if a_u8.dim() != 2 or w_s8_nk.dim() != 2 \
            or a_u8.shape[1] != w_s8_nk.shape[1]:
        raise ValueError(f"qgemm shapes: a {tuple(a_u8.shape)} vs w "
                         f"{tuple(w_s8_nk.shape)} (want [M,K] and [N,K])")
    n = w_s8_nk.shape[0]
    if oc.dtype != torch.int32 or tuple(oc.shape) != (n,):
        raise ValueError(f"oc must be int32 [{n}], got {oc.dtype} "
                         f"{tuple(oc.shape)}")
    if ep.dtype != torch.float32 or tuple(ep.shape) != (n,):
        raise ValueError(f"ep must be float32 [{n}], got {ep.dtype} "
                         f"{tuple(ep.shape)}")
    if order not in ORDERS:
        raise ValueError(f"unknown epilogue order {order!r}; one of {ORDERS}")


def qgemm(a_u8: torch.Tensor, w_s8_nk: torch.Tensor, oc: torch.Tensor,
          ep: torch.Tensor, *, scale_a, scale_c, zp_c, relu=False,
          rounding: str = "trunc", order: str = "gemm") -> torch.Tensor:
    """u8[M,K] x s8[N,K] (+oc[N]) -> u8[M,N] requantized to (scale_c, zp_c).

    On CUDA tensors this launches the hand-written kernel
    (``csrc/qgemm_int8.cu``) on the current stream and adds one to
    ``qgemm.launches``; on CPU tensors it is ``qgemm_plain``."""
    _check_operands(a_u8, w_s8_nk, oc, ep, order)
    kw = dict(scale_a=scale_a, scale_c=scale_c, zp_c=zp_c, relu=relu,
              rounding=rounding, order=order)
    dev = a_u8.device
    if dev.type == "cpu":
        return qgemm_plain(a_u8, w_s8_nk, oc, ep, **kw)
    if dev.type != "cuda":
        raise ValueError(f"qgemm runs on CUDA or CPU tensors, got {dev}")
    for name, t in (("w", w_s8_nk), ("oc", oc), ("ep", ep)):
        if t.device != dev:
            raise ValueError(f"qgemm: {name} is on {t.device}, a on {dev}")
    for name, t in (("a", a_u8), ("w", w_s8_nk), ("oc", oc), ("ep", ep)):
        if not t.is_contiguous():
            raise ValueError(f"qgemm: {name} must be contiguous")
    m, k = a_u8.shape
    n = w_s8_nk.shape[0]
    if max(m, n, k) >= 2 ** 31:
        raise ValueError(f"qgemm: shape M={m} N={n} K={k} too large")
    out = torch.empty((m, n), dtype=torch.uint8, device=dev)
    if m == 0 or n == 0:
        return out
    if k == 0:
        raise ValueError("qgemm: K must be positive")
    from ..kernels import load
    lib = load("qgemm_int8")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.qgemm_u8s8(
            a_u8.data_ptr(), w_s8_nk.data_ptr(), oc.data_ptr(), ep.data_ptr(),
            out.data_ptr(), m, n, k, float(scale_a), float(scale_c),
            int(zp_c), int(order == "conv"), int(bool(relu)),
            int(rounding == "nearest"), stream)
    if rc != 0:
        raise RuntimeError(f"qgemm_u8s8 launch failed with CUDA error {rc}")
    qgemm.launches += 1
    return out


qgemm.launches = 0
