"""Convolution paths (counterpart of ``int8inferenceengine_tpu.ops.conv``).

* ``conv2d_fp32``      — ``torch.nn.functional.conv2d`` + bias, NCHW.
* ``conv2d_int8_gemm`` — the quantized conv as a GEMM over its patch
  matrix.  On a CUDA tensor with ``gemm=qgemm`` it launches the gathered
  conv (``qgemm_conv``: kernel B1's conv variant, whose loader reads each
  patch straight from the u8 NHWC input) wherever ``conv_gathered`` says so;
  otherwise it is batched im2col (static strided slices on the u8 codes)
  feeding ``gemm``.  Stock PyTorch has no CUDA int8 convolution.  With the
  'conv' epilogue order it is bit-identical to the JAX package's native
  integer conv (``conv2d_int8_xla``): the integer accumulators are identical
  and the epilogue replays ``down_scale``'s float order.

Zero-point padding parity: the reference pads the patch matrix with the
activation zero_point, so padded taps contribute nothing after zero-point
correction.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .gemm_int8 import (ConvGeom, _card_operands, _check_operands,
                        conv_gathered, launch_plan, plan_qgemm, qgemm,
                        qgemm_plain, sm_count)


def conv2d_fp32(x_nchw: torch.Tensor, w_oihw: torch.Tensor,
                bias: torch.Tensor, stride: int, padding: int
                ) -> torch.Tensor:
    """FP32 convolution + bias in NCHW (bias added after the conv, as the
    JAX package does)."""
    out = F.conv2d(x_nchw, w_oihw, None, stride=stride, padding=padding)
    return out + bias.reshape(1, -1, 1, 1)


def windows_nhwc(x_nhwc: torch.Tensor, kh: int, kw: int,
                 stride: int) -> torch.Tensor:
    """The [n, oh, ow, kh, kw, c] view of every (VALID) window: each
    (l, m) tap is the strided slice x[:, l::stride, m::stride, :]."""
    n, h, w, c = x_nhwc.shape
    sn, sh, sw, sc = x_nhwc.stride()
    oh = (h - kh) // stride + 1
    ow = (w - kw) // stride + 1
    return x_nhwc.as_strided((n, oh, ow, kh, kw, c),
                             (sn, sh * stride, sw * stride, sh, sw, sc))


def im2col_nhwc(x_nhwc: torch.Tensor, kh: int, kw: int, stride: int,
                padding: int, pad_value=0) -> torch.Tensor:
    """Patch extraction: the kh*kw strided window slices, copied once.

    Returns [n, oh, ow, kh*kw*c] with patch element order
    ((l*kw + m)*c + ch); the weight is reordered to match at convert time
    (OIHW -> [O, kh*kw*I])."""
    if padding:
        x_nhwc = F.pad(x_nhwc, (0, 0, padding, padding, padding, padding),
                       value=pad_value)
    win = windows_nhwc(x_nhwc, kh, kw, stride)
    n, oh, ow, _, _, c = win.shape
    return win.reshape(n, oh, ow, kh * kw * c)


def conv2d_int8_gemm(x_u8_nhwc: torch.Tensor, qw_nk: torch.Tensor,
                     oc: torch.Tensor, ep: torch.Tensor, *, kh: int, kw: int,
                     stride: int, padding: int, scale_a, zp_a, scale_c, zp_c,
                     relu=False, rounding: str = "trunc",
                     order: str = "conv", gemm=qgemm) -> torch.Tensor:
    """Quantized conv as the quantized GEMM over its patch matrix
    (``gemm``: ``qgemm`` or its plain version); returns u8 NHWC.

    ``qw_nk`` is the weight as [O, kh*kw*I]; ``oc``/``ep`` as for
    ``qgemm``.  On CUDA with ``gemm=qgemm`` a geometry that
    ``conv_gathered`` takes runs the gathered conv (``qgemm_conv``), never
    im2col."""
    kw_ = dict(scale_a=scale_a, scale_c=scale_c, zp_c=zp_c, relu=relu,
               rounding=rounding, order=order)
    if gemm is qgemm and x_u8_nhwc.device.type == "cuda" and conv_gathered(
            ConvGeom(*x_u8_nhwc.shape, kh, kw, stride, padding)):
        return qgemm_conv(x_u8_nhwc, qw_nk, oc, ep, kh=kh, kw=kw,
                          stride=stride, padding=padding, zp_a=zp_a, **kw_)
    n = x_u8_nhwc.shape[0]
    patches = im2col_nhwc(x_u8_nhwc, kh, kw, stride, padding,
                          pad_value=int(zp_a))
    _, oh, ow, k = patches.shape
    out = gemm(patches.reshape(n * oh * ow, k), qw_nk, oc, ep, **kw_)
    return out.reshape(n, oh, ow, -1)


def qgemm_conv(x_u8_nhwc: torch.Tensor, qw_nk: torch.Tensor, oc: torch.Tensor,
               ep: torch.Tensor, *, kh: int, kw: int, stride: int,
               padding: int, scale_a, zp_a, scale_c, zp_c, relu=False,
               rounding: str = "trunc", order: str = "conv",
               plan=None) -> torch.Tensor:
    """The gathered conv: kernel B1 (``csrc/qgemm_int8.cu``
    ``qgemm_u8s8_conv``) with its A tile gathered from the u8 NHWC input,
    patch order ``(l*kw + m)*c + ch`` and padded taps at ``zp_a``; returns
    u8 NHWC.

    On CUDA tensors this launches the kernel with ``plan`` (by default
    ``plan_qgemm(..., conv=geometry)``) and adds one to ``qgemm.launches``;
    on CPU tensors it is im2col + ``qgemm_plain``.  The kernel's loader
    moves 4-byte words at least: where C % 4 != 0 (AlexNet conv1, C = 3)
    the channels are first padded to a multiple of 4, the input with the
    zero point and the weight with zero taps, which add nothing to any
    accumulator."""
    kw_ = dict(scale_a=scale_a, scale_c=scale_c, zp_c=zp_c, relu=relu,
               rounding=rounding, order=order)
    if x_u8_nhwc.dtype != torch.uint8 or x_u8_nhwc.dim() != 4:
        raise TypeError(f"qgemm_conv takes u8 NHWC codes, got "
                        f"{x_u8_nhwc.dtype} {tuple(x_u8_nhwc.shape)}")
    geom = ConvGeom(*x_u8_nhwc.shape, kh, kw, stride, padding)
    (oh, ow), (m, k) = geom.out_hw, geom.gemm_shape
    if min(oh, ow) <= 0:
        raise ValueError(f"qgemm_conv: window {kh}x{kw} larger than the "
                         f"padded input {tuple(x_u8_nhwc.shape)}")
    _check_operands(x_u8_nhwc.new_empty((0, k)), qw_nk, oc, ep, order)
    if x_u8_nhwc.device.type == "cpu":
        return conv2d_int8_gemm(x_u8_nhwc, qw_nk, oc, ep, kh=kh, kw=kw,
                                stride=stride, padding=padding, zp_a=zp_a,
                                gemm=qgemm_plain, **kw_)
    if geom.c % 4:
        extra = -geom.c % 4
        x_u8_nhwc = F.pad(x_u8_nhwc, (0, extra), value=int(zp_a))
        qw_nk = F.pad(qw_nk.reshape(-1, kh, kw, geom.c), (0, extra)).reshape(
            qw_nk.shape[0], -1)
        geom = geom._replace(c=geom.c + extra)
        k = geom.gemm_shape[1]
    x_u8_nhwc = x_u8_nhwc.contiguous()
    dev = _card_operands("qgemm_conv", x_u8_nhwc.view(-1, geom.c), qw_nk,
                         oc, ep)
    n = qw_nk.shape[0]
    out = torch.empty((geom.batch, oh, ow, n), dtype=torch.uint8, device=dev)
    plan = plan or plan_qgemm(m, n, k, conv=geom, sms=sm_count(dev))
    if plan.variant != "conv":
        raise ValueError(f"qgemm_conv: {geom} is not a gathered geometry")
    from ..kernels import load
    lib = load("qgemm_int8")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.qgemm_u8s8_conv(
            x_u8_nhwc.data_ptr(), qw_nk.data_ptr(), oc.data_ptr(),
            ep.data_ptr(), out.data_ptr(), *geom, n, int(zp_a),
            float(scale_a), float(scale_c), int(zp_c), int(order == "conv"),
            int(bool(relu)), int(rounding == "nearest"),
            *launch_plan(plan, x_u8_nhwc, qw_nk), stream)
    if rc != 0:
        raise RuntimeError(f"qgemm_u8s8_conv launch failed with CUDA error "
                           f"{rc} ({geom}, {plan})")
    qgemm.launches += 1
    return out
