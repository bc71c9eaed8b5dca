"""Convolution paths (counterpart of ``int8inferenceengine_tpu.ops.conv``).

* ``conv2d_fp32``      — ``torch.nn.functional.conv2d`` + bias, NCHW.
* ``conv2d_int8_gemm`` — batched im2col (static strided slices on the u8
  codes) feeding the quantized GEMM kernel.  Stock PyTorch has no CUDA int8
  convolution, so every INT8 conv takes this path.  With the 'conv'
  epilogue order it is bit-identical to the JAX package's native integer
  conv (``conv2d_int8_xla``): the integer accumulators are identical and the
  epilogue replays ``down_scale``'s float order.

Zero-point padding parity: the reference pads the patch matrix with the
activation zero_point, so padded taps contribute nothing after zero-point
correction.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .gemm_int8 import qgemm


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
    """Quantized conv as im2col + the quantized GEMM (``gemm``: ``qgemm``
    or its plain version); returns u8 NHWC.

    ``qw_nk`` is the weight as [O, kh*kw*I]; ``oc``/``ep`` as for
    ``qgemm``."""
    n = x_u8_nhwc.shape[0]
    patches = im2col_nhwc(x_u8_nhwc, kh, kw, stride, padding,
                          pad_value=int(zp_a))
    _, oh, ow, k = patches.shape
    out = gemm(patches.reshape(n * oh * ow, k), qw_nk, oc, ep,
                scale_a=scale_a, scale_c=scale_c, zp_c=zp_c, relu=relu,
                rounding=rounding, order=order)
    return out.reshape(n, oh, ow, -1)
