"""Layers: Linear and Conv2d with the load -> prepare -> convert lifecycle,
and the transformer layers of the decoder (counterpart of
``int8inferenceengine_tpu.layers``).

Semantics preserved for accuracy parity with the reference engine:

* The FP32 path computes ``x @ W^T + b`` / conv + bias and, while preparing,
  samples outputs into the calibrator.
* ``convert()`` derives the layer's *output* (scale, zero_point) from the
  calibrator, quantizes weight+bias to s8 (one joint per-tensor scale, or
  per output channel), and frees the FP32 weights.
* The INT8 path runs u8 activations x s8 weights -> s32 with the
  per-output-channel zero-point/bias offset and the fused requantization to
  the calibrated output (scale, zp), through the quantized GEMM kernel.

Each layer is an ``nn.Module`` whose state lives in registered buffers: the
FP32 ``weight``/``bias`` before convert, and after it ``qw`` (s8 [N, K],
K-major, the kernel's layout; a conv's K is ordered (kh, kw, in_channel)),
``q_bias`` (s8 [N]), ``rowsum`` (s32 [N]) and ``w_scale`` (f32 [N], the
per-tensor scale repeated when weights are not per-channel).

The transformer layers (``QuantEmbed``, ``QuantPosEmbed``,
``QuantLayerNorm``, ``QuantMatmul``, ``QuantSoftmax``, ``QuantAct``,
``QuantAdd``) follow the same lifecycle: their FP32 path observes its
output while preparing, and after convert the INT8 path dequantizes its u8
inputs, computes in float32 in the JAX package's order and requantizes to
the calibrated output grid.  ``fused_qkv``, ``fused_linear_act`` and
``fused_decode_attention`` run converted layer groups through one kernel
each (``QuantConfig.fuse_qkv``, ``fuse_linear_act``, ``decode_attention``).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
from torch import nn

from .calibrator import Calibrator
from .config import DEFAULT_CONFIG, QuantConfig, check_supported
from .ops import attention as attn_ops
from .ops import conv as conv_ops
from .ops import quant as quant_ops
from .ops import rope as rope_ops
from .ops import w4 as w4_ops
from .ops.functional import ACTIVATIONS
from .ops.gemm_int8 import (KERNEL_ACTS, compute_offset, epilogue_vector,
                            merge_parts, qgemm, qgemm_multi,
                            qgemm_multi_plain, qgemm_plain)
from .ops.qmatmul import qmatmul_act
from .ops.quant import dequantize_u8, f32, quantize_u8
from .tensor import Tensor, resolve_device


class Layer(nn.Module):
    """Base layer: weight storage, calibration state, PTQ lifecycle."""

    def __init__(self, config: QuantConfig = DEFAULT_CONFIG, device=None):
        super().__init__()
        check_supported(config)
        self.config = config
        self.device = resolve_device(device)
        self.calibrator: Calibrator | None = None
        self.is_preparing = False
        self.is_quantized = False
        # Layer *output* quantization, set by convert() from calibration
        # (reference defaults: scale=1, zp=0).
        self.scale = 1.0
        self.zero_point = 0
        self.weight_scale = 1.0
        self.fuse_relu = False
        # (input scale, input zp) -> (oc, ep): both depend only on the
        # input grid, which is fixed once the model is converted.
        self._epilogue_cache: dict = {}
        # fused_qkv's merged operands, on the first layer of the group
        self._merged_cache: dict = {}
        for name in ("qw", "q_bias", "rowsum", "w_scale"):
            self.register_buffer(name, None)

    def _buf(self, shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _observe(self, out: torch.Tensor) -> None:
        if self.is_preparing:
            self.calibrator.sample(out)

    # -- lifecycle (reference: src/layer.cc:28-54) ---------------------------
    def prepare(self):
        if self.is_quantized:
            warnings.warn("already quantized")
            return
        self.calibrator = Calibrator(
            exact_minmax=self.config.calib_exact_minmax,
            reservoir_size=self.config.calib_reservoir_size,
            method=self.config.calib_method,
            rounding=self.config.rounding,
        )
        self.is_preparing = True

    def convert(self):
        if self.is_quantized:
            warnings.warn("already quantized")
            return
        if not self.is_preparing:
            # weight-only models keep float activations: no grid to miss
            if not self.config.weight_only:
                warnings.warn(
                    "Not prepared, using default config (scale=1, zp=0)")
        else:
            self.scale, self.zero_point = self.calibrator.get_range(
                self.config.calib_quantile)
            self.calibrator = None
        self._quantize_weights()
        self.is_preparing = False
        self.is_quantized = True

    def _kernel_weight(self, q_w: torch.Tensor) -> torch.Tensor:
        """Quantized weight (``weight``'s layout) -> s8 [N, K]."""
        return q_w

    def _quantize_weights(self):
        rnd = self.config.rounding
        if self.config.weight_per_channel:
            q_w, q_b, s_w = quant_ops.quantize_weight_per_channel(
                self.weight, self.bias, channel_axis=0,
                rounding=rnd)
        else:
            q_w, q_b, s_w = quant_ops.quantize_weight_joint_scale(
                self.weight, self.bias, rounding=rnd)
        qw = self._kernel_weight(q_w).contiguous()
        self.set_quantized(qw, q_b, s_w)

    def set_quantized(self, qw: torch.Tensor, q_bias: torch.Tensor, s_w):
        """Install converted weights: s8 [N, K] ``qw``, s8 [N] ``q_bias`` and
        the weight scale (a float, or an f32 [N] tensor per channel); the
        FP32 weights are freed, as in the reference."""
        n = qw.shape[0]
        self.weight_scale = s_w if isinstance(s_w, float) else s_w.to(
            device=self.device, dtype=torch.float32)
        self.qw = qw.to(device=self.device, dtype=torch.int8).contiguous()
        self.q_bias = q_bias.to(device=self.device, dtype=torch.int8)
        self.rowsum = self.qw.to(torch.int32).sum(dim=1, dtype=torch.int32)
        self.w_scale = quant_ops.f32(s_w, self.device).expand(n).contiguous()
        self.weight = None
        self.bias = None
        self._epilogue_cache = {}
        self._merged_cache = {}

    def _load_array(self, arr, expected_shape, what: str) -> torch.Tensor:
        if isinstance(arr, torch.Tensor):
            a = arr.detach().to(dtype=torch.float32)
        else:
            a = torch.tensor(np.asarray(arr, dtype=np.float32))
        if tuple(a.shape) != tuple(expected_shape):
            raise ValueError(
                f"{type(self).__name__}.{what}: shape {tuple(a.shape)} != "
                f"expected {tuple(expected_shape)}")
        return a.to(self.device).contiguous()

    def load_bias(self, b):
        self.bias = self._load_array(b, (self.out_channels,), "load_bias")

    def _epilogue(self, x: Tensor, order: str):
        key = (x.scale, x.zero_point)
        cached = self._epilogue_cache.get(key)
        if cached is None:
            oc = compute_offset(self.q_bias, self.rowsum, scale_a=x.scale,
                                zp_a=x.zero_point, recentered=True)
            ep = epilogue_vector(x.scale, self.w_scale, self.scale,
                                 self.out_channels, self.device, order)
            cached = self._epilogue_cache[key] = (oc, ep)
        return cached

    def _check_converted(self):
        if not self.is_quantized:
            raise RuntimeError("layer not converted; call convert() first")

    def _check_int8(self, x: Tensor):
        self._check_converted()
        w = self.qw if self.qw is not None else getattr(self, "w4_packed",
                                                        None)
        if w is not None and x.device != w.device:
            raise ValueError(f"input on {x.device}, layer on {w.device}")

    def _check_fp32(self):
        if self.is_quantized:
            raise RuntimeError(
                "layer already converted to INT8 — quantize the input "
                "(FP32 weights were freed, as in the reference)")

    def _gemm(self):
        """The quantized GEMM this layer runs: the kernel's wrapper, or its
        plain version when ``QuantConfig.kernel_backend='xla'`` asks for
        it (the JAX package's backend of that name)."""
        return qgemm_plain if self.config.kernel_backend == "xla" else qgemm


class Linear(Layer):
    """Fully-connected layer; torch-style weight [out, in].

    ``QuantConfig.weight_bits=4`` stores the converted weight as packed
    nibbles with group scales (``ops/w4.py``): ``w4_packed`` (u8 [N, K/2]),
    ``w4_scales`` (f32 [N, G]), the f32 ``bias`` and, on the static path
    (W4A8), ``w4_wsum`` (f32 [N], the dequantized weight's row sums).
    W4A8 takes u8 codes to u8 codes through kernels B6/B7; with
    ``weight_only=True`` the activations stay float and the layer runs
    kernel B5."""

    def __init__(self, in_channels: int, out_channels: int,
                 config: QuantConfig = DEFAULT_CONFIG, fuse_relu: bool = False,
                 device=None):
        super().__init__(config, device)
        self.in_channels = int(in_channels)
        self.out_channels = int(out_channels)
        self.fuse_relu = fuse_relu
        self.register_buffer("weight", self._buf((out_channels, in_channels)))
        self.register_buffer("bias", self._buf((out_channels,)))
        for name in ("w4_packed", "w4_scales", "w4_wsum"):
            self.register_buffer(name, None)

    def load_weight(self, w):
        self.weight = self._load_array(
            w, (self.out_channels, self.in_channels), "load_weight")

    def _quantize_weights(self):
        if self.config.weight_bits != 4:
            return super()._quantize_weights()
        packed, scales = w4_ops.pack_w4(self.weight, self.config.w4_group,
                                        optimize=self.config.w4_mse_scales)
        wsum = None if self.config.weight_only else w4_ops.weight_rowsum(
            packed, scales, self.in_channels, self.config.w4_group)
        self.set_w4(packed, scales, self.bias, wsum)

    def set_w4(self, packed: torch.Tensor, scales: torch.Tensor,
               bias: torch.Tensor, wsum: torch.Tensor | None = None):
        """Install converted 4-bit weights (``w4_wsum`` for W4A8 only); the
        FP32 weight is freed."""
        dev = self.device
        self.w4_packed = packed.to(device=dev, dtype=torch.uint8).contiguous()
        self.w4_scales = scales.to(device=dev,
                                   dtype=torch.float32).contiguous()
        self.bias = bias.to(device=dev, dtype=torch.float32).contiguous()
        self.w4_wsum = None if wsum is None else wsum.to(
            device=dev, dtype=torch.float32).contiguous()
        self.weight = None
        self._epilogue_cache = {}
        self._merged_cache = {}

    def forward(self, x: Tensor) -> Tensor:
        if len(x.shape) != 2:
            raise ValueError(
                f"Linear expects a 2D input, got shape {x.shape}; reshape first")
        if x.quantized:
            return self._forward_int8(x)
        return self._forward_fp32(x)

    def _check_fp32(self):
        if not (self.is_quantized and self.config.weight_only):
            super()._check_fp32()

    def _forward_fp32(self, x: Tensor) -> Tensor:
        self._check_fp32()
        if self.is_quantized:                    # W4 weight-only (kernel B5)
            out = w4_ops.w4_matmul(x.data.contiguous(), self.w4_packed,
                                   self.w4_scales, self.bias,
                                   self.in_channels, self.config.w4_group,
                                   backend=self.config.w4_kernel)
            return Tensor(out)
        out = torch.matmul(x.data, self.weight.t()) + self.bias.reshape(1, -1)
        self._observe(out)
        return Tensor(out)

    def w4a8_operands(self, x: Tensor) -> dict:
        """This layer's W4A8 operands for input grid (x.scale,
        x.zero_point), built once: ``zpb = f32(zp) + bias / f32(scale)``,
        ``mult = f32(s_x) / f32(s_out)`` and what B6 reads (``zpb_eff``,
        the transposed scales)."""
        key = (x.scale, x.zero_point)
        ops = self._epilogue_cache.get(key)
        if ops is None:
            dev = self.w4_packed.device
            zpb = f32(float(self.zero_point), dev) + self.bias / f32(
                self.scale, dev)
            mult = float(np.float32(x.scale) / np.float32(self.scale))
            ops = self._epilogue_cache[key] = w4_ops.w4a8_operands(
                self.w4_packed, self.w4_scales, zpb, self.in_channels,
                self.config.w4_group, zp_x=x.zero_point, mult=mult,
                wsum=self.w4_wsum)
        return ops

    def _forward_int8(self, x: Tensor, act=None) -> Tensor:
        """``act=(name, act_scale, act_zp)`` folds a following QuantAct
        into the epilogue (``fused_linear_act``)."""
        self._check_int8(x)
        if self.config.weight_bits == 4:
            if self.config.weight_only:
                raise RuntimeError("a weight-only layer takes float input")
            if act is not None:
                raise RuntimeError("W4A8 has no fused-act epilogue; "
                                   "fused_linear_act composes it")
            out = w4_ops.w4a8_apply(x.data.contiguous(),
                                    self.w4a8_operands(x),
                                    backend=self.config.w4_kernel,
                                    rounding=self.config.rounding)
            if self.fuse_relu:
                out = out.clamp_min(self.zero_point)
            return Tensor(out, self.scale, self.zero_point)
        oc, ep = self._epilogue(x, "gemm")
        out = self._gemm()(x.data.contiguous(), self.qw, oc, ep,
                           scale_a=x.scale, scale_c=self.scale,
                           zp_c=self.zero_point, relu=self.fuse_relu,
                           rounding=self.config.rounding, order="gemm",
                           act=act)
        if act is not None:
            return Tensor(out, act[1], act[2])
        return Tensor(out, self.scale, self.zero_point)


class Conv2d(Layer):
    """2D convolution; torch-style weight [out_c, in_c, kh, kw].

    The FP32 path runs NCHW through ``F.conv2d``; the INT8 path runs NHWC
    through im2col + the quantized GEMM kernel."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 config: QuantConfig = DEFAULT_CONFIG, fuse_relu: bool = False,
                 device=None):
        super().__init__(config, device)
        if stride == 0:
            raise ValueError("stride must be >= 1 (reference: conv2d.h:12-14)")
        if groups != 1:
            raise NotImplementedError(
                "grouped Conv2d is not implemented by the PyTorch port yet")
        if config.weight_only:
            raise NotImplementedError(
                "a weight-only Conv2d (s8 weights, float activations) is not "
                "implemented by the PyTorch port yet")
        self.in_channels = int(in_channels)
        self.out_channels = int(out_channels)
        self.kernel_size = int(kernel_size)
        self.stride = int(stride)
        self.padding = int(padding)
        self.groups = 1
        self.fuse_relu = fuse_relu
        k = self.kernel_size
        self.register_buffer(
            "weight", self._buf((out_channels, in_channels, k, k)))
        self.register_buffer("bias", self._buf((out_channels,)))

    def load_weight(self, w):
        k = self.kernel_size
        self.weight = self._load_array(
            w, (self.out_channels, self.in_channels, k, k), "load_weight")

    def _kernel_weight(self, q_w: torch.Tensor) -> torch.Tensor:
        # OIHW -> [O, (kh, kw, I)], the im2col patch order
        return q_w.permute(0, 2, 3, 1).reshape(self.out_channels, -1)

    def _order(self) -> str:
        # 'auto' replays the native integer conv's down_scale float order;
        # 'gemm' the JAX package's im2col + qgemm path
        return "gemm" if self.config.conv_backend == "gemm" else "conv"

    def forward(self, x: Tensor) -> Tensor:
        if len(x.shape) != 4:
            raise ValueError(f"Conv2d expects a 4D input, got {x.shape}")
        if x.quantized:
            return self._forward_int8(x)
        return self._forward_fp32(x)

    def _forward_fp32(self, x: Tensor) -> Tensor:
        self._check_fp32()
        out = conv_ops.conv2d_fp32(x.logical_data, self.weight, self.bias,
                                   self.stride, self.padding)
        # sampled in NHWC element order, the order the JAX package's
        # reservoir sees
        self._observe(out.permute(0, 2, 3, 1))
        return Tensor(out)

    def _forward_int8(self, x: Tensor) -> Tensor:
        self._check_int8(x)
        order = self._order()
        oc, ep = self._epilogue(x, order)
        k = self.kernel_size
        out = conv_ops.conv2d_int8_gemm(
            x.as_nhwc_data(), self.qw, oc, ep, kh=k, kw=k, stride=self.stride,
            padding=self.padding, scale_a=x.scale, zp_a=x.zero_point,
            scale_c=self.scale, zp_c=self.zero_point, relu=self.fuse_relu,
            rounding=self.config.rounding, order=order, gemm=self._gemm())
        return Tensor(out, self.scale, self.zero_point, _nhwc=True)


# -- transformer layers ------------------------------------------------------

class _Weightless(Layer):
    """A calibrated layer with no weights to quantize."""

    def _quantize_weights(self):
        pass

    def _requant(self, f: torch.Tensor) -> torch.Tensor:
        return quantize_u8(f, self.scale, self.zero_point, self.config.rounding)


class QuantAct(_Weightless):
    """Calibrated activation in the quantized domain: ``u8 -> dequant -> fn
    -> requant -> u8`` at this layer's calibrated output grid.  ``fn`` is an
    ``ops/functional.ACTIVATIONS`` name or a callable; the JAX package's
    256-entry ``lut`` backend is not ported."""

    def __init__(self, fn="hardswish", config: QuantConfig = DEFAULT_CONFIG,
                 backend: str = "elementwise", device=None):
        super().__init__(config, device)
        if callable(fn):
            self.fn = fn
            self.fn_name = getattr(fn, "__name__", "custom")
        else:
            try:
                self.fn = ACTIVATIONS[fn]
            except KeyError:
                raise ValueError(
                    f"unknown activation {fn!r}; available: "
                    f"{sorted(ACTIVATIONS)} (or pass a callable)")
            self.fn_name = fn
        if backend == "lut":
            raise NotImplementedError(
                "QuantAct(backend='lut') is not implemented by the PyTorch "
                "port yet; 'elementwise' gives the same codes")
        if backend != "elementwise":
            raise ValueError(f"backend must be 'elementwise' or 'lut', got "
                             f"{backend!r}")
        self.backend = backend

    def forward(self, x: Tensor) -> Tensor:
        if not x.quantized:
            out = self.fn(x.data)
            self._observe(out)
            return Tensor(out, _nhwc=x._nhwc)
        self._check_converted()
        f = self.fn(dequantize_u8(x.data, x.scale, x.zero_point))
        return Tensor(self._requant(f), self.scale, self.zero_point,
                      _nhwc=x._nhwc)


class QuantAdd(_Weightless):
    """Calibrated elementwise add (residual connections): both addends are
    dequantized at their own grids, summed in float32 and requantized."""

    def __init__(self, config: QuantConfig = DEFAULT_CONFIG,
                 fuse_relu: bool = False, device=None):
        super().__init__(config, device)
        self.fuse_relu = fuse_relu

    @staticmethod
    def _aligned(a: Tensor, b: Tensor) -> torch.Tensor:
        """b's data in a's physical layout."""
        if a._nhwc == b._nhwc:
            return b.data
        return b.data.permute(0, 2, 3, 1) if a._nhwc else \
            b.data.permute(0, 3, 1, 2)

    def forward(self, a: Tensor, b: Tensor) -> Tensor:
        if a.quantized != b.quantized:
            raise ValueError(
                "QuantAdd: both inputs must be quantized or both float")
        b_data = self._aligned(a, b)
        if not a.quantized:
            out = a.data + b_data
            self._observe(out)
            return Tensor(out, _nhwc=a._nhwc)
        self._check_converted()
        q = self._requant(dequantize_u8(a.data, a.scale, a.zero_point)
                          + dequantize_u8(b_data, b.scale, b.zero_point))
        if self.fuse_relu:
            q = q.clamp_min(self.zero_point)
        return Tensor(q, self.scale, self.zero_point, _nhwc=a._nhwc)


class QuantMul(_Weightless):
    """Calibrated elementwise multiply (SwiGLU's ``silu(gate) * up``): both
    factors are dequantized at their own grids, multiplied in float32 and
    requantized."""

    def forward(self, a: Tensor, b: Tensor) -> Tensor:
        if a.quantized != b.quantized:
            raise ValueError(
                "QuantMul: both inputs must be quantized or both float")
        b_data = QuantAdd._aligned(a, b)
        if not a.quantized:
            out = a.data * b_data
            self._observe(out)
            return Tensor(out, _nhwc=a._nhwc)
        self._check_converted()
        q = self._requant(dequantize_u8(a.data, a.scale, a.zero_point)
                          * dequantize_u8(b_data, b.scale, b.zero_point))
        return Tensor(q, self.scale, self.zero_point, _nhwc=a._nhwc)


class QuantMatmul(_Weightless):
    """Calibrated activation x activation batched matmul (``QK^T`` with
    ``transpose_b``, ``P@V``); ``alpha`` folds into the requant multiplier
    (``ops/qmatmul.qmatmul_act``).  Leading dims are batch dims."""

    def __init__(self, alpha: float = 1.0, transpose_b: bool = False,
                 config: QuantConfig = DEFAULT_CONFIG, device=None):
        super().__init__(config, device)
        self.alpha = float(alpha)
        self.transpose_b = transpose_b

    def forward(self, a: Tensor, b: Tensor) -> Tensor:
        if a.quantized != b.quantized:
            raise ValueError(
                "QuantMatmul: both inputs must be quantized or both float")
        if a._nhwc or b._nhwc:
            raise ValueError("QuantMatmul expects token-major tensors "
                             "(no NHWC image layout)")
        if not a.quantized:
            bd = b.data.transpose(-1, -2) if self.transpose_b else b.data
            out = f32(self.alpha, a.device) * torch.matmul(a.data, bd)
            self._observe(out)
            return Tensor(out)
        self._check_converted()
        out = qmatmul_act(
            a.data, b.data, scale_a=a.scale, zp_a=a.zero_point,
            scale_b=b.scale, zp_b=b.zero_point, scale_c=self.scale,
            zp_c=self.zero_point, alpha=self.alpha,
            transpose_b=self.transpose_b, rounding=self.config.rounding)
        return Tensor(out, self.scale, self.zero_point)


class QuantSoftmax(_Weightless):
    """Calibrated softmax over the last axis (attention probabilities).

    ``causal=True`` masks square scores above the diagonal; ``valid_len``
    (an int, a 0-dim tensor, [B, 1, 1, 1] per sequence or [..., tq, 1] per
    row) masks columns >= valid_len; ``window`` also drops columns more than
    ``window`` back; ``softcap`` maps scores through ``softcap*tanh(x /
    softcap)`` before the mask.  Masked positions quantize to exactly the
    zero point.  ALiBi (``alibi_heads``) is not ported."""

    def __init__(self, config: QuantConfig = DEFAULT_CONFIG,
                 causal: bool = False, window: int | None = None,
                 softcap: float | None = None,
                 alibi_heads: int | None = None, device=None):
        super().__init__(config, device)
        if alibi_heads is not None:
            raise NotImplementedError(
                "QuantSoftmax(alibi_heads=...) is not implemented by the "
                "PyTorch port yet")
        self.causal = causal
        self.window = None if window is None else int(window)
        self.softcap = None if softcap is None else float(softcap)

    def _masked(self, f: torch.Tensor, valid_len) -> torch.Tensor:
        if self.softcap is not None:
            f = attn_ops.softcap_(f, self.softcap)
        tq, tk = f.shape[-2], f.shape[-1]
        neg = f32(float("-inf"), f.device)
        window_done = False
        if self.causal and tq > 1 and tq == tk:
            row = torch.arange(tq, device=f.device).reshape(-1, 1)
            col = torch.arange(tk, device=f.device).reshape(1, -1)
            keep = col <= row
            if self.window is not None:
                keep = keep & (col > row - self.window)
            f = torch.where(keep, f, neg)
            window_done = True
        elif self.causal and tq > 1:
            if valid_len is None or not (
                    getattr(valid_len, "ndim", 0) >= 2
                    and valid_len.shape[-2] == tq):
                raise ValueError(
                    f"causal softmax expects square scores, got "
                    f"{tuple(f.shape)}; cached multi-row decode passes a "
                    f"PER-ROW valid_len (shape [..., tq, 1], row j = pos + "
                    f"j + 1) instead")
        if valid_len is not None:
            col = torch.arange(tk, device=f.device, dtype=torch.int32)
            keep = col < valid_len
            if self.window is not None and not window_done:
                keep = keep & (col >= valid_len - self.window)
            f = torch.where(keep, f, neg)
        return f

    def forward(self, x: Tensor, valid_len=None) -> Tensor:
        if not x.quantized:
            out = attn_ops.softmax_last(self._masked(x.data, valid_len))
            self._observe(out)
            return Tensor(out)
        self._check_converted()
        f = dequantize_u8(x.data, x.scale, x.zero_point)
        out = attn_ops.softmax_last(self._masked(f, valid_len))
        return Tensor(self._requant(out), self.scale, self.zero_point)


def _mean64(f: torch.Tensor) -> torch.Tensor:
    """The float32 mean over the last axis, accumulated in float64 and
    rounded once: the same on the card and the CPU whatever order their
    reductions add in."""
    return f.to(torch.float64).mean(dim=-1, keepdim=True).to(torch.float32)


def _rsqrt64(x: torch.Tensor) -> torch.Tensor:
    """``rsqrt`` of float32 ``x`` in float64, rounded once to float32 (the
    card's float32 rsqrt is an approximation)."""
    return torch.rsqrt(x.to(torch.float64)).to(torch.float32)


class QuantLayerNorm(Layer):
    """LayerNorm over the last axis with a calibrated u8 output; gamma/beta
    stay float32.  ``mean``, ``mean((f - mean)^2)`` and ``rsqrt(var +
    eps)`` are taken in the JAX package's order, each in float64 and rounded
    once to float32: a float32 mean adds in another order on the card than
    on the CPU, and the card's rsqrt is not correctly rounded, so either
    moved a code on a truncation boundary (a gpt2 decode at batch 8 on the
    card against its CPU copy; ``QuantRMSNorm`` likewise in a llama)."""

    def __init__(self, dim: int, eps: float = 1e-5,
                 config: QuantConfig = DEFAULT_CONFIG, device=None):
        super().__init__(config, device)
        self.dim = int(dim)
        self.eps = float(eps)
        self.register_buffer("weight", torch.ones(dim, device=self.device))
        self.register_buffer("bias", self._buf((dim,)))

    def load_weight(self, w):
        self.weight = self._load_array(w, (self.dim,), "load_weight")

    def load_bias(self, b):
        self.bias = self._load_array(b, (self.dim,), "load_bias")

    def _quantize_weights(self):
        pass                         # gamma/beta stay float32

    def _ln(self, f: torch.Tensor) -> torch.Tensor:
        mean = _mean64(f)
        var = _mean64(torch.square(f - mean))
        norm = (f - mean) * _rsqrt64(var + f32(self.eps, f.device))
        return norm * self.weight + self.bias

    def forward(self, x: Tensor) -> Tensor:
        if x.shape[-1] != self.dim:
            raise ValueError(
                f"QuantLayerNorm({self.dim}) got last-dim {x.shape[-1]}")
        if not x.quantized:
            out = self._ln(x.data)
            self._observe(out)
            return Tensor(out)
        self._check_converted()
        f = dequantize_u8(x.data, x.scale, x.zero_point)
        out = quantize_u8(self._ln(f), self.scale, self.zero_point,
                          self.config.rounding)
        return Tensor(out, self.scale, self.zero_point)


class QuantRMSNorm(Layer):
    """RMSNorm over the last axis with a calibrated u8 output (the llama
    family): ``y = x * rsqrt(mean(x^2) + eps) * g`` with ``g = weight``, or
    ``1 + weight`` under ``unit_offset`` (gemma checkpoints store the
    delta).  The gain stays float32.  The mean and the rsqrt run in
    float64 and round once, as ``QuantLayerNorm``'s do."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 config: QuantConfig = DEFAULT_CONFIG,
                 unit_offset: bool = False, device=None):
        super().__init__(config, device)
        self.dim = int(dim)
        self.eps = float(eps)
        self.unit_offset = bool(unit_offset)
        init = torch.zeros if unit_offset else torch.ones
        self.register_buffer("weight", init(dim, device=self.device))

    def load_weight(self, w):
        self.weight = self._load_array(w, (self.dim,), "load_weight")

    def load_bias(self, b):
        raise ValueError("QuantRMSNorm has no bias")

    def _quantize_weights(self):
        pass                         # the gain stays float32

    def _norm(self, f: torch.Tensor) -> torch.Tensor:
        ms = _mean64(torch.square(f))
        g = self.weight
        if self.unit_offset:
            g = f32(1.0, g.device) + g
        return f * _rsqrt64(ms + f32(self.eps, f.device)) * g

    def forward(self, x: Tensor) -> Tensor:
        if x.shape[-1] != self.dim:
            raise ValueError(
                f"QuantRMSNorm({self.dim}) got last-dim {x.shape[-1]}")
        if not x.quantized:
            out = self._norm(x.data)
            self._observe(out)
            return Tensor(out)
        self._check_converted()
        f = dequantize_u8(x.data, x.scale, x.zero_point)
        out = quantize_u8(self._norm(f), self.scale, self.zero_point,
                          self.config.rounding)
        return Tensor(out, self.scale, self.zero_point)


class QuantRoPE(_Weightless):
    """Rotary position embedding of head-split q or k ([B, H, T, D]) with a
    calibrated u8 output (``ops/rope.py``).  ``start`` offsets the
    positions: an int, a 0-dim tensor or a [B] tensor (one per row).
    ``rotary_dim`` rotates only the first channels of each head; the rest
    pass through onto this layer's grid.  The k-side layer's grid is the
    KV cache's: the angles come from one static ``inv_freq``, so prefill
    and decode give a position the same codes."""

    def __init__(self, head_dim: int, base: float = 10000.0,
                 config: QuantConfig = DEFAULT_CONFIG, scaling=None,
                 rotary_dim: int | None = None, device=None):
        super().__init__(config, device)
        if head_dim % 2:
            raise ValueError(f"RoPE head_dim must be even, got {head_dim}")
        self.head_dim = int(head_dim)
        self.base = float(base)
        self.scaling = tuple(scaling) if scaling is not None else None
        if rotary_dim is not None:
            rotary_dim = int(rotary_dim)
            if rotary_dim % 2 or not 0 < rotary_dim <= self.head_dim:
                raise ValueError(
                    f"rotary_dim must be even in (0, {self.head_dim}], "
                    f"got {rotary_dim}")
            if rotary_dim == self.head_dim:
                rotary_dim = None
        self.rotary_dim = rotary_dim
        freq, divisor = rope_ops.inv_freq(rotary_dim or self.head_dim,
                                          self.base, self.scaling)
        self._table = (freq.to(self.device), divisor)

    def _rotate(self, f: torch.Tensor, start) -> torch.Tensor:
        t = f.shape[-2]
        r = self.rotary_dim or self.head_dim
        pos = torch.arange(t, dtype=torch.int64, device=f.device)
        per_row = isinstance(start, torch.Tensor) and start.dim() == 1
        if per_row:
            pos = start.to(f.device, torch.int64)[:, None] + pos    # [B, T]
        else:
            pos = (start.to(f.device, torch.int64) if isinstance(
                start, torch.Tensor) else int(start)) + pos
        cos, sin = rope_ops.rope_angles(pos, r, table=self._table)
        if per_row:
            cos, sin = cos[:, None], sin[:, None]                # [B,1,T,r/2]
        if self.rotary_dim is None:
            return rope_ops.apply_rope(f, cos, sin)
        return torch.cat([rope_ops.apply_rope(f[..., :r], cos, sin),
                          f[..., r:]], dim=-1)

    def forward(self, x: Tensor, start=0) -> Tensor:
        if x.shape[-1] != self.head_dim:
            raise ValueError(
                f"QuantRoPE(head_dim={self.head_dim}) got head-split "
                f"last-dim {x.shape[-1]}")
        if not x.quantized:
            out = self._rotate(x.data, start)
            self._observe(out)
            return Tensor(out)
        self._check_converted()
        f = dequantize_u8(x.data, x.scale, x.zero_point)
        return Tensor(self._requant(self._rotate(f, start)), self.scale,
                      self.zero_point)


class QuantPosEmbed(Layer):
    """Learned positional embedding with a calibrated output.

    ``cls=True`` (ViT stem): prepends the class token (``bias`` [C]) to the
    [B, T, C] tokens and adds ``weight`` [T+1, C].  ``cls=False`` (decoder
    stem): ``weight`` is [num_tokens, C], the input may be any T <=
    num_tokens, and ``start`` offsets the table rows: an int, a 0-dim
    tensor (one position for the batch) or a [B] tensor (one per row); a
    tensor start is gathered on its device, with no host sync."""

    def __init__(self, num_tokens: int, dim: int,
                 config: QuantConfig = DEFAULT_CONFIG, cls: bool = True,
                 device=None):
        super().__init__(config, device)
        self.num_tokens = int(num_tokens)
        self.dim = int(dim)
        self.cls = cls
        rows = num_tokens + 1 if cls else num_tokens
        self.register_buffer("weight", self._buf((rows, dim)))
        self.register_buffer("bias", self._buf((dim,)) if cls else None)

    def load_weight(self, w):
        rows = self.num_tokens + 1 if self.cls else self.num_tokens
        self.weight = self._load_array(w, (rows, self.dim), "load_weight")

    def load_bias(self, b):
        if not self.cls:
            raise ValueError("cls=False QuantPosEmbed has no bias")
        self.bias = self._load_array(b, (self.dim,), "load_bias")

    def _quantize_weights(self):
        pass                         # additive float32 tables stay float32

    def _apply(self, f: torch.Tensor, start) -> torch.Tensor:
        if self.cls:
            cls = self.bias.reshape(1, 1, self.dim).expand(f.shape[0], 1,
                                                           self.dim)
            return torch.cat([cls, f], dim=1) + self.weight
        t = f.shape[1]
        if not isinstance(start, torch.Tensor):
            return f + self.weight[int(start):int(start) + t]
        steps = torch.arange(t, device=f.device)
        if start.dim() == 1:
            idx = start.to(f.device, torch.int64).reshape(-1, 1) + steps
            return f + self.weight[idx]
        return f + self.weight.index_select(0, start.to(torch.int64) + steps)

    def forward(self, x: Tensor, start=0) -> Tensor:
        if self.cls:
            if len(x.shape) != 3 or x.shape[1] != self.num_tokens \
                    or x.shape[2] != self.dim:
                raise ValueError(
                    f"QuantPosEmbed expects [B, {self.num_tokens}, "
                    f"{self.dim}] tokens, got {x.shape}")
        elif len(x.shape) != 3 or x.shape[1] > self.num_tokens \
                or x.shape[2] != self.dim:
            raise ValueError(
                f"QuantPosEmbed(cls=False) expects [B, <= "
                f"{self.num_tokens}, {self.dim}] tokens, got {x.shape}")
        if not x.quantized:
            out = self._apply(x.data, start)
            self._observe(out)
            return Tensor(out)
        self._check_converted()
        f = dequantize_u8(x.data, x.scale, x.zero_point)
        out = quantize_u8(self._apply(f, start), self.scale, self.zero_point,
                          self.config.rounding)
        return Tensor(out, self.scale, self.zero_point)


class QuantEmbed(Layer):
    """Token embedding with a pre-quantized table (the NLP stem).

    Takes token ids (integer, or float32 holding integers) and clamps them
    into the table.  The FP32 path gathers float rows and is observed;
    ``convert()`` widens the observed range to the whole table and
    quantizes all of it once (``q_weight`` u8 [V, C]), so the INT8 path is a
    pure u8 row gather.  ``Module`` skips input quantization for a model
    with an id-consuming layer (``consumes_ids``)."""

    consumes_ids = True

    def __init__(self, vocab_size: int, dim: int,
                 config: QuantConfig = DEFAULT_CONFIG, device=None):
        super().__init__(config, device)
        self.vocab_size = int(vocab_size)
        self.dim = int(dim)
        self.register_buffer("weight", self._buf((vocab_size, dim)))
        self.register_buffer("q_weight", None)

    def load_weight(self, w):
        self.weight = self._load_array(w, (self.vocab_size, self.dim),
                                       "load_weight")

    def load_bias(self, b):
        raise ValueError("QuantEmbed has no bias")

    def convert(self):
        # the whole table is quantized at the calibrated grid, so the range
        # covers every row, not only the tokens calibration happened to see
        if self.is_preparing and self.calibrator is not None:
            self.calibrator.sample(self.weight)
        super().convert()

    def _quantize_weights(self):
        if self.config.weight_only:
            return                   # float activations: the table stays
        self.q_weight = quantize_u8(self.weight, self.scale, self.zero_point,
                                    self.config.rounding)
        self.weight = None

    def forward(self, ids: Tensor) -> Tensor:
        if ids.quantized:
            raise ValueError(
                "QuantEmbed consumes raw token ids, not quantized codes")
        idx = ids.data.to(torch.int64).clamp(0, self.vocab_size - 1)
        if not self.is_quantized or self.config.weight_only:
            out = self.weight[idx]
            self._observe(out)
            return Tensor(out)
        return Tensor(self.q_weight[idx], self.scale, self.zero_point)


def fused_qkv(wq: Linear, wk: Linear, wv: Linear, x: Tensor) -> tuple:
    """The three attention projections sharing input ``x`` as one GEMM
    (``ops/gemm_int8.qgemm_multi``, kernel B2): the same codes as calling
    each Linear, one launch instead of three.  The merged operands are
    built once per input grid and kept on ``wq``.  ``fuse_qkv='xla'`` runs
    the merged GEMM's plain version; a group that is not converted, or has
    a fused relu, runs the three Linears."""
    heads = (wq, wk, wv)
    cfg = wq.config
    if cfg.weight_bits == 4:
        merged = fused_w4a8_multi(heads, x)
        if merged is not None:
            return merged
    if not (x.quantized and cfg.weight_bits == 8 and not cfg.weight_only
            and all(l.is_quantized and not l.fuse_relu for l in heads)):
        return wq(x), wk(x), wv(x)
    key = (x.scale, x.zero_point, id(wk), id(wv))
    merged = wq._merged_cache.get(key)
    if merged is None:
        parts = []
        for l in heads:
            oc, _ = l._epilogue(x, "gemm")
            parts.append(dict(w_s8_nk=l.qw, oc=oc, scale_w=l.w_scale,
                              scale_c=l.scale, zp_c=l.zero_point))
        merged = wq._merged_cache[key] = merge_parts(
            parts, scale_a=x.scale, zp_a=x.zero_point)
    gemm = qgemm_multi_plain if wq.config.fuse_qkv == "xla" else qgemm_multi
    outs = gemm(x.data.contiguous(), merged, rounding=wq.config.rounding)
    return tuple(Tensor(o, l.scale, l.zero_point) for l, o in zip(heads, outs))


def fused_w4a8_multi(layers, x: Tensor):
    """Several converted W4A8 Linears sharing input ``x`` as one call of the
    W4A8 dispatch (``ops/w4.w4a8_apply`` on operands concatenated along N,
    each column keeping its own layer's mult and zpb): the same codes as the
    per-layer calls, one launch instead of several.  The merged operands are
    built once per input grid and kept on the first layer.  Returns None
    when the group is not mergeable (then callers run the layers one by
    one)."""
    first = layers[0]
    cfg = first.config
    if not (x.quantized and cfg.weight_bits == 4 and not cfg.weight_only
            and all(l.is_quantized and not l.fuse_relu
                    and l.w4_packed is not None
                    and l.in_channels == first.in_channels for l in layers)):
        return None
    key = (x.scale, x.zero_point) + tuple(id(l) for l in layers[1:])
    ops = first._merged_cache.get(key)
    if ops is None:
        ops = first._merged_cache[key] = w4_ops.merge_operands(
            [l.w4a8_operands(x) for l in layers])
    out = w4_ops.w4a8_apply(x.data.contiguous(), ops, backend=cfg.w4_kernel,
                            rounding=cfg.rounding)
    outs = torch.split(out, ops["widths"], dim=1)
    return tuple(Tensor(o, l.scale, l.zero_point)
                 for l, o in zip(layers, outs))


def fused_linear_act(linear: Linear, act: QuantAct, x: Tensor) -> Tensor:
    """A converted Linear -> QuantAct pair as one GEMM with the activation in
    the requant epilogue: the same codes as ``act(linear(x))`` (the
    intermediate u8 grid is replayed in registers), without the standalone
    pass over the Linear's output.  Pairs the kernel cannot fuse (a custom
    fn, the lut backend, 4-bit or weight-only layers) run composed."""
    fusable = (linear.is_quantized and act.is_quantized and x.quantized
               and linear.config.weight_bits == 8
               and not linear.config.weight_only
               and act.fn_name in KERNEL_ACTS
               and act.fn is ACTIVATIONS.get(act.fn_name)
               and act.backend == "elementwise")
    if not fusable:
        return act(linear(x))
    return linear._forward_int8(x, act=(act.fn_name, act.scale,
                                        act.zero_point))


def fused_decode_attention(attn: QuantMatmul, smax: QuantSoftmax,
                           av: QuantMatmul, q2: Tensor, kc: Tensor,
                           vc: Tensor, valid, head_dim: int) -> Tensor:
    """One query row per sequence against the flat KV cache: semantically
    ``merge(av(smax(attn(split(q), split(k)), valid_len=valid), split(v)))``
    after convert, through ``ops/attention.decode_attention_flat`` (kernel
    B3 on the card; ``decode_attention='off'``/``'xla'`` runs the composed
    plain version).  ``q2`` [B, C], ``kc``/``vc`` [B, T, C_kv]."""
    if not (attn.is_quantized and smax.is_quantized and av.is_quantized):
        raise RuntimeError("fused_decode_attention requires converted "
                           "layers")
    if not attn.transpose_b or av.transpose_b or av.alpha != 1.0:
        raise ValueError("fused_decode_attention expects attn=QK^T "
                         "(transpose_b) and a plain P@V")
    backend = attn.config.decode_attention
    out = attn_ops.decode_attention_flat(
        q2.data, kc.data, vc.data, valid,
        n_heads=q2.data.shape[-1] // head_dim,
        n_kv_heads=kc.data.shape[-1] // head_dim,
        backend="xla" if backend == "off" else backend,
        scale_q=q2.scale, zp_q=q2.zero_point,
        scale_k=kc.scale, zp_k=kc.zero_point,
        scale_v=vc.scale, zp_v=vc.zero_point,
        scale_s=attn.scale, zp_s=attn.zero_point,
        scale_p=smax.scale, zp_p=smax.zero_point,
        scale_c=av.scale, zp_c=av.zero_point,
        alpha=attn.alpha, rounding=attn.config.rounding,
        window=smax.window, softcap=smax.softcap)
    return Tensor(out, av.scale, av.zero_point)
