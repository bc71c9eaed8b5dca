"""Layers: Linear and Conv2d with the load -> prepare -> convert lifecycle
(counterpart of ``int8inferenceengine_tpu.layers``).

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
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
from torch import nn

from .calibrator import Calibrator
from .config import DEFAULT_CONFIG, QuantConfig, check_supported
from .ops import conv as conv_ops
from .ops import quant as quant_ops
from .ops.gemm_int8 import compute_offset, epilogue_vector, qgemm
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
            warnings.warn("Not prepared, using default config (scale=1, zp=0)")
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

    def _check_int8(self, x: Tensor):
        if not self.is_quantized:
            raise RuntimeError("layer not converted; call convert() first")
        if x.device != self.qw.device:
            raise ValueError(f"input on {x.device}, layer on {self.qw.device}")

    def _check_fp32(self):
        if self.is_quantized:
            raise RuntimeError(
                "layer already converted to INT8 — quantize the input "
                "(FP32 weights were freed, as in the reference)")


class Linear(Layer):
    """Fully-connected layer; torch-style weight [out, in]."""

    def __init__(self, in_channels: int, out_channels: int,
                 config: QuantConfig = DEFAULT_CONFIG, fuse_relu: bool = False,
                 device=None):
        super().__init__(config, device)
        self.in_channels = int(in_channels)
        self.out_channels = int(out_channels)
        self.fuse_relu = fuse_relu
        self.register_buffer("weight", self._buf((out_channels, in_channels)))
        self.register_buffer("bias", self._buf((out_channels,)))

    def load_weight(self, w):
        self.weight = self._load_array(
            w, (self.out_channels, self.in_channels), "load_weight")

    def forward(self, x: Tensor) -> Tensor:
        if len(x.shape) != 2:
            raise ValueError(
                f"Linear expects a 2D input, got shape {x.shape}; reshape first")
        if x.quantized:
            return self._forward_int8(x)
        return self._forward_fp32(x)

    def _forward_fp32(self, x: Tensor) -> Tensor:
        self._check_fp32()
        out = torch.matmul(x.data, self.weight.t()) + self.bias.reshape(1, -1)
        self._observe(out)
        return Tensor(out)

    def _forward_int8(self, x: Tensor) -> Tensor:
        self._check_int8(x)
        oc, ep = self._epilogue(x, "gemm")
        out = qgemm(x.data.contiguous(), self.qw, oc, ep,
                    scale_a=x.scale, scale_c=self.scale, zp_c=self.zero_point,
                    relu=self.fuse_relu, rounding=self.config.rounding,
                    order="gemm")
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
            rounding=self.config.rounding, order=order)
        return Tensor(out, self.scale, self.zero_point, _nhwc=True)
