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

Under ``QuantConfig(weight_only=True)`` (8-bit weights) a converted
``Linear``/``Conv2d`` keeps float activations and holds ``q_weight`` (s8,
``weight``'s layout), ``w_scale`` and the float32 ``bias``: the W8-float
forward dequantizes the weight at every call and runs one float32 product
(``ops/weight_only.w8f_matmul``, ``ops/conv.w8f_conv2d``); with
``dynamic_act=True`` each row (each image of a conv) quantizes to s8 at its
own scale (``ops/quant.quantize_dynamic``), the product accumulates
exactly in s32 (``ops/weight_only.s8_matmul``, ``ops/conv.conv2d_s8``) and
``acc * (s_a * s_w) + bias`` dequantizes it.

Two lifecycle levers shape a ``Linear``/``Conv2d``'s conversion:
``QuantConfig.bias_correction`` folds the expected weight-quantization
error ``E[(W - s_w*W_q) x]``, from the input means observed while
preparing, into the bias before its s8 quantization (``groups == 1``
convs only); and ``Module.convert(skip=...)`` leaves a layer an FP32
island (``quant_fallback``): it keeps its float weights and takes u8 codes
to u8 codes through a float product (``fp32_island``).

The accuracy levers of ``utils`` read each ``Linear``/``Conv2d``'s FP32
input through ``_INPUT_TAP`` and the scale ``convert()`` will use through
``weight_quant_spec``; AdaRound and GPTQ leave integer codes in
``_adaround_qw`` (and 4-bit group scales in ``_adaround_scales``), which
``convert()`` takes in place of rounding in every weight mode.

The transformer layers (``QuantEmbed``, ``QuantPosEmbed``,
``QuantLayerNorm``, ``QuantMatmul``, ``QuantSoftmax``, ``QuantAct``,
``QuantAdd``) follow the same lifecycle: their FP32 path observes its
output while preparing, and after convert the INT8 path dequantizes its u8
inputs, computes in float32 in the JAX package's order and requantizes to
the calibrated output grid.  ``fused_qkv``, ``fused_linear_act`` and
``fused_decode_attention`` run converted layer groups through one kernel
each (``QuantConfig.fuse_qkv``, ``fuse_linear_act``, ``decode_attention``);
``fused_attention`` runs the encoders' QK^T -> softmax -> P@V chain as one
composed op (``QuantConfig.fused_attention``).
"""

from __future__ import annotations

import contextvars
import math
import warnings

import numpy as np
import torch
from torch import nn

from .calibrator import Calibrator
from .config import DEFAULT_CONFIG, QuantConfig, check_supported
from .ops import attention as attn_ops
from .ops import conv as conv_ops
from .ops import moe as moe_ops
from .ops import quant as quant_ops
from .ops import rope as rope_ops
from .ops import w4 as w4_ops
from .ops import weight_only as wo_ops
from .ops.functional import ACTIVATIONS
from .ops.gemm_int8 import (KERNEL_ACTS, compute_offset, epilogue_vector,
                            merge_parts, qgemm, qgemm_multi,
                            qgemm_multi_plain, qgemm_plain)
from .ops.qmatmul import qmatmul_act
from .ops.quant import (dequantize_dynamic, dequantize_u8, f32,
                        quantize_dynamic, quantize_u8)
from .tensor import Tensor, resolve_device

# Input tap (utils.smooth / gptq / adaround): when set, the FP32 forwards of
# Linear and Conv2d append their input under id(layer): a Linear's [M, K]
# rows, a Conv2d's NCHW batch (what the levers' layer output reads), on
# the layer's device.
_INPUT_TAP: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "i8ie_torch_input_tap", default=None)


def _tap(layer, x: torch.Tensor) -> None:
    tap = _INPUT_TAP.get()
    if tap is not None:
        tap.setdefault(id(layer), []).append(x)


# Cost sink (utils.roofline): when set, layers append (layer, flops, bytes)
# records as the forward runs, with the JAX package's counts (each input
# and output once, the weights at their stored width).
_COST_SINK: contextvars.ContextVar[list | None] = contextvars.ContextVar(
    "i8ie_torch_cost_sink", default=None)


def _record_cost(layer, flops: int, nbytes: int) -> None:
    sink = _COST_SINK.get()
    if sink is not None:
        sink.append((layer, int(flops), int(nbytes)))


def _record_int8_linear(layer, x, out: torch.Tensor, per_byte: int) -> None:
    """A u8-in, u8-out Linear's cost (``per_byte`` weights a byte: 2 for
    4-bit ones)."""
    kn = layer.in_channels * layer.out_channels
    _record_cost(layer, 2 * out.shape[0] * kn,
                 x.data.numel() + out.numel() + kn // per_byte)


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
        # Module.convert(skip=...): an FP32 island behind the u8 interface
        self.quant_fallback = False
        # the calibrator's observed range, kept at convert() for
        # ``utils.quantization_report`` (not part of a checkpoint)
        self.calib_stats: dict | None = None
        # bias correction's running input mean (float64) and its count
        self._in_mean = None
        self._in_count = 0
        # integer weight codes chosen by utils.adaround / utils.gptq in
        # ``weight``'s layout (s8 values; 4-bit codes in -7..7 with their
        # group scales), taken by convert() in place of rounding
        self._adaround_qw = None
        self._adaround_scales = None
        # (input scale, input zp) -> (oc, ep): both depend only on the
        # input grid, which is fixed once the model is converted.
        self._epilogue_cache: dict = {}
        # fused_qkv's merged operands, on the first layer of the group
        self._merged_cache: dict = {}
        # Tensor-parallel roles, set by parallel.sharding (Module.shard):
        # _tp_sharded — output channels sharded over the model axis (the
        # output is all-gathered); _tp_local — column-parallel with the
        # output kept a channel shard (head-local attention, a row-parallel
        # consumer); _tp_row — input channels sharded, int32 partials summed
        # before the requant; _tp_expert — a QuantMoE's experts split.
        # _tp_view holds this rank's slices, bound by
        # parallel.sharding.local_params while a sharded forward runs.
        self._tp_sharded = False
        self._tp_local = False
        self._tp_row = False
        self._tp_expert = False
        self._tp_view: dict = {}
        for name in ("qw", "q_bias", "rowsum", "w_scale"):
            self.register_buffer(name, None)

    def _maybe_gather(self, out: torch.Tensor, channel_axis: int
                      ) -> torch.Tensor:
        if self._tp_sharded:
            from .parallel.sharding import gather_channels
            return gather_channels(out, channel_axis)
        return out

    @staticmethod
    def _overlap_axes():
        """The active ParallelAxes when overlap mode is on, else None."""
        from .parallel.context import current_axes
        pa = current_axes()
        if pa is not None and pa.overlap and pa.model_size > 1:
            return pa
        return None

    @staticmethod
    def _active_axes():
        """The active ParallelAxes with a real model axis, else None."""
        from .parallel.context import current_axes
        pa = current_axes()
        if pa is not None and pa.model_size > 1:
            return pa
        return None

    def _tp_result(self, out: torch.Tensor, scale, zero_point) -> Tensor:
        """A column-parallel [M, N_local] output: kept a channel shard in
        overlap mode or for a sharded consumer (``_tp_local``), else
        all-gathered (nothing to do without a TP context)."""
        if self._tp_sharded and (self._overlap_axes() is not None or (
                self._tp_local and self._active_axes() is not None)):
            return Tensor(out, scale, zero_point, _tp_sharded=True)
        return Tensor(self._maybe_gather(out, 1), scale, zero_point)

    @staticmethod
    def _gathered(x: Tensor) -> Tensor:
        """``x`` with full channels: a channel shard is all-gathered."""
        if not x._tp_sharded:
            return x
        from .parallel.sharding import gather_channels
        return Tensor(gather_channels(x.data, 1), x.scale, x.zero_point)

    def _buf(self, shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _observe(self, out: torch.Tensor) -> None:
        if self.is_preparing:
            self.calibrator.sample(out)

    def _observe_in_mean(self, x: torch.Tensor, dims) -> None:
        """While preparing under ``bias_correction``, fold the batch's
        per-input-channel mean of ``x`` over ``dims`` into the running mean
        (the JAX package's count-weighted merge), in float64 on the
        layer's device."""
        if not (self.is_preparing and self.config.bias_correction):
            return
        count = math.prod(int(x.shape[d]) for d in dims)
        mean = x.to(torch.float64).mean(dim=dims)
        if self._in_mean is None:
            self._in_mean, self._in_count = mean, count
            return
        total = self._in_count + count
        self._in_mean = (self._in_mean * self._in_count + mean * count) / total
        self._in_count = total

    def _bias_error(self, deq: torch.Tensor) -> torch.Tensor:
        """``(W - deq) @ E[x]``, the bias correction's term (float32 [N]):
        the difference is taken in float32 as the JAX package takes it, the
        reduction in float64, rounded once.  A conv's taps sum over the
        kernel window first."""
        diff = (self.weight - deq).to(torch.float64)
        if diff.dim() == 4:
            diff = diff.sum(dim=(2, 3))
        return torch.matmul(diff, self._in_mean).to(torch.float32)

    def _corrects_bias(self) -> bool:
        return (self.config.bias_correction and self._in_mean is not None
                and getattr(self, "groups", 1) == 1)

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
        self._in_mean = None
        self._in_count = 0
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
            self.calib_stats = self.calibrator.stats()
            self.calibrator = None
        self._quantize_weights()
        self.is_preparing = False
        self.is_quantized = True

    def _kernel_weight(self, q_w: torch.Tensor) -> torch.Tensor:
        """Quantized weight (``weight``'s layout) -> s8 [N, K]."""
        return q_w

    def _quantize_weights(self):
        if self.quant_fallback:
            return                      # FP32 island: weights stay float
        rnd = self.config.rounding
        if self.config.weight_per_channel:
            q_w, q_b, s_w = quant_ops.quantize_weight_per_channel(
                self.weight, self.bias, channel_axis=0,
                rounding=rnd)
        else:
            q_w, q_b, s_w = quant_ops.quantize_weight_joint_scale(
                self.weight, self.bias, rounding=rnd)
        if self._adaround_qw is not None:
            # the levers' codes at the same scale (bias correction below
            # folds their error, not rounding's)
            q_w = self._adaround_qw.to(device=self.device, dtype=torch.int8)
        if self.config.weight_only:
            # W8-float / dynamic: the bias stays float32, unquantized
            self.set_weight_only(q_w, self.bias, s_w)
            return
        if self._corrects_bias():
            s = f32(s_w, self.device).reshape((-1,) + (1,) * (q_w.dim() - 1))
            q_b = quant_ops.quantize_s8(
                self.bias + self._bias_error(s * q_w.to(torch.float32)), s_w,
                rnd)
        qw = self._kernel_weight(q_w).contiguous()
        self.set_quantized(qw, q_b, s_w)

    def set_weight_only(self, q_w: torch.Tensor, bias: torch.Tensor, s_w):
        """Install 8-bit weight-only weights: s8 ``q_w`` in ``weight``'s
        layout, the float32 ``bias`` and the weight scale (a float, or an
        f32 [N] tensor per channel); the FP32 weight is freed."""
        n = q_w.shape[0]
        self.weight_scale = s_w if isinstance(s_w, float) else s_w.to(
            device=self.device, dtype=torch.float32)
        self.q_weight = q_w.to(device=self.device,
                               dtype=torch.int8).contiguous()
        self.w_scale = quant_ops.f32(s_w, self.device).expand(n).contiguous()
        self.bias = bias.to(device=self.device,
                            dtype=torch.float32).contiguous()
        self.weight = None

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
        """``arr`` (a torch tensor, any view, or an array) as this layer's
        contiguous float32 tensor.  A host array bound for the card crosses
        as it is, without a host copy, and converts there."""
        if isinstance(arr, torch.Tensor):
            a = arr.detach()
        else:
            a = np.asarray(arr)
            if (self.device.type == "cpu" or not a.flags.writeable
                    or min(a.strides, default=0) < 0):
                a = torch.tensor(np.asarray(a, dtype=np.float32))
            else:
                a = torch.from_numpy(a)
        if tuple(a.shape) != tuple(expected_shape):
            raise ValueError(
                f"{type(self).__name__}.{what}: shape {tuple(a.shape)} != "
                f"expected {tuple(expected_shape)}")
        return a.to(device=self.device, dtype=torch.float32).contiguous()

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
        if self.config.weight_only:
            raise RuntimeError("a weight-only layer takes float input")
        w = self.qw if self.qw is not None else getattr(self, "w4_packed",
                                                        None)
        if w is not None and x.device != w.device:
            raise ValueError(f"input on {x.device}, layer on {w.device}")

    def _check_fp32(self):
        if self.is_quantized and not self.config.weight_only \
                and not self.quant_fallback:
            raise RuntimeError(
                "layer already converted to INT8 — quantize the input "
                "(FP32 weights were freed, as in the reference)")

    def _glue_dtype(self):
        """Compute dtype of the calibrated pointwise glue
        (``QuantConfig.glue_dtype``)."""
        return (torch.bfloat16 if self.config.glue_dtype == "bfloat16"
                else torch.float32)

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
    kernel B5.  8-bit ``weight_only`` runs W8F or, with ``dynamic_act``,
    DA (see the module docstring)."""

    def __init__(self, in_channels: int, out_channels: int,
                 config: QuantConfig = DEFAULT_CONFIG, fuse_relu: bool = False,
                 device=None):
        super().__init__(config, device)
        self.in_channels = int(in_channels)
        self.out_channels = int(out_channels)
        self.fuse_relu = fuse_relu
        self.register_buffer("weight", self._buf((out_channels, in_channels)))
        self.register_buffer("bias", self._buf((out_channels,)))
        for name in ("w4_packed", "w4_scales", "w4_wsum", "q_weight"):
            self.register_buffer(name, None)

    def load_weight(self, w):
        self.weight = self._load_array(
            w, (self.out_channels, self.in_channels), "load_weight")

    def _quantize_weights(self):
        if self.config.weight_bits != 4 or self.quant_fallback:
            return super()._quantize_weights()
        if self.config.dynamic_act:
            raise ValueError(
                "dynamic_act requires s8 weights (weight_bits=8)")
        if self._adaround_qw is not None:
            # the levers' 4-bit codes and group scales, packed in pack_w4's
            # nibble order (even column high)
            codes = (self._adaround_qw.to(self.device, torch.int32) + 8).to(
                torch.uint8)
            packed = ((codes[:, 0::2] << 4) | codes[:, 1::2]).contiguous()
            scales = self._adaround_scales.to(self.device, torch.float32)
        else:
            packed, scales = w4_ops.pack_w4(
                self.weight, self.config.w4_group,
                optimize=self.config.w4_mse_scales)
        bias, wsum = self.bias, None
        if not self.config.weight_only:
            wsum = w4_ops.weight_rowsum(packed, scales, self.in_channels,
                                        self.config.w4_group)
            if self._corrects_bias():
                bias = bias + self._bias_error(w4_ops.dequant_w4(
                    packed, scales, self.in_channels, self.config.w4_group))
        self.set_w4(packed, scales, bias, wsum)

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

    def _float(self, x: torch.Tensor) -> torch.Tensor:
        """The FP32 product ``x @ W^T + b`` (float32 [M, K] -> [M, N])."""
        return torch.matmul(x, self.weight.t()) + self.bias.reshape(1, -1)

    def _forward_fp32(self, x: Tensor) -> Tensor:
        self._check_fp32()
        if self.is_quantized and not self.quant_fallback:   # weight-only
            x = self._gathered(x)
            return Tensor(self._maybe_gather(
                self._forward_weight_only(x.data), 1))
        pa_row = self._active_axes() if self._tp_row else None
        if pa_row is not None:
            return self._forward_fp32_row(x, pa_row)
        x = self._gathered(x)
        _tap(self, x.data)
        out = self._float(x.data)
        self._observe(out)
        self._observe_in_mean(x.data, (0,))
        _record_cost(self, 2 * out.shape[0] * self.in_channels
                     * self.out_channels,
                     4 * (x.data.numel() + out.numel()
                          + self.in_channels * self.out_channels))
        return Tensor(self._maybe_gather(out, 1))

    def _forward_fp32_row(self, x: Tensor, pa) -> Tensor:
        """Row-parallel FP32: the weight is this rank's [N, K_local] slice;
        the float32 partial products are summed over the model group
        (allclose to the unsharded product — the float32 addition order
        differs; the INT8 path is the bit-exact one)."""
        from .parallel.sharding import all_reduce_sum
        if _INPUT_TAP.get() is not None:
            raise RuntimeError(
                "input-tap optimizers (AdaRound/GPTQ) can't observe a "
                "row-parallel Linear's inputs — run them BEFORE shard(), "
                "on the unsharded model")
        if self.is_preparing and self.config.bias_correction:
            raise RuntimeError(
                "bias_correction needs full input-mean statistics, which a "
                "row-parallel Linear only sees a K-shard of — calibrate "
                "before shard(), or shard after convert()")
        k_local = self.weight.shape[1]
        if x._tp_sharded:
            a = x.data
        else:
            a = x.data[:, pa.model_index * k_local:
                       (pa.model_index + 1) * k_local]
        out = all_reduce_sum(torch.matmul(a, self.weight.t()), pa.model_group
                             ) + self.bias.reshape(1, -1)
        self._observe(out)
        _record_cost(self, 2 * out.shape[0] * k_local * self.out_channels,
                     4 * (a.numel() + out.numel()))
        return Tensor(out)

    def _forward_weight_only(self, x: torch.Tensor) -> torch.Tensor:
        """float32 [M, K] -> [M, N]: W4 (kernel B5), W8F or DA."""
        kn = self.in_channels * self.out_channels
        if self.config.weight_bits == 4:
            out = w4_ops.w4_matmul(x.contiguous(), self.w4_packed,
                                   self.w4_scales, self.bias,
                                   self.in_channels, self.config.w4_group,
                                   backend=self.config.w4_kernel)
            kn //= 2
        elif not self.config.dynamic_act:
            out = wo_ops.w8f_matmul(x, self.q_weight, self.w_scale,
                                    self.bias)
        else:
            a, s_a = quantize_dynamic(x, (1,))   # per-token scales [M, 1]
            acc = wo_ops.s8_matmul(a, self.q_weight)
            out = dequantize_dynamic(acc, s_a, self.w_scale.reshape(1, -1),
                                     self.bias.reshape(1, -1))
        _record_cost(self, 2 * out.shape[0] * self.in_channels
                     * self.out_channels,
                     4 * (x.numel() + out.numel()) + kn)
        return out

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
        if self.quant_fallback:
            out = fp32_island(self, self._gathered(x))
            return Tensor(self._maybe_gather(out.data, 1), out.scale,
                          out.zero_point)
        if self.config.weight_bits == 4:
            # W4A8 accumulates in float: no integer partials to sum, so
            # parallel/sharding.py keeps these layers replicated
            if self._tp_row:
                raise RuntimeError(
                    "W4A8 Linear does not support row-parallel TP (float "
                    "partial sums do not add bit-exactly); keep "
                    "weight_bits=8 on 'row'-role layers")
            if act is not None:
                raise RuntimeError("W4A8 has no fused-act epilogue; "
                                   "fused_linear_act composes it")
            x = self._gathered(x)
            out = w4_ops.w4a8_apply(x.data.contiguous(),
                                    self.w4a8_operands(x),
                                    backend=self.config.w4_kernel,
                                    rounding=self.config.rounding)
            if self.fuse_relu:
                out = out.clamp_min(self.zero_point)
            _record_int8_linear(self, x, out, 2)
            return Tensor(self._maybe_gather(out, 1), self.scale,
                          self.zero_point)
        if self._tp_row:
            pa_row = self._active_axes()
            if pa_row is not None:
                return self._forward_int8_row(x, pa_row, act)
            raise RuntimeError(
                "row-parallel Linear called outside an active TP context "
                "(its rowsum/weight params are shard-structured); run "
                "through the sharded forward — module(x) after shard() — "
                "not a direct call")
        oc, ep = self._epilogue(x, "gemm")
        if x._tp_sharded:
            pa = self._overlap_axes()
            if pa is not None and self._tp_sharded and act is None:
                # ring TP: consume the predecessor's channel shard
                # directly, the transfers overlapping partial products
                from .parallel.overlap import ring_qgemm
                out = ring_qgemm(x.data.contiguous(), self.qw, oc, ep, pa=pa,
                                 scale_a=x.scale, scale_c=self.scale,
                                 zp_c=self.zero_point, relu=self.fuse_relu,
                                 rounding=self.config.rounding)
                return Tensor(out, self.scale, self.zero_point,
                              _tp_sharded=True)
            x = self._gathered(x)
        out = self._gemm()(x.data.contiguous(), self.qw, oc, ep,
                           scale_a=x.scale, scale_c=self.scale,
                           zp_c=self.zero_point, relu=self.fuse_relu,
                           rounding=self.config.rounding, order="gemm",
                           act=act)
        _record_int8_linear(self, x, out, 1)
        if act is not None:
            return self._tp_result(out, act[1], act[2])
        return self._tp_result(out, self.scale, self.zero_point)

    def _forward_int8_row(self, x: Tensor, pa, act=None) -> Tensor:
        """Row-parallel INT8 forward (``ops/gemm_int8.qgemm_row_parallel``):
        the weight is this rank's [N, K_local] slice; it consumes the
        producer's channel shard directly (or slices a replicated input),
        sums the s32 partial accumulators over the model group and
        requantizes once — bit-identical to the unsharded layer (integer
        addition is associative)."""
        from .ops.gemm_int8 import qgemm_row_parallel
        k_local = self.qw.shape[1]
        if x._tp_sharded:
            if x.data.shape[-1] != k_local:
                raise ValueError(
                    f"row-parallel Linear expected a [*, {k_local}] input "
                    f"shard, got {tuple(x.data.shape)}")
            a = x.data
        else:
            a = x.data[:, pa.model_index * k_local:
                       (pa.model_index + 1) * k_local]
        _, ep = self._epilogue(x, "gemm")
        out = qgemm_row_parallel(
            a.contiguous(), self.qw, self.rowsum, self.q_bias, ep,
            group=pa.model_group, scale_a=x.scale, zp_a=x.zero_point,
            scale_c=self.scale, zp_c=self.zero_point, relu=self.fuse_relu,
            rounding=self.config.rounding, act=act)
        _record_cost(self, 2 * out.shape[0] * k_local * self.out_channels,
                     a.numel() + out.numel() + k_local * self.out_channels)
        if act is not None:
            return Tensor(out, act[1], act[2])
        return Tensor(out, self.scale, self.zero_point)


class Conv2d(Layer):
    """2D convolution; torch-style weight [out_c, in_c/groups, kh, kw].

    The FP32 path runs NCHW through ``F.conv2d``; the INT8 path runs NHWC
    through the quantized GEMM kernel (B1's gathered conv on the card,
    im2col + its plain version on the CPU), or, where ``groups`` > 1,
    through the grouped conv (kernel G1 on the card, its plain version on
    the CPU).  8-bit ``weight_only`` (the only weight-only conv: the JAX
    package's ``weight_bits`` shapes Linears alone) runs W8F, or DAC with
    per-image scales under ``dynamic_act``, on NCHW floats.
    ``bias_correction`` applies at ``groups == 1`` only (a grouped conv
    observes no input means), as in the JAX package.
    ``conv_backend='xla_conv'`` is another name for 'auto'.  A host-ingest
    batch pre-laid-out for this conv (``ingest_descriptor``) runs as a
    stride-1 conv over ``s*s*C`` channels on the space-to-depth weight."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 config: QuantConfig = DEFAULT_CONFIG, fuse_relu: bool = False,
                 device=None):
        super().__init__(config, device)
        if stride == 0:
            raise ValueError("stride must be >= 1 (reference: conv2d.h:12-14)")
        if in_channels % groups or out_channels % groups:
            raise ValueError(
                f"groups={groups} must divide in_channels={in_channels} and "
                f"out_channels={out_channels}")
        self.in_channels = int(in_channels)
        self.out_channels = int(out_channels)
        self.kernel_size = int(kernel_size)
        self.stride = int(stride)
        self.padding = int(padding)
        self.groups = int(groups)
        self.fuse_relu = fuse_relu
        self.register_buffer("weight", self._buf(self._weight_shape()))
        self.register_buffer("bias", self._buf((out_channels,)))
        self.register_buffer("q_weight", None)

    def _weight_shape(self) -> tuple:
        k = self.kernel_size
        return (self.out_channels, self.in_channels // self.groups, k, k)

    def load_weight(self, w):
        self.weight = self._load_array(w, self._weight_shape(), "load_weight")

    def _kernel_weight(self, q_w: torch.Tensor) -> torch.Tensor:
        # OIHW -> [O, (kh, kw, I/groups)], the im2col patch order (a
        # grouped conv's taps over its group's channels)
        return q_w.permute(0, 2, 3, 1).reshape(self.out_channels, -1)

    def _order(self) -> str:
        # 'auto' (and its alias 'xla_conv') replays the native integer
        # conv's down_scale float order, in float32 or bfloat16; 'gemm' the
        # JAX package's im2col + qgemm path, which ignores epilogue_dtype
        # and which it never takes for a grouped conv
        if self.config.conv_backend == "gemm" and self.groups == 1:
            return "gemm"
        return ("conv_bf16" if self.config.epilogue_dtype == "bfloat16"
                else "conv")

    def _conv_backend(self) -> str:
        """The JAX package's name of this conv's backend: its 'auto' is
        its native integer conv, 'xla_conv' (B1's gathered conv here)."""
        impl = self.config.conv_backend
        return "xla_conv" if impl == "auto" else impl

    def ingest_descriptor(self):
        """Host-ingest pre-layout tag ``("s2d", k, s, p, C)`` for this conv,
        or None: where the JAX package would space-to-depth the conv
        (stride > 1, fewer than 32 input channels, ``groups == 1``, the
        integer-conv backend), the DataLoader may apply the zp-pad and the
        space-to-depth on the host instead (``data.DataLoader(layout_for=
        ...)``), and the card's forward starts at a stride-1 conv over
        ``s*s*C`` channels."""
        if (self.stride > 1 and self.in_channels < 32 and self.groups == 1
                and self._conv_backend() == "xla_conv"):
            return ("s2d", self.kernel_size, self.stride, self.padding,
                    self.in_channels)
        return None

    def forward(self, x: Tensor) -> Tensor:
        if x._ingest is not None:
            if not x.quantized:
                raise ValueError("pre-laid-out ingest tensors are u8")
            if x._ingest != self.ingest_descriptor():
                raise ValueError(
                    f"ingest pre-layout {x._ingest} does not match this "
                    f"conv's geometry {self.ingest_descriptor()} — "
                    "DataLoader layout_for must target the model's first "
                    "Conv2d")
            return self._forward_int8(x)
        if len(x.shape) != 4:
            raise ValueError(f"Conv2d expects a 4D input, got {x.shape}")
        if x.quantized:
            return self._forward_int8(x)
        return self._forward_fp32(x)

    def _float(self, x: torch.Tensor) -> torch.Tensor:
        """The FP32 conv + bias (float32 NCHW -> NCHW)."""
        return conv_ops.conv2d_fp32(x, self.weight, self.bias, self.stride,
                                    self.padding, self.groups)

    def _forward_fp32(self, x: Tensor) -> Tensor:
        self._check_fp32()
        if self.is_quantized and not self.quant_fallback:   # weight-only
            return Tensor(self._maybe_gather(
                self._forward_weight_only(x.logical_data), 1))
        _tap(self, x.logical_data)
        out = self._float(x.logical_data)
        # sampled in NHWC element order, the order the JAX package's
        # reservoir sees
        self._observe(out.permute(0, 2, 3, 1))
        if self.groups == 1:
            self._observe_in_mean(x.logical_data, (0, 2, 3))
        _record_cost(self, 2 * out.numel() * self._taps(),
                     4 * (x.data.numel() + out.numel()
                          + self.weight.numel()))
        return Tensor(self._maybe_gather(out, 1))

    def _taps(self) -> int:
        """Multiply-adds an output element takes."""
        return self.in_channels // self.groups * self.kernel_size ** 2

    def _forward_weight_only(self, x: torch.Tensor) -> torch.Tensor:
        """float32 NCHW -> NCHW: W8F, or DAC with one scale per image."""
        geo = (self.stride, self.padding, self.groups)
        if not self.config.dynamic_act:
            out = conv_ops.w8f_conv2d(x, self.q_weight, self.w_scale,
                                      self.bias, *geo)
        else:
            a, s_a = quantize_dynamic(x, (1, 2, 3))  # per-image [N,1,1,1]
            acc = conv_ops.conv2d_s8(a, self.q_weight, *geo)
            out = dequantize_dynamic(acc, s_a,
                                     self.w_scale.reshape(1, -1, 1, 1),
                                     self.bias.reshape(1, -1, 1, 1))
        _record_cost(self, 2 * out.numel() * self._taps(),
                     4 * (x.numel() + out.numel()) + self.q_weight.numel())
        return out

    def _hwio(self) -> torch.Tensor:
        """The s8 weight as HWIO [k, k, C/g, O] (a view of ``qw``)."""
        k = self.kernel_size
        return self.qw.reshape(self.out_channels, k, k, -1).permute(
            1, 2, 3, 0)

    def _s2d_qw(self) -> torch.Tensor:
        """The space-to-depth weight [O, (kp, kp, s*s*C)] of a pre-laid-out
        input (``ops/conv.s2d_weights``), built once for this ``qw``.  Its
        added taps are zero, so ``rowsum`` and the offset vector stay."""
        cached = getattr(self, "_s2d_cache", None)
        if cached is None or cached[0] is not self.qw:
            w = conv_ops.s2d_weights(self._hwio(), self.stride)
            cached = self._s2d_cache = (
                self.qw, w.permute(3, 0, 1, 2).reshape(
                    self.out_channels, -1).contiguous())
        return cached[1]

    def _forward_int8(self, x: Tensor) -> Tensor:
        self._check_int8(x)
        if self.quant_fallback:
            out = fp32_island(self, x)
            return Tensor(self._maybe_gather(out.data, 1), out.scale,
                          out.zero_point)
        order = self._order()
        oc, ep = self._epilogue(x, order)
        k = self.kernel_size
        common = dict(scale_a=x.scale, zp_a=x.zero_point, scale_c=self.scale,
                      zp_c=self.zero_point, relu=self.fuse_relu,
                      rounding=self.config.rounding)
        kw = dict(common, kh=k, kw=k, stride=self.stride,
                  padding=self.padding)
        if x._ingest is not None:
            # the pre-laid-out input: a stride-1 VALID conv over s*s*C
            # channels on the space-to-depth weight
            kp = -(-k // self.stride)
            out = conv_ops.conv2d_int8_gemm(
                x.data, self._s2d_qw(), oc, ep, kh=kp, kw=kp, stride=1,
                padding=0, order=order, gemm=self._gemm(), **common)
        elif self.groups > 1:
            grouped = (conv_ops.conv2d_int8_grouped_plain
                       if self.config.kernel_backend == "xla"
                       else conv_ops.conv2d_int8_grouped)
            out = grouped(x.as_nhwc_data(), self.qw, oc, ep,
                          groups=self.groups, order=order, **kw)
        else:
            out = conv_ops.conv2d_int8_gemm(x.as_nhwc_data(), self.qw, oc, ep,
                                            order=order, gemm=self._gemm(),
                                            **kw)
        _record_cost(self, 2 * out.numel() * self._taps(),
                     x.data.numel() + out.numel() + self.qw.numel())
        return Tensor(self._maybe_gather(out, 3), self.scale,
                      self.zero_point, _nhwc=True)


def weight_quant_spec(layer):
    """``(weight, scale, bound, group scales or None)``: the scale policy
    ``convert()`` applies to a ``Linear``/``Conv2d``'s weight, the one
    source of truth for the levers that choose its integer codes first
    (``utils.adaround``, ``utils.gptq``).  It mirrors
    ``Layer._quantize_weights`` and ``Linear._quantize_weights`` above:
    ``scale`` broadcasts over ``weight`` (its own layout, [N, K] or OIHW)
    and the codes are ``clip(q, -bound, bound)``; 4-bit Linears (W4A8 and
    W4 weight-only) repeat their ``pack_w4`` group scales over K."""
    w, cfg = layer.weight, layer.config
    if cfg.weight_bits == 4 and isinstance(layer, Linear):
        _, scales = w4_ops.pack_w4(w, cfg.w4_group,
                                   optimize=cfg.w4_mse_scales)
        k = w.shape[1]
        s_full = scales.repeat_interleave(min(cfg.w4_group, k), dim=1)[:, :k]
        return w, s_full, 7.0, scales
    if cfg.weight_per_channel:
        _, _, sc = quant_ops.quantize_weight_per_channel(w, layer.bias,
                                                         channel_axis=0)
        return w, sc.reshape((-1,) + (1,) * (w.dim() - 1)), 127.0, None
    _, _, sc = quant_ops.quantize_weight_joint_scale(w, layer.bias)
    return w, f32(sc, w.device), 127.0, None


def fp32_island(layer, x: Tensor) -> Tensor:
    """A skipped ``Linear``/``Conv2d``'s forward after convert
    (``Module.convert(skip=...)``): u8 codes in, dequantized at their grid,
    the layer's float32 product on its float weights (``F.linear`` /
    ``F.conv2d``, TF32 off), requantized at the layer's calibrated grid
    (relu at the zero point where fused).  The JAX package leaves this to
    XLA; it is stock PyTorch here, counted in ``.calls``."""
    fp32_island.calls += 1
    out = layer._float(dequantize_u8(x.logical_data, x.scale, x.zero_point))
    q = quantize_u8(out, layer.scale, layer.zero_point, layer.config.rounding)
    if layer.fuse_relu:
        q = q.clamp_min(layer.zero_point)
    return Tensor(q, layer.scale, layer.zero_point)


fp32_island.calls = 0


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
    ``ops/functional.ACTIVATIONS`` name or a callable.

    Two INT8 backends, bit-identical by construction: 'elementwise' maps
    every code through those ops; 'lut' runs the same ops once on the 256
    codes of the input's grid, on the input's device, and gathers the
    table with the codes.  The table is built at the first call on a grid
    and kept (``_luts``), since the input's grid is known only then."""

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
        if backend not in ("elementwise", "lut"):
            raise ValueError(f"backend must be 'elementwise' or 'lut', got "
                             f"{backend!r}")
        self.backend = backend
        self._luts: dict = {}

    def _map(self, codes: torch.Tensor, scale, zero_point) -> torch.Tensor:
        return self._requant(self.fn(dequantize_u8(
            codes, scale, zero_point, dtype=self._glue_dtype())))

    def _lut(self, x: Tensor) -> torch.Tensor:
        """The 256-entry u8 table of input grid (x.scale, x.zero_point)."""
        key = (x.scale, x.zero_point, x.device)
        lut = self._luts.get(key)
        if lut is None:
            codes = torch.arange(256, dtype=torch.uint8, device=x.device)
            lut = self._luts[key] = self._map(codes, x.scale, x.zero_point)
        return lut

    def forward(self, x: Tensor) -> Tensor:
        if not x.quantized:
            out = self.fn(x.data)
            self._observe(out)
            return Tensor(out, _nhwc=x._nhwc, _tp_sharded=x._tp_sharded)
        self._check_converted()
        if self.backend == "lut":
            out = self._lut(x)[x.data.to(torch.int64)]
        else:
            out = self._map(x.data, x.scale, x.zero_point)
        return Tensor(out, self.scale, self.zero_point, _nhwc=x._nhwc,
                      _tp_sharded=x._tp_sharded)


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
        if a._tp_sharded != b._tp_sharded:
            raise ValueError(
                "QuantAdd: operands must agree on channel sharding (one is "
                "a local channel shard, the other holds every channel)")
        b_data = self._aligned(a, b)
        if not a.quantized:
            out = a.data + b_data
            self._observe(out)
            return Tensor(out, _nhwc=a._nhwc, _tp_sharded=a._tp_sharded)
        self._check_converted()
        dt = self._glue_dtype()
        q = self._requant(dequantize_u8(a.data, a.scale, a.zero_point, dt)
                          + dequantize_u8(b_data, b.scale, b.zero_point, dt))
        if self.fuse_relu:
            q = q.clamp_min(self.zero_point)
        return Tensor(q, self.scale, self.zero_point, _nhwc=a._nhwc,
                      _tp_sharded=a._tp_sharded)


class QuantMul(_Weightless):
    """Calibrated elementwise multiply (SwiGLU's ``silu(gate) * up``, the
    squeeze-excite gate): both factors are dequantized at their own grids,
    multiplied in float32 with broadcasting (an SE gate [N, 1, 1, C] scales
    the trunk [N, H, W, C]; in NCHW [N, C, 1, 1] and [N, C, H, W]) and
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
        dt = self._glue_dtype()
        q = self._requant(dequantize_u8(a.data, a.scale, a.zero_point, dt)
                          * dequantize_u8(b_data, b.scale, b.zero_point, dt))
        return Tensor(q, self.scale, self.zero_point, _nhwc=a._nhwc,
                      _tp_sharded=a._tp_sharded)


class QuantConcat(_Weightless):
    """Calibrated channel concatenation (SqueezeNet's Fire, GoogLeNet's
    Inception, DenseNet's dense layers, ShuffleNetV2's branch merge).
    While preparing, the FP32 concatenation's range is observed; after
    convert, each input is requantized from its own (scale, zp) to this
    layer's grid (``quantize_u8(dequantize_u8(..))``) and the parts are
    concatenated on the channel axis of the physical layout, with an
    optional relu at the zero point."""

    def __init__(self, config: QuantConfig = DEFAULT_CONFIG,
                 fuse_relu: bool = False, device=None):
        super().__init__(config, device)
        self.fuse_relu = fuse_relu

    def forward(self, *xs: Tensor) -> Tensor:
        if len(xs) < 2:
            raise ValueError("QuantConcat needs at least two inputs")
        first = xs[0]
        if any(x.quantized != first.quantized for x in xs):
            raise ValueError(
                "QuantConcat: all inputs must be quantized or all float")
        axis = 3 if first._nhwc else 1        # the channels in either layout
        datas = [QuantAdd._aligned(first, x) for x in xs]
        if not first.quantized:
            out = torch.cat(datas, dim=axis)
            self._observe(out)
            return Tensor(out, _nhwc=first._nhwc)
        self._check_converted()
        dt = self._glue_dtype()
        out = torch.cat([self._requant(dequantize_u8(d, x.scale,
                                                     x.zero_point, dt))
                         for d, x in zip(datas, xs)], dim=axis)
        if self.fuse_relu:
            out = out.clamp_min(self.zero_point)
        return Tensor(out, self.scale, self.zero_point, _nhwc=first._nhwc)


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
        if a._tp_sharded != b._tp_sharded:
            raise ValueError(
                "QuantMatmul: operands must agree on head sharding (one "
                "is a local head shard, the other is replicated)")
        if not a.quantized:
            bd = b.data.transpose(-1, -2) if self.transpose_b else b.data
            out = f32(self.alpha, a.device) * torch.matmul(a.data, bd)
            self._observe(out)
            return Tensor(out, _tp_sharded=a._tp_sharded)
        self._check_converted()
        out = qmatmul_act(
            a.data, b.data, scale_a=a.scale, zp_a=a.zero_point,
            scale_b=b.scale, zp_b=b.zero_point, scale_c=self.scale,
            zp_c=self.zero_point, alpha=self.alpha,
            transpose_b=self.transpose_b, rounding=self.config.rounding)
        _record_cost(self, 2 * out.numel() * a.data.shape[-1],
                     a.data.numel() + b.data.numel() + out.numel())
        # batched per-(b, h) products are exact on a local head shard
        return Tensor(out, self.scale, self.zero_point,
                      _tp_sharded=a._tp_sharded)


def alibi_slopes(n_heads: int) -> tuple:
    """The ALiBi slope ladder (Press et al., ICLR'22) as the JAX package's
    ``alibi_slopes`` computes it: for H a power of two, head h (from 0) has
    ``m_h = 2^(-8(h+1)/H)`` (its ``QuantSoftmax`` docstring's 2^(-8h/H) is
    not what it computes); otherwise the ladder of the closest power of two
    below H, then the odd steps of the doubled ladder.  Python floats
    (float64), rounded to float32 where they are used."""
    import math

    def pow2_ladder(n):
        start = 2.0 ** (-8.0 / n)
        return [start ** (i + 1) for i in range(n)]

    if n_heads & (n_heads - 1) == 0:
        return tuple(pow2_ladder(n_heads))
    closest = 2 ** int(math.floor(math.log2(n_heads)))
    extra = pow2_ladder(2 * closest)[0::2][: n_heads - closest]
    return tuple(pow2_ladder(closest) + extra)


class QuantSoftmax(_Weightless):
    """Calibrated softmax over the last axis (attention probabilities).

    ``causal=True`` masks square scores above the diagonal; ``valid_len``
    (an int, a 0-dim tensor, [B, 1, 1, 1] per sequence or [..., tq, 1] per
    row) masks columns >= valid_len; ``window`` also drops columns more than
    ``window`` back; ``softcap`` maps scores through ``softcap*tanh(x /
    softcap)`` before the mask.  ``alibi_heads`` (the BLOOM family) adds
    each head's ALiBi bias ``m_h * (col - rowpos)`` after the softcap and
    before the mask, in float32 (``alibi``, the slopes as a float32 tensor
    on the layer's device): ``rowpos`` is the row index on square causal
    scores, ``valid_len - 1`` otherwise (a decode step, an extend's rows),
    and the scores carry the head axis at -3.  Masked positions quantize to
    exactly the zero point."""

    def __init__(self, config: QuantConfig = DEFAULT_CONFIG,
                 causal: bool = False, window: int | None = None,
                 softcap: float | None = None,
                 alibi_heads: int | None = None, device=None):
        super().__init__(config, device)
        self.causal = causal
        self.window = None if window is None else int(window)
        self.softcap = None if softcap is None else float(softcap)
        self.alibi = (None if alibi_heads is None else torch.tensor(
            alibi_slopes(int(alibi_heads)), dtype=torch.float32,
            device=self.device))

    def _masked(self, f: torch.Tensor, valid_len) -> torch.Tensor:
        if self.softcap is not None:
            f = attn_ops.softcap_(f, self.softcap)
        tq, tk = f.shape[-2], f.shape[-1]
        neg = f32(float("-inf"), f.device)
        if self.alibi is not None:
            col = torch.arange(tk, device=f.device, dtype=torch.int32)
            if self.causal and tq > 1 and tq == tk:
                rowp = torch.arange(tq, device=f.device,
                                    dtype=torch.int32).reshape(-1, 1)
            elif valid_len is not None:
                rowp = valid_len - 1
            else:
                rowp = tk - 1
            m = self.alibi.to(f.device).reshape(-1, 1, 1)
            f = f + m * (col - rowp).to(torch.float32)
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
            return Tensor(out, _tp_sharded=x._tp_sharded)
        self._check_converted()
        f = dequantize_u8(x.data, x.scale, x.zero_point)
        out = attn_ops.softmax_last(self._masked(f, valid_len))
        # softmax rows live within one head: exact on a local head shard
        return Tensor(self._requant(out), self.scale, self.zero_point,
                      _tp_sharded=x._tp_sharded)


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
            return Tensor(out, _tp_sharded=x._tp_sharded)
        self._check_converted()
        f = dequantize_u8(x.data, x.scale, x.zero_point)
        return Tensor(self._requant(self._rotate(f, start)), self.scale,
                      self.zero_point, _tp_sharded=x._tp_sharded)


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


class QuantMoE(Layer):
    """Mixture-of-experts SwiGLU MLP with top-k routing: one layer holding
    all E experts' stacked weights (the mixtral-family MLP; counterpart of
    the JAX package's ``QuantMoE``).

    Before convert it holds ``router`` [E, K], ``gate_w``/``up_w`` [E, H,
    K] and ``down_w`` [E, K, H], float32.  ``convert()`` quantizes each
    expert's weights to s8 (``q_gate_w``, ``q_up_w``, ``q_down_w``) with
    one symmetric scale an expert (``gate_w_s``, ``up_w_s``, ``down_w_s``
    [E]) or, under ``weight_per_channel``, one an expert row ([E, H] for
    gate and up, [E, K] for down); the router stays float32, since a
    quantized logit could flip a top-k choice.  Only the output grid is
    calibrated: the layer observes the combined float32 output while
    preparing and requantizes to it after convert, so it is u8 in and u8
    out like any layer.  The arithmetic is ``ops/moe.py``: the experts run
    the dynamic W8A8 products (per-token s8 activations), except in plain
    ``weight_only`` mode, whose float activations meet the s8 experts
    dequantized; ``weight_bits=4`` leaves the experts s8.

    ``dispatch``: 'dense' computes every expert over every token (the
    routing weights' zeros drop the unrouted ones), 'sparse' skips the
    experts no token routes to (one host sync for the mask), 'auto' takes
    sparse from 8 experts at 16 tokens or fewer (the JAX package's rule).
    Both give the same codes.  A step captured as a CUDA graph cannot sync
    with the host, so under capture the layer runs the dense form."""

    def __init__(self, dim: int, hidden: int, n_experts: int,
                 top_k: int = 2, config: QuantConfig = DEFAULT_CONFIG,
                 dispatch: str = "auto", device=None):
        super().__init__(config, device)
        if not 1 <= top_k <= n_experts:
            raise ValueError(f"top_k {top_k} not in [1, {n_experts}]")
        if dispatch not in ("auto", "dense", "sparse"):
            raise ValueError(f"dispatch {dispatch!r} not in "
                             "auto/dense/sparse")
        self.dim, self.hidden = int(dim), int(hidden)
        self.n_experts, self.top_k = int(n_experts), int(top_k)
        self.dispatch = dispatch
        e, h, k = self.n_experts, self.hidden, self.dim
        self.register_buffer("router", self._buf((e, k)))
        for name, shape in self._SHAPES.items():
            self.register_buffer(name, self._buf(shape(e, h, k)))
            self.register_buffer("q_" + name, None)
            self.register_buffer(name + "_s", None)

    _SHAPES = {"gate_w": lambda e, h, k: (e, h, k),
               "up_w": lambda e, h, k: (e, h, k),
               "down_w": lambda e, h, k: (e, k, h)}

    def load_router(self, w):
        self.router = self._load_array(w, (self.n_experts, self.dim),
                                       "load_router")

    def _load_expert(self, name, w):
        setattr(self, name, self._load_array(
            w, self._SHAPES[name](self.n_experts, self.hidden, self.dim),
            "load_" + name))

    def load_gate_w(self, w):
        self._load_expert("gate_w", w)

    def load_up_w(self, w):
        self._load_expert("up_w", w)

    def load_down_w(self, w):
        self._load_expert("down_w", w)

    def load_bias(self, b):
        raise ValueError("QuantMoE has no bias (it loads router, gate_w, "
                         "up_w and down_w)")

    def _quantize_weights(self):
        """The JAX package's order: ``s = max(max|w|, 1e-12) / 127`` per
        expert (or expert row), ``w / s`` rounded ('nearest': half to even)
        or truncated, clipped to +-127; one expert at a time."""
        dev = self.device
        for name in self._SHAPES:
            w = getattr(self, name)
            if self.config.weight_per_channel:
                s = torch.amax(torch.abs(w), dim=2)
            else:
                s = torch.amax(torch.abs(w), dim=(1, 2))
            s = torch.clamp_min(s, f32(1e-12, dev)) / f32(127.0, dev)
            q = torch.empty(w.shape, dtype=torch.int8, device=dev)
            for e in range(self.n_experts):
                t = w[e] / (s[e] if s.dim() == 1 else s[e][:, None])
                t = torch.round(t) if self.config.rounding == "nearest" \
                    else torch.trunc(t)
                q[e] = torch.clamp(t, -127.0, 127.0).to(torch.int8)
            self.set_experts(name, q, s)

    def set_experts(self, name: str, q: torch.Tensor, s: torch.Tensor):
        """Install one converted expert stack (``name`` of ``gate_w``,
        ``up_w``, ``down_w``): s8 ``q`` and its float32 scales; the FP32
        stack is freed."""
        shape = self._SHAPES[name](self.n_experts, self.hidden, self.dim)
        if tuple(q.shape) != shape or s.shape[0] != self.n_experts:
            raise ValueError(f"QuantMoE.{name}: codes {tuple(q.shape)} / "
                             f"scales {tuple(s.shape)} for {shape}")
        setattr(self, "q_" + name, q.to(device=self.device,
                                        dtype=torch.int8).contiguous())
        setattr(self, name + "_s", s.to(device=self.device,
                                        dtype=torch.float32).contiguous())
        setattr(self, name, None)

    def _use_sparse(self, m: int) -> bool:
        if self.dispatch != "auto":
            return self.dispatch == "sparse"
        return self.n_experts >= 8 and m <= 16

    def _moe(self, f: torch.Tensor) -> torch.Tensor:
        """Route and run the experts on float32 tokens [M, K].

        Under expert parallelism (``_tp_expert`` in a TP context) this
        rank holds its [E_local, ...] stacks: it runs them densely on the
        matching columns of the routing weights, and one sum over the model
        group combines the ranks' partial outputs.  Bit-exact for top_k <=
        2: each token has at most two nonzero terms, and a float sum of two
        numbers and zeros is the same in any order."""
        wexp = moe_ops.route(f, self.router, self.top_k)
        pa = self._active_axes() if self._tp_expert else None
        sparse = pa is None and self._use_sparse(f.shape[0]) and not (
            f.is_cuda and torch.cuda.is_current_stream_capturing())
        if pa is not None:
            e_local = self.n_experts
            wexp = wexp[:, pa.model_index * e_local:
                        (pa.model_index + 1) * e_local].contiguous()
        if self.q_gate_w is None:
            out = moe_ops.experts(f, wexp, self.gate_w, self.up_w,
                                  self.down_w, None, None, None,
                                  dynamic=False, sparse=sparse)
        else:
            dynamic = self.config.dynamic_act or not self.config.weight_only
            out = moe_ops.experts(f, wexp, self.q_gate_w, self.q_up_w,
                                  self.q_down_w, self.gate_w_s, self.up_w_s,
                                  self.down_w_s, dynamic=dynamic,
                                  sparse=sparse)
        ehk = 3 * self.n_experts * self.dim * self.hidden
        _record_cost(self, 2 * f.shape[0] * ehk,
                     4 * (f.numel() + out.numel()) + ehk)
        if pa is not None:
            from .parallel.sharding import all_reduce_sum
            out = all_reduce_sum(out, pa.model_group)
        return out

    def forward(self, x: Tensor) -> Tensor:
        if x.shape[-1] != self.dim or len(x.shape) != 2:
            raise ValueError(f"QuantMoE({self.dim}) expects tokens [M, "
                             f"{self.dim}], got {x.shape}")
        if not x.quantized:
            out = self._moe(x.data)
            self._observe(out)
            return Tensor(out)
        self._check_converted()
        out = self._moe(dequantize_u8(x.data, x.scale, x.zero_point))
        return Tensor(quantize_u8(out, self.scale, self.zero_point,
                                  self.config.rounding), self.scale,
                      self.zero_point)


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
            and not x._tp_sharded
            and all(l.is_quantized and not l.fuse_relu
                    and not l.quant_fallback for l in heads)
            # under TP the merge runs on the ranks' columns when all three
            # are sharded alike (their caches are then all local)
            and len({l._tp_sharded for l in heads}) == 1):
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
    for l, o in zip(heads, outs):
        _record_int8_linear(l, x, o, 1)
    return tuple(l._tp_result(o, l.scale, l.zero_point)
                 for l, o in zip(heads, outs))


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
            and not x._tp_sharded
            and all(l.is_quantized and not l.fuse_relu
                    and not l.quant_fallback and l.w4_packed is not None
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
    for l, o in zip(layers, outs):
        _record_int8_linear(l, x, o, 2)
    return tuple(Tensor(o, l.scale, l.zero_point)
                 for l, o in zip(layers, outs))


def fused_linear_act(linear: Linear, act: QuantAct, x: Tensor) -> Tensor:
    """A converted Linear -> QuantAct pair as one GEMM with the activation in
    the requant epilogue: the same codes as ``act(linear(x))`` (the
    intermediate u8 grid is replayed in registers), without the standalone
    pass over the Linear's output.  Pairs the kernel cannot fuse (a custom
    fn, the lut backend, 4-bit or weight-only layers, an FP32 island) run
    composed."""
    fusable = (linear.is_quantized and not linear.quant_fallback
               and act.is_quantized and x.quantized
               and linear.config.weight_bits == 8
               and not linear.config.weight_only
               and act.fn_name in KERNEL_ACTS
               and act.fn is ACTIVATIONS.get(act.fn_name)
               and act.backend == "elementwise"
               and act.config.glue_dtype == "float32"
               # ring-overlap TP consumes shards through ring_qgemm, which
               # has no act epilogue — compose there
               and not (linear._tp_sharded
                        and Layer._overlap_axes() is not None))
    if not fusable:
        return act(linear(x))
    out = linear._forward_int8(x, act=(act.fn_name, act.scale,
                                       act.zero_point))
    _record_cost(act, out.data.numel(), 2 * out.data.numel())
    return out


def fused_attention(attn: QuantMatmul, smax: QuantSoftmax, av: QuantMatmul,
                    qh: Tensor, kh: Tensor, vh: Tensor) -> Tensor:
    """A converted QK^T -> softmax -> P@V chain over head-split [B, H, T, D]
    tensors as one op: the same codes as ``av(smax(attn(qh, kh)), vh)`` at
    the same calibrated grids (``ops/attention.attention``, composed on any
    device; ``fused_attention='pallas'`` raises there, as in the JAX
    package).  Models gate on ``QuantConfig.fused_attention``."""
    if not (attn.is_quantized and smax.is_quantized and av.is_quantized):
        raise RuntimeError("fused_attention requires converted layers")
    if not attn.transpose_b or av.transpose_b or av.alpha != 1.0 \
            or smax.causal or smax.window is not None \
            or smax.softcap is not None or smax.alibi is not None:
        raise ValueError("fused_attention expects attn=QK^T (transpose_b), "
                         "a plain P@V, and non-causal softmax without a "
                         "window, softcap or ALiBi")
    backend = attn.config.fused_attention
    out = attn_ops.attention(
        qh.data, kh.data, vh.data,
        backend="auto" if backend in ("auto", "off") else backend,
        scale_q=qh.scale, zp_q=qh.zero_point,
        scale_k=kh.scale, zp_k=kh.zero_point,
        scale_v=vh.scale, zp_v=vh.zero_point,
        scale_s=attn.scale, zp_s=attn.zero_point,
        scale_p=smax.scale, zp_p=smax.zero_point,
        scale_c=av.scale, zp_c=av.zero_point,
        alpha=attn.alpha, rounding=attn.config.rounding)
    _record_attention(attn, av, qh.data, kh.data, vh.data, out,
                      qh.data.shape[-2])
    return Tensor(out, av.scale, av.zero_point, _tp_sharded=qh._tp_sharded)


def _record_attention(attn, av, q, k, v, out, t: int) -> None:
    """QK^T's and P@V's costs over ``t`` key rows."""
    _record_cost(attn, 2 * q.numel() * t, q.numel() + k.numel())
    _record_cost(av, 2 * out.numel() * t, v.numel() + out.numel())


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
        window=smax.window, softcap=smax.softcap, alibi=smax.alibi)
    _record_attention(attn, av, q2.data, kc.data, vc.data, out,
                      kc.data.shape[-2])
    # head-parallel TP: per-(b, h) attention is exact on a local head
    # shard; the flag lets the row-parallel out-projection consume it
    return Tensor(out, av.scale, av.zero_point, _tp_sharded=q2._tp_sharded)


def fused_extend_attention(attn: QuantMatmul, smax: QuantSoftmax,
                           av: QuantMatmul, q3: Tensor, kc: Tensor,
                           vc: Tensor, valid_base, head_dim: int) -> Tensor:
    """The multi-position twin of ``fused_decode_attention``: the m query
    rows ``q3`` [B, m, C] of positions pos..pos+m-1, whose k/v rows the
    caller has already written into the flat caches ``kc``/``vc`` [B, T,
    C_kv], with ``valid_base`` = pos + 1 (an int, a 0-dim or a [B]
    tensor): row j sees ``valid_base + j`` cache columns, the causal mask
    over the cache and this extend's own rows.  All B x m x H query rows
    go through one call of B3 on the card, tiled over query rows where
    they outgrow a block (``ops/attention.plan_decode_attn``);
    ``decode_attention='off'``/``'xla'`` runs the composed plain version.
    Returns [B, m, C] codes on ``av``'s grid."""
    if len(q3.shape) != 3:
        raise ValueError(f"fused_extend_attention expects q [B, m, C], got "
                         f"{tuple(q3.shape)}")
    return fused_decode_attention(attn, smax, av, q3, kc, vc, valid_base,
                                  head_dim)
