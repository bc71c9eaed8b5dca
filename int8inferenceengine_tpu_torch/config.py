"""Framework-wide configuration (counterpart of ``int8inferenceengine_tpu.config``).

The dataclass is copied whole so that a configuration written for the JAX
package means the same thing here.  This package implements a slice of it:
``check_supported`` names every field whose value the slice does not
implement yet and raises ``NotImplementedError`` for it, instead of
silently running something else.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Post-training static quantization configuration.

    Defaults reproduce the reference engine's hardcoded behavior:
    per-tensor asymmetric u8 activations, per-tensor symmetric s8 weights
    with a single joint weight+bias scale, truncating (round-toward-zero)
    float->int conversions, and requantization to each layer's calibrated
    output (scale, zero_point) at every layer boundary.
    """

    # Input quantization applied by Module.__call__ after convert().
    input_scale: float = 0.025
    input_zero_point: int = 127

    # Calibration: 'minmax' (reference semantics) or 'mse' (grid-searched
    # clip range over the reservoir samples).
    calib_method: str = "minmax"
    calib_quantile: float = 1.0
    calib_reservoir_size: int = 1000
    # True  -> exact streaming min/max over every observed activation.
    # False -> reference-style random reservoir (needed for quantile < 1).
    calib_exact_minmax: bool = True

    # Per-output-channel weight scales instead of one joint weight+bias
    # scale per layer.
    weight_per_channel: bool = False

    # Float->int conversion: 'trunc' (the reference's C cast) or 'nearest'.
    rounding: str = "trunc"

    # Fold the expected weight-quantization error E[(W - s_w*W_q) x] into
    # the bias before its s8 quantization (Linear, and Conv2d with
    # groups == 1), from the input means observed while preparing.
    bias_correction: bool = False

    # INT8 conv lowering: 'auto' runs the quantized GEMM kernel with the
    # reference's conv epilogue order (bit-identical to the JAX package's
    # native integer conv): on the card as the gathered conv, which reads
    # each patch from the NHWC input; on the CPU through im2col.  'gemm'
    # uses the GEMM epilogue order (the JAX package's conv2d_int8_gemm);
    # 'xla_conv' has no counterpart here.
    conv_backend: str = "auto"

    # Quantized GEMM backend.  'auto' and 'pallas': the hand-written kernel
    # on a CUDA tensor (the plain version on a CPU tensor); 'xla': the plain
    # PyTorch version on any device, the counterpart of the JAX package's
    # plain lax.dot_general path.
    kernel_backend: str = "auto"

    # Weight-only and 4-bit weight modes.
    weight_only: bool = False
    weight_bits: int = 8
    w4_group: int = 128
    w4_mse_scales: bool = True
    w4_kernel: str = "auto"

    # Per-token dynamic activation quantization: under weight_only, each
    # row of a Linear's input (each image of a Conv2d's) quantizes to s8
    # at its own symmetric scale, the product accumulates exactly in s32
    # and dequantizes per row.  Without weight_only it changes nothing (the
    # static INT8 path runs), as in the JAX package; with weight_bits=4,
    # convert() raises ValueError.
    dynamic_act: bool = False

    # Transformer-layer fusions (layers.fused_*).
    # Fold a Linear's following QuantAct into the GEMM's requant epilogue.
    fuse_linear_act: bool = True
    # Q/K/V projections as one GEMM with a per-column zero point: 'auto' /
    # 'pallas' launch kernel B2 on a CUDA tensor, 'xla' runs the merged
    # GEMM's plain version, 'off' the three Linears.
    fuse_qkv: str = "auto"
    # The encoders' (ViT, text transformer) converted QK^T -> softmax ->
    # P@V chain: 'auto' / 'xla' run it through ``layers.fused_attention``
    # (the composed path, ``ops/attention.attention``), 'off' through the
    # three layers; 'pallas' raises at the call, as in the JAX package,
    # whose prefill kernel was removed.  The decoders' prefill attention is
    # composed either way.
    fused_attention: str = "auto"
    # Cached-decode attention: 'auto' / 'pallas' launch kernel B3 on a CUDA
    # tensor, 'xla' / 'off' run the composed plain version.
    decode_attention: str = "auto"

    # Computation dtypes of the FP32 path, the conv epilogue and the glue.
    fp_dtype: str = "float32"
    epilogue_dtype: str = "float32"
    glue_dtype: str = "float32"


DEFAULT_CONFIG = QuantConfig()

# field -> the only value this package implements so far
_IMPLEMENTED = {
    "glue_dtype": "float32",
    "epilogue_dtype": "float32",
    "fp_dtype": "float32",
}

# field -> the values this package accepts
_CHOICES = {
    "kernel_backend": ("auto", "pallas", "xla"),
    "fuse_qkv": ("auto", "pallas", "xla", "off"),
    "decode_attention": ("auto", "pallas", "xla", "off"),
    # 'pallas' is accepted here and refused where it runs, as in JAX
    "fused_attention": ("auto", "pallas", "xla", "off"),
    # 'auto' / 'pallas': kernels B6 (W4A8 v2 envelope), B7 (other W4A8
    # shapes) and B5 (weight-only) on a CUDA tensor; 'xla': the plain
    # versions of B7's and B5's functions on any device
    "w4_kernel": ("auto", "pallas", "xla"),
}


def check_supported(config: QuantConfig) -> None:
    """Raise ``NotImplementedError`` naming the first field set to a value
    this package does not implement."""
    for field, value in _IMPLEMENTED.items():
        got = getattr(config, field)
        if got != value:
            raise NotImplementedError(
                f"QuantConfig.{field}={got!r} is not implemented by the "
                f"PyTorch port yet (only {value!r})")
    if config.weight_bits not in (8, 4):
        raise NotImplementedError(
            f"QuantConfig.weight_bits={config.weight_bits!r} is not "
            f"implemented by the PyTorch port (8 or 4)")
    if config.conv_backend == "xla_conv":
        raise NotImplementedError(
            "QuantConfig.conv_backend='xla_conv' is not implemented by the "
            "PyTorch port ('auto' gives the same codes: the gathered conv "
            "on the card, im2col on the CPU)")
    if config.conv_backend not in ("auto", "gemm"):
        raise ValueError(f"unknown conv_backend {config.conv_backend!r}")
    if config.rounding not in ("trunc", "nearest"):
        raise ValueError(f"unknown rounding {config.rounding!r}")
    for field, allowed in _CHOICES.items():
        if getattr(config, field) not in allowed:
            raise ValueError(f"QuantConfig.{field}={getattr(config, field)!r}"
                             f" is not one of {allowed}")
