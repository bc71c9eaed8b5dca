"""Roofline accounting: per-layer operations and bytes and the share of
the card's peak for a model (counterpart of
``int8inferenceengine_tpu.utils.roofline``).

Layers append (layer, flops, bytes) records to ``layers._COST_SINK`` as
the forward runs, with the JAX package's counts: 2·M·K·N for a GEMM, each
input and output read or written once, the weights at their stored width.
This module runs the forward, sums the records per layer and, given a
measured time per batch, adds the achieved rate and the share of the
card's published dense peaks.
"""

from __future__ import annotations

import torch

from ..layers import _COST_SINK

# NVIDIA's published dense peaks, matched on a fragment of
# ``torch.cuda.get_device_name()``: (int8 ops/s, bf16 flop/s, HBM bytes/s)
CHIP_PEAKS = {
    "h100 80gb hbm3": (1979e12, 989e12, 3.35e12),   # H100 SXM
    "h100 pcie": (1513e12, 756e12, 2.0e12),
}
DEFAULT_PEAK = CHIP_PEAKS["h100 80gb hbm3"]


def _peaks() -> tuple:
    if not torch.cuda.is_available():
        return DEFAULT_PEAK
    name = torch.cuda.get_device_name().lower()
    for frag, peaks in CHIP_PEAKS.items():
        if frag in name:
            return peaks
    return DEFAULT_PEAK


def collect(model, input_shape, batch: int) -> dict:
    """Run one forward at ``(batch,) + input_shape`` (zeros, on the model's
    device) and collect per-layer (flops, bytes).  Works for FP32 and
    converted models.  Unlike the JAX package's, which only traces, it
    does the forward's device work; a model still preparing would observe
    the zeros, so call it before ``prepare()`` or after ``convert()``."""
    name_of = {id(layer): name for name, layer in model.named_layers()}
    x = torch.zeros((batch,) + tuple(input_shape), dtype=torch.float32,
                    device=model.device)
    sink: list = []
    token = _COST_SINK.set(sink)
    try:
        model(x)
    finally:
        _COST_SINK.reset(token)
    per_layer = {}
    for layer, flops, nbytes in sink:
        name = name_of.get(id(layer), repr(layer))
        rec = per_layer.setdefault(name, {"flops": 0, "bytes": 0})
        rec["flops"] += flops
        rec["bytes"] += nbytes
    return {
        "batch": batch,
        "total_flops": sum(r["flops"] for r in per_layer.values()),
        "total_bytes": sum(r["bytes"] for r in per_layer.values()),
        "per_layer": per_layer,
    }


def report(model, input_shape, batch: int, measured_s: float | None = None,
           quantized: bool | None = None) -> dict:
    """Roofline report; with ``measured_s`` (seconds per batch) adds the
    achieved rate and the share of the peak of the matching precision: the
    int8 peak for a converted model, the bf16 one otherwise, as in the JAX
    package (the port's FP32 forward runs in float32 with TF32 off, well
    under that peak)."""
    rep = collect(model, input_shape, batch)
    int8_peak, bf16_peak, hbm = _peaks()
    quantized = model.is_quant if quantized is None else quantized
    peak = int8_peak if quantized else bf16_peak
    rep["precision"] = "int8" if quantized else "f32/bf16"
    rep["peak_ops"] = peak
    rep["peak_hbm_Bps"] = hbm
    rep["sol_compute_s"] = rep["total_flops"] / peak
    rep["sol_memory_s"] = rep["total_bytes"] / hbm
    if measured_s is not None:
        rep["measured_s"] = measured_s
        rep["achieved_ops"] = rep["total_flops"] / measured_s
        rep["percent_of_peak"] = 100.0 * rep["achieved_ops"] / peak
        rep["percent_of_sol"] = 100.0 * max(
            rep["sol_compute_s"], rep["sol_memory_s"]) / measured_s
    return rep
