"""Observability: the per-layer quantization report and a profiler hook
(counterpart of ``int8inferenceengine_tpu.utils.observe``).

Every converted layer exposes its calibrated output range (``calib_stats``,
kept at ``convert()``), its derived (scale, zero_point) and its weight
scale as structured records, emittable as JSON lines.  ``trace`` wraps
``torch.profiler`` (CUDA activity on the card) so serving and benchmarks
capture a device trace with one context manager, and ``device_op_times``
sums the newest trace's kernels.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import sys
import time

import torch


def quantization_report(model) -> dict:
    """Per-layer quantization summary of a (converted or not) model.

    {layer: {type, is_quantized, scale, zero_point, weight_scale,
             calib: {count, min, max}}}
    """
    report = {}
    for name, layer in model.named_layers():
        ws = layer.weight_scale
        report[name] = {
            "type": type(layer).__name__,
            "is_quantized": layer.is_quantized,
            "scale": layer.scale,
            "zero_point": layer.zero_point,
            "weight_scale": (ws if isinstance(ws, float)
                             else [float(s) for s in ws.cpu().tolist()]),
            "calib": layer.calib_stats,
        }
    return report


def log_quantization_report(model, stream=None) -> None:
    """Emit the report as JSON lines (one per layer)."""
    stream = stream if stream is not None else sys.stderr
    for name, rec in quantization_report(model).items():
        stream.write(json.dumps({"layer": name, **rec}) + "\n")
    stream.flush()


def device_op_times(log_dir: str) -> dict:
    """Sum the device kernels of the newest ``trace(log_dir=...)`` file.

    Returns {kernel_name: {"ms": total_ms, "count": n}} for the trace's
    kernel events, largest first (empty for a trace taken without a card).
    Raises ``FileNotFoundError`` when ``log_dir`` holds no trace.
    """
    paths = sorted(glob.glob(os.path.join(log_dir, "*.trace.json.gz")))
    if not paths:
        raise FileNotFoundError(f"no trace.json.gz under {log_dir}")
    with gzip.open(paths[-1]) as f:
        events = json.load(f).get("traceEvents", [])
    out: dict = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "kernel" or "dur" not in e:
            continue
        rec = out.setdefault(e["name"], {"ms": 0.0, "count": 0})
        rec["ms"] += e["dur"] / 1e3
        rec["count"] += 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["ms"]))


@contextlib.contextmanager
def trace(name: str = "i8ie", log_dir: str | None = None):
    """Profile a region: a ``torch.profiler`` session (CPU, and CUDA where
    there is a card) that writes ``<log_dir>/<name>.<ns>.trace.json.gz``
    when ``log_dir`` is given, plus a ``record_function(name)`` range
    either way."""
    if not log_dir:
        with torch.profiler.record_function(name):
            yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(name):
            yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{name}.{time.time_ns()}.trace.json.gz"))
