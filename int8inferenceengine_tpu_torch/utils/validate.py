"""Model validation guards (counterpart of
``int8inferenceengine_tpu.utils.validate``): static invariant checks over
the quantized artifact plus a finite-output probe.  ``validate`` returns
a list of findings (empty = clean) instead of raising, so serving can gate
a model load on it; the findings read as the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..tensor import Tensor, tensor


def validate(model, sample_input=None) -> list[str]:
    """Check the quantization invariants and, with ``sample_input``, run
    the model and check that its output is finite and not constant.

    Per layer: s8 weight codes within [-127, 127], positive finite weight
    scales, zero points in u8 range, a positive finite output scale, and
    no layer left preparing."""
    findings: list[str] = []
    for name, layer in model.named_layers():
        if layer.is_quantized:
            qw = getattr(layer, "qw", None)
            if qw is not None:
                if qw.dtype != torch.int8:
                    findings.append(
                        f"{name}: quantized weight dtype "
                        f"{str(qw.dtype).removeprefix('torch.')}, "
                        f"expected int8")
                if qw.numel() and int(qw.to(torch.int32).abs().max()) > 127:
                    findings.append(f"{name}: weight code outside [-127,127]")
            scales = torch.as_tensor(layer.weight_scale).reshape(-1)
            if not bool((scales > 0).all()) \
                    or not bool(torch.isfinite(scales).all()):
                findings.append(f"{name}: non-positive/non-finite weight "
                                f"scale")
            if not (0 <= layer.zero_point <= 255):
                findings.append(f"{name}: zero_point {layer.zero_point} "
                                f"outside u8 range")
            if layer.scale <= 0 or not np.isfinite(layer.scale):
                findings.append(f"{name}: bad output scale {layer.scale}")
        if layer.is_preparing:
            findings.append(f"{name}: still preparing (convert() not called)")

    if sample_input is not None:
        t = sample_input if isinstance(sample_input, Tensor) else tensor(
            sample_input, device=model.device)
        out = np.asarray(model(t).numpy())
        if not np.isfinite(out).all():
            findings.append("forward probe: non-finite values in output")
        elif out.std() == 0:
            findings.append("forward probe: constant output (degenerate)")
    return findings
