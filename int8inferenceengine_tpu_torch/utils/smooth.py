"""SmoothQuant-style activation smoothing (Xiao et al., ICML 2023;
counterpart of ``int8inferenceengine_tpu.utils.smooth``).

Per-tensor activation quantization of transformers is limited by a few
outlier CHANNELS after the norm: one hot channel inflates the whole
tensor's scale.  For each norm -> Linear(s) boundary smoothing picks a
per-channel factor

    s_j = amax_j(|X|)^alpha / max_j(|W|)^(1-alpha)        (alpha ~ 0.5)

and rewrites ``X W^T = (X / s) (W * s)^T``: ``1/s`` folds into the norm's
gain and bias (float32 in this engine: the fold is exact) and ``s`` into
each consumer Linear's columns.  The FP32 function is unchanged; the INT8
grid after the norm now covers a balanced range.

``s`` is computed in float64 and rounded once to float32, so the card and
the CPU give the same bits (float32 ``pow`` need not agree across
libraries); against the JAX package, which takes it in float32, ``s`` may
differ by an ULP.

Data-driven: the per-channel activation maxima come from one tapped FP32
forward over a calibration batch (``layers._INPUT_TAP``).  Run it BEFORE
``prepare()``:

    net.load(...)
    smooth(net, transformer_smooth_pairs(net), x_calib)
    net.prepare(); net(tensor(x_calib)); net.convert()
"""

from __future__ import annotations

import torch

from ..layers import Linear, QuantLayerNorm, QuantRMSNorm
from .tap import tapped_forward

__all__ = ["smooth", "transformer_smooth_pairs"]


def transformer_smooth_pairs(net) -> list:
    """The norm -> Linear boundaries of this package's transformer models.

    ViT / TextTransformer / TextDecoder share the gpt block naming (ln2 ->
    fc1); the llama family's ln2 feeds the SwiGLU pair (gate + up, one
    factor since both read the same norm output), detected by attribute
    presence.  The MoE decoder's ln2 feeds the router and every expert:
    smoothing there would rescale the router's logit geometry (its top-k is
    scale-sensitive per channel), so that boundary stays unsmoothed."""
    pairs = []
    llama = hasattr(net, "gate1")
    moe = hasattr(net, "moe1")
    for i in range(1, net.depth + 1):
        pairs.append((f"ln1_{i}", [f"wq{i}", f"wk{i}", f"wv{i}"]))
        if llama:
            pairs.append((f"ln2_{i}", [f"gate{i}", f"up{i}"]))
        elif not moe:
            pairs.append((f"ln2_{i}", [f"fc1_{i}"]))
    pairs.append(("ln_f", ["head"]))
    return pairs


def smoothing_factor(amax: torch.Tensor, wmax: torch.Tensor,
                     alpha: float) -> torch.Tensor:
    """``clip(amax^alpha / wmax^(1-alpha), 1e-5, 1e5)``: the power and the
    quotient in float64, rounded once to float32, then clipped there."""
    s = (amax.to(torch.float64) ** alpha
         / wmax.to(torch.float64) ** (1.0 - alpha)).to(torch.float32)
    return torch.clamp(s, 1e-5, 1e5)


def smooth(net, pairs, x_calib, *, alpha: float = 0.5,
           verbose: bool = False):
    """Apply activation smoothing at each (norm_name, [linear_names]) pair.

    Must run before ``prepare()`` (calibration sees smoothed activations).
    Every listed Linear must read the norm's output directly, and that
    output must feed nothing else that is not linear in scale (true for
    the attention and MLP stems here: the residual branch reads ``x``, not
    ``norm(x)``)."""
    if net.is_quant:
        raise RuntimeError("smooth must run before convert()")
    if getattr(net, "is_preparing", None) or any(
            l.is_preparing for _, l in net.named_layers()):
        raise RuntimeError("smooth must run before prepare() — the "
                           "calibrator must observe smoothed ranges")
    layers = dict(net.named_layers())
    tap = tapped_forward(net, x_calib)

    for ln_name, lin_names in pairs:
        ln = layers[ln_name]
        lins = [layers[n] for n in lin_names]
        if not isinstance(ln, (QuantLayerNorm, QuantRMSNorm)) or not all(
                isinstance(l, Linear) for l in lins):
            raise TypeError(f"smooth pair ({ln_name}, {lin_names}) must be "
                            "a QuantLayerNorm/QuantRMSNorm feeding Linears")
        xs = tap.get(id(lins[0]))
        if not xs:
            raise ValueError(
                f"{lin_names[0]} saw no input in the tapped forward — is "
                "the pair actually on the forward path?")
        x = torch.cat([v.reshape(-1, v.shape[-1]) for v in xs], 0)
        amax = torch.clamp_min(torch.amax(torch.abs(x), dim=0), 1e-5)
        wmax = torch.clamp_min(torch.amax(torch.stack(
            [torch.amax(torch.abs(l.weight), dim=0) for l in lins]), dim=0),
            1e-5)
        s = smoothing_factor(amax, wmax, alpha)
        if getattr(ln, "unit_offset", False):
            # gemma's norms compute norm(x) * (1 + w): the stored weight is
            # a delta around one, so the exact fold is (1 + w') = (1 + w)/s,
            # not w/s (which would rescale the implicit unit gain)
            ln.weight = (1.0 + ln.weight) / s - 1.0
        else:
            ln.weight = ln.weight / s
        if getattr(ln, "bias", None) is not None:     # RMSNorm is bias-free
            ln.bias = ln.bias / s
        for l in lins:
            l.weight = l.weight * s.reshape(1, -1)
        if verbose:
            print(f"smooth {ln_name}: act amax {float(amax.max()):.3g} -> "
                  f"{float((amax / s).max()):.3g} (s in "
                  f"[{float(s.min()):.3g}, {float(s.max()):.3g}])")
    return net
