"""Module: the model container that runs the PTQ lifecycle
(counterpart of ``int8inferenceengine_tpu.module``).

Users subclass, declare layers in ``__init__``, and write ``forward``:

    class MyNet(Module):
        def __init__(self, device=None):
            super().__init__(device=device)
            self.fc1 = Linear(784, 10, device=self.device)
        def forward(self, x):
            return self.fc1(x)

Lifecycle (identical to the reference): ``load(state_dict)`` ->
``prepare()`` -> run FP32 batches to calibrate -> ``convert()`` -> quantized
inference.  After convert, ``__call__`` quantizes the input at the configured
(scale, zero_point) — default (0.025, 127), the reference's hardcoded values —
unless the model consumes token ids, runs ``forward`` and dequantizes the
output.  A weight-only model (``QuantConfig.weight_only``) keeps float
activations: its input and output pass through as they are.

Everything runs eagerly.  While preparing, each layer folds its output's
min/max into on-device running scalars; ``convert()`` reads them on the host
once.
"""

from __future__ import annotations

import warnings

import torch
from torch import nn

from .config import DEFAULT_CONFIG, QuantConfig, check_supported
from .layers import Conv2d, Layer, Linear
from .ops import functional as F
from .tensor import Tensor, resolve_device, tensor


class TruncDepthWarning(UserWarning):
    """Advisory: deep model converted under 'trunc' rounding with no
    accuracy lever engaged (see Module._warn_trunc_depth)."""


class Module(nn.Module):
    # Deepest reference-parity model is AlexNet (8 boundaries); the
    # JAX package measured the truncation-bias footgun well past that.
    TRUNC_DEPTH_ADVISORY = 32

    def __init__(self, config: QuantConfig = DEFAULT_CONFIG, device=None):
        super().__init__()
        check_supported(config)
        self.config = config
        self.device = resolve_device(device)
        self.is_quant = False

    # -- layer discovery -----------------------------------------------------
    def named_layers(self, prefix: str = ""):
        """Yield (dotted_name, layer) for every Layer, recursively, in
        declaration order."""
        for name, child in self._modules.items():
            if isinstance(child, Layer):
                yield prefix + name, child
            elif isinstance(child, Module):
                yield from child.named_layers(prefix + name + ".")

    # -- reference lifecycle API ----------------------------------------------
    def load(self, state_dict):
        """Ingest a torch-style flat state_dict ('name.weight'/'name.bias',
        or any 'name.<param>' with a ``load_<param>`` setter, as
        ``QuantMoE``'s router and expert stacks); dotted paths reach into
        sub-Modules.  An HF-exported state dict of a decoder family
        (``model.layers.0.self_attn.q_proj.weight``, gpt2's transposed
        Conv1D and fused ``c_attn``, tied embeddings, ...) is translated
        first (``utils/hf.py``)."""
        from .utils.hf import maybe_from_hf
        state_dict = maybe_from_hf(state_dict, self)
        for key, value in state_dict.items():
            path, attr = key.rsplit(".", 1)
            obj = self
            for part in path.split("."):
                obj = getattr(obj, part)
            if isinstance(obj, Layer) and hasattr(obj, "load_" + attr):
                getattr(obj, "load_" + attr)(value)
            else:
                raise KeyError(f"unrecognized state_dict key: {key}")

    def prepare(self):
        for _, layer in self.named_layers():
            layer.prepare()

    def convert(self, skip=()):
        """PTQ-convert every layer.  ``skip``: names of ``Linear``/``Conv2d``
        layers to keep as FP32 fallback islands: they stay u8 in and u8 out
        (dequantize, float32 product on their float weights, requantize at
        their calibrated range, ``layers.fp32_island``), so the rest of the
        graph is unchanged.  An unknown name raises ``KeyError``, a layer of
        another type ``TypeError``, as in the JAX package."""
        from .layers import Conv2d, Linear
        by_name = dict(self.named_layers())
        unknown = set(skip) - set(by_name)
        if unknown:
            raise KeyError(f"convert(skip=...): unknown layers {unknown}")
        unsupported = sorted(n for n in skip
                             if not isinstance(by_name[n], (Linear, Conv2d)))
        if unsupported:
            raise TypeError(
                f"convert(skip=...): FP32 fallback islands are implemented "
                f"for Linear/Conv2d only; {unsupported} are "
                f"{[type(by_name[n]).__name__ for n in unsupported]}")
        self._warn_trunc_depth(by_name, skip)
        for name, layer in by_name.items():
            if name in skip:
                layer.quant_fallback = True
            layer.convert()
        self.is_quant = True

    def _warn_trunc_depth(self, by_name, skip=()):
        """Advisory for the deep-model 'trunc' footgun: every requant
        boundary under round-toward-zero carries a -s/2 bias that compounds
        over many serial boundaries.  Suppressed by any engaged lever or a
        mixed-precision skip set."""
        cfg = self.config
        if cfg.rounding != "trunc" or skip:
            return
        if (cfg.bias_correction or cfg.weight_per_channel
                or cfg.calib_method == "mse" or cfg.weight_only):
            return
        n = len(by_name)
        if n > self.TRUNC_DEPTH_ADVISORY:
            warnings.warn(
                f"converting {n} quantized layer boundaries with "
                f"rounding='trunc' (the reference-parity default): the "
                f"per-boundary -scale/2 truncation bias compounds with "
                f"depth.  For deep models not bound to reference "
                f"bit-parity, pass QuantConfig(rounding='nearest') or "
                f"engage another accuracy lever (bias_correction, "
                f"weight_per_channel, calib_method='mse').",
                TruncDepthWarning, stacklevel=3)

    def ingest_descriptor(self):
        """Host-ingest pre-layout tag for this model's input, or None: the
        first declared Conv2d's (``layers.Conv2d.ingest_descriptor``), None
        where a Linear comes first.  ``data.DataLoader(layout_for=model)``
        and ``serve.InferenceEngine(quantize_ingest=True)`` pre-lay-out
        quantized batches on the host with it; ``__call__`` hands such a
        batch, at its own (scale, zp), to the first conv."""
        for _, layer in self.named_layers():
            if isinstance(layer, Conv2d):
                return layer.ingest_descriptor()
            if isinstance(layer, Linear):
                return None
        return None

    # -- execution -------------------------------------------------------------
    def forward(self, x: Tensor) -> Tensor:  # overridden by the user
        raise NotImplementedError

    def _preparing(self) -> bool:
        return any(l.is_preparing for _, l in self.named_layers())

    def _consumes_ids(self) -> bool:
        """True when the model's stem takes raw token ids (QuantEmbed):
        its input is never quantized."""
        return any(getattr(layer, "consumes_ids", False)
                   for _, layer in self.named_layers())

    def __call__(self, x) -> Tensor:
        t = x if isinstance(x, Tensor) else tensor(x, device=self.device)
        if t.device.type != self.device.type:
            raise ValueError(f"input is on {t.device}, model on {self.device}")
        if t.quantized and self._preparing():
            raise ValueError(
                "calibration observes FP32 activation ranges — feed "
                "float input while preparing, not a quantized tensor")
        with torch.no_grad():
            if self.config.weight_only:
                # weight-only: activations stay float end to end, no input
                # quantization and nothing to dequantize at the output
                out = self.forward(t)
                return Tensor(out.logical_data, out.scale, out.zero_point)
            if self.is_quant and not t.quantized \
                    and not self._consumes_ids():
                # Reference behavior: quantize at the configured input
                # (scale, zp).  Already-quantized input runs at its own;
                # token ids pass through untouched.
                t = F.quantize(t, self.config.input_scale,
                               self.config.input_zero_point,
                               self.config.rounding)
            out = self.forward(t)
            if self.is_quant:
                out = F.dequantize(out)
        return Tensor(out.logical_data, out.scale, out.zero_point)
