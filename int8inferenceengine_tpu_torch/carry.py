"""Carry a model's state between the JAX package's layout and this port's.

A state maps each layer name (``Module.named_layers()``) to

    {"params": {name: np.ndarray}, "scale": float, "zero_point": int,
     "weight_scale": float or np.ndarray, "is_quantized": bool}

with ``params`` in the JAX package's layouts:

* Linear: before convert ``weight`` / ``bias`` ([out, in]); after it
  ``qw_kn`` ([K, N] s8), ``q_bias``, ``rowsum`` and, per channel,
  ``w_scale``; with 4-bit weights ``w4_packed`` ([N, K/2] u8), ``w4_scales``
  ([N, G] f32), ``bias`` and, on the static path (W4A8), ``w4_wsum`` ([N]
  f32), carried as they are (``wsum`` is an f32 sum whose order is part of
  the result, so it is never recomputed);
* Conv2d: ``w_hwio`` / ``bias`` (HWIO), after convert ``qw_hwio`` (HWIO s8)
  with ``q_bias``, ``rowsum`` and, per channel, ``w_scale``;
* QuantEmbed: ``weight`` ([V, C] float32), after convert ``q_weight``
  ([V, C] u8) (a weight-only model keeps ``weight``);
* QuantPosEmbed: ``weight`` (and the class token ``bias`` when it has one);
* QuantLayerNorm: ``weight`` and ``bias``; QuantRMSNorm: ``weight``;
* the weightless layers (QuantAct, QuantAdd, QuantMul, QuantMatmul,
  QuantSoftmax, QuantRoPE): none, only ``scale`` and ``zero_point``.

It is what a JAX ``Layer`` holds in ``layer.params`` and its attributes, so
after ``load_jax_state`` both packages compute the same function.
"""

from __future__ import annotations

import numpy as np
import torch

from .layers import (Conv2d, Layer, Linear, QuantEmbed, QuantLayerNorm,
                     QuantPosEmbed, QuantRMSNorm)

_TABLES = (QuantEmbed, QuantPosEmbed, QuantLayerNorm, QuantRMSNorm)


def _t(arr, dtype) -> torch.Tensor:
    return torch.tensor(np.asarray(arr, dtype=dtype))


def _expect(layer_name: str, what: str, arr, shape):
    if tuple(np.shape(arr)) != tuple(shape):
        raise ValueError(f"{layer_name}.{what}: shape {np.shape(arr)} != "
                         f"expected {tuple(shape)}")


def _load_w4_layer(name: str, layer: Linear, p: dict) -> None:
    n, c = layer.out_channels, layer.in_channels
    _expect(name, "w4_packed", p["w4_packed"], (n, c // 2))
    _expect(name, "bias", p["bias"], (n,))
    if np.shape(p["w4_scales"])[0] != n:
        raise ValueError(f"{name}.w4_scales: shape "
                         f"{np.shape(p['w4_scales'])} has not {n} rows")
    wsum = None
    if "w4_wsum" in p:
        _expect(name, "w4_wsum", p["w4_wsum"], (n,))
        wsum = _t(p["w4_wsum"], np.float32)
    elif not layer.config.weight_only:
        raise ValueError(f"{name}: a W4A8 layer needs w4_wsum")
    layer.set_w4(_t(p["w4_packed"], np.uint8), _t(p["w4_scales"], np.float32),
                 _t(p["bias"], np.float32), wsum)


def _load_gemm_layer(name: str, layer: Layer, st: dict) -> None:
    p = st["params"]
    k = getattr(layer, "kernel_size", None)
    n, c = layer.out_channels, layer.in_channels
    if st["is_quantized"] and "w4_packed" in p:
        return _load_w4_layer(name, layer, p)
    if not st["is_quantized"]:
        if isinstance(layer, Conv2d):
            _expect(name, "w_hwio", p["w_hwio"], (k, k, c, n))
            layer.load_weight(np.transpose(p["w_hwio"], (3, 2, 0, 1)))
        else:
            layer.load_weight(p["weight"])
        layer.load_bias(p["bias"])
        return
    if isinstance(layer, Conv2d):
        _expect(name, "qw_hwio", p["qw_hwio"], (k, k, c, n))
        qw = np.asarray(p["qw_hwio"]).reshape(k * k * c, n).T
    else:
        _expect(name, "qw_kn", p["qw_kn"], (c, n))
        qw = np.asarray(p["qw_kn"]).T
    _expect(name, "q_bias", p["q_bias"], (n,))
    s_w = (_t(p["w_scale"], np.float32) if "w_scale" in p
           else float(np.float32(st["weight_scale"])))
    layer.set_quantized(_t(qw, np.int8), _t(p["q_bias"], np.int8), s_w)
    rowsum = np.asarray(p["rowsum"], np.int64)
    if not np.array_equal(layer.rowsum.cpu().numpy(), rowsum):
        raise ValueError(f"{name}.rowsum disagrees with its weights")


def _load_table_layer(name: str, layer: Layer, st: dict) -> None:
    p = st["params"]
    if isinstance(layer, QuantEmbed) and "q_weight" in p:
        _expect(name, "q_weight", p["q_weight"],
                (layer.vocab_size, layer.dim))
        layer.q_weight = _t(p["q_weight"], np.uint8).to(layer.device)
        layer.weight = None
        return
    layer.load_weight(p["weight"])
    if "bias" in p:
        layer.load_bias(p["bias"])


def _load_layer(name: str, layer: Layer, st: dict) -> None:
    if isinstance(layer, (Linear, Conv2d)):
        _load_gemm_layer(name, layer, st)
    elif isinstance(layer, _TABLES):
        _load_table_layer(name, layer, st)
    elif st["params"]:
        raise ValueError(f"{name}: {type(layer).__name__} has no params, got "
                         f"{sorted(st['params'])}")
    layer.is_quantized = bool(st["is_quantized"])
    layer.scale = float(st["scale"])
    layer.zero_point = int(st["zero_point"])
    layer.is_preparing = False
    layer.calibrator = None


def load_jax_state(module, state: dict) -> None:
    """Install ``state`` (JAX layouts, see the module docstring) into
    ``module``; every layer must be present, all converted or none."""
    layers = dict(module.named_layers())
    if set(state) != set(layers):
        raise KeyError(f"state layers {sorted(state)} != model layers "
                       f"{sorted(layers)}")
    quantized = {bool(st["is_quantized"]) for st in state.values()}
    if len(quantized) > 1:
        raise ValueError("state mixes converted and unconverted layers")
    for name, st in state.items():
        _load_layer(name, layers[name], st)
    module.is_quant = quantized == {True}


def _gemm_params(layer: Layer) -> tuple[dict, object]:
    if layer.is_quantized and getattr(layer, "w4_packed", None) is not None:
        params = {"w4_packed": layer.w4_packed.cpu().numpy(),
                  "w4_scales": layer.w4_scales.cpu().numpy(),
                  "bias": layer.bias.cpu().numpy()}
        if layer.w4_wsum is not None:
            params["w4_wsum"] = layer.w4_wsum.cpu().numpy()
        return params, layer.weight_scale
    if layer.is_quantized:
        qw = layer.qw.cpu().numpy()
        if isinstance(layer, Conv2d):
            k = layer.kernel_size
            params = {"qw_hwio": qw.T.reshape(k, k, layer.in_channels,
                                              layer.out_channels)}
        else:
            params = {"qw_kn": qw.T.copy()}
        params["q_bias"] = layer.q_bias.cpu().numpy()
        params["rowsum"] = layer.rowsum.cpu().numpy()
        ws = layer.weight_scale
        if isinstance(ws, torch.Tensor):
            ws = params["w_scale"] = ws.cpu().numpy()
        return params, ws
    w = layer.weight.cpu().numpy()
    params = ({"w_hwio": np.transpose(w, (2, 3, 1, 0))}
              if isinstance(layer, Conv2d) else {"weight": w})
    params["bias"] = layer.bias.cpu().numpy()
    return params, layer.weight_scale


def _params(layer: Layer) -> tuple[dict, object]:
    if isinstance(layer, (Linear, Conv2d)):
        return _gemm_params(layer)
    if isinstance(layer, QuantEmbed) and layer.q_weight is not None:
        return {"q_weight": layer.q_weight.cpu().numpy()}, layer.weight_scale
    params = {}
    for key in ("weight", "bias"):
        if isinstance(layer, _TABLES) and getattr(layer, key, None) \
                is not None:
            params[key] = getattr(layer, key).cpu().numpy()
    return params, layer.weight_scale


def export_state(module) -> dict:
    """The inverse of ``load_jax_state``: ``module``'s state in the JAX
    package's layouts, as numpy arrays."""
    state = {}
    for name, layer in module.named_layers():
        params, ws = _params(layer)
        state[name] = {"params": params, "scale": layer.scale,
                       "zero_point": layer.zero_point, "weight_scale": ws,
                       "is_quantized": layer.is_quantized}
    return state
