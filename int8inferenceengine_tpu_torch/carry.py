"""Carry a model's state between the JAX package's layout and this port's.

A state maps each layer name (``Module.named_layers()``) to

    {"params": {name: np.ndarray}, "scale": float, "zero_point": int,
     "weight_scale": float or np.ndarray, "is_quantized": bool}

with ``params`` in the JAX package's layouts: before convert ``weight`` /
``bias`` (Linear, [out, in]) or ``w_hwio`` / ``bias`` (Conv2d, HWIO); after
convert ``qw_kn`` ([K, N] s8) or ``qw_hwio`` (HWIO s8), with ``q_bias``,
``rowsum`` and, per channel, ``w_scale``.  It is what a JAX ``Layer`` holds
in ``layer.params`` and its attributes, so after ``load_jax_state`` both
packages compute the same function.
"""

from __future__ import annotations

import numpy as np
import torch

from .layers import Conv2d, Layer


def _t(arr, dtype) -> torch.Tensor:
    return torch.tensor(np.asarray(arr, dtype=dtype))


def _expect(layer_name: str, what: str, arr, shape):
    if tuple(np.shape(arr)) != tuple(shape):
        raise ValueError(f"{layer_name}.{what}: shape {np.shape(arr)} != "
                         f"expected {tuple(shape)}")


def _load_layer(name: str, layer: Layer, st: dict) -> None:
    p = st["params"]
    k = getattr(layer, "kernel_size", None)
    n, c = layer.out_channels, layer.in_channels
    if not st["is_quantized"]:
        if isinstance(layer, Conv2d):
            _expect(name, "w_hwio", p["w_hwio"], (k, k, c, n))
            layer.load_weight(np.transpose(p["w_hwio"], (3, 2, 0, 1)))
        else:
            layer.load_weight(p["weight"])
        layer.load_bias(p["bias"])
        layer.is_quantized = False
    else:
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
        layer.is_quantized = True
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


def export_state(module) -> dict:
    """The inverse of ``load_jax_state``: ``module``'s state in the JAX
    package's layouts, as numpy arrays."""
    state = {}
    for name, layer in module.named_layers():
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
        else:
            w = layer.weight.cpu().numpy()
            params = ({"w_hwio": np.transpose(w, (2, 3, 1, 0))}
                      if isinstance(layer, Conv2d) else {"weight": w})
            params["bias"] = layer.bias.cpu().numpy()
            ws = layer.weight_scale
        state[name] = {"params": params, "scale": layer.scale,
                       "zero_point": layer.zero_point, "weight_scale": ws,
                       "is_quantized": layer.is_quantized}
    return state

