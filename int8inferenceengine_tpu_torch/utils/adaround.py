"""AdaRound: adaptive weight rounding (Nagel et al., ICML 2020;
counterpart of ``int8inferenceengine_tpu.utils.adaround``).

Rounding each weight to the NEAREST code is optimal per weight but not per
layer: the layer-output error couples weights through the input's second
moment, and choosing round-up or round-down per weight to minimize
``||W x - W~ x||`` recovers much of the quantization loss:

    W~ = s * clip(floor(W / s) + h(V), -bound, bound)
    h(V) = clip(sigmoid(V) * (zeta - gamma) + gamma, 0, 1)
    loss = ||W x - W~ x||^2 / n  +  lam * sum(1 - |2 h - 1|^beta)

with (zeta, gamma) = (1.1, -0.1), beta annealed 20 -> 2, and V initialized
so that h(V) is the fractional part (the optimizer starts at
round-to-nearest).  The hard rounding ``floor + (h > 0.5)`` is stashed on
the layer; ``convert()`` takes it with the standard scale
(``layers.weight_quant_spec``).

Each layer runs ``iters`` steps of ``torch.autograd`` with optax's Adam
written out (``m̂ / (sqrt(v̂) + eps)``, eps 1e-8 outside the root), on the
model's device.  ``clip`` is ``minimum(maximum(x, lo), hi)`` as in
``jnp.clip``, so that an input exactly at a bound takes half the gradient,
as it does in JAX (``torch.clamp`` passes all of it).  The loop is not
bit-exact across frameworks or devices (sigmoid, the products and the
reductions round differently); its tests compare quality and the share of
equal codes.

Call it between calibration and ``convert()``:

    net.prepare(); net(tensor(x_calib))
    adaround(net, x_calib)
    net.convert()
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as tF

from ..layers import Conv2d, Linear, weight_quant_spec
from .tap import synchronize, tapped_forward

__all__ = ["adaround"]

_ZETA, _GAMMA = 1.1, -0.1
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip``'s form and gradient (ties split evenly)."""
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


def _h(v: torch.Tensor) -> torch.Tensor:
    return _clip(torch.sigmoid(v) * (_ZETA - _GAMMA) + _GAMMA, 0.0, 1.0)


def _h_init(frac: torch.Tensor) -> torch.Tensor:
    """V with ``h(V) = frac`` (to float32 rounding)."""
    return -torch.log((_ZETA - _GAMMA) / (frac - _GAMMA) - 1.0)


def _layer_out(layer, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """FP32 layer output without the bias (rounding only moves ``W x``): a
    Linear's [M, N] rows, a conv's NCHW maps (grouped included)."""
    if isinstance(layer, Linear):
        return torch.matmul(x, w.t())
    return tF.conv2d(x, w, None, layer.stride, layer.padding, 1,
                     layer.groups)


def _optimize(layer, v, floor_w, s, x, out_ref, iters, lr, lam, bound):
    """``iters`` Adam steps on V (optax's ``adam(lr)``); returns V."""
    m = torch.zeros_like(v)
    u = torch.zeros_like(v)
    dev = v.device
    for i in range(iters):
        frac = torch.tensor(i, dtype=torch.float32, device=dev) / max(
            iters - 1, 1)
        beta = 20.0 * (1.0 - frac) + 2.0 * frac
        v.requires_grad_(True)
        with torch.enable_grad():
            h = _h(v)
            w_soft = s * _clip(floor_w + h, -bound, bound)
            mse = torch.mean(torch.square(_layer_out(layer, w_soft, x)
                                          - out_ref))
            reg = torch.sum(1.0 - torch.abs(2.0 * h - 1.0) ** beta)
            (g,) = torch.autograd.grad(mse + lam * reg, v)
        v = v.detach()
        m = (1 - _B1) * g + _B1 * m
        u = (1 - _B2) * (g * g) + _B2 * u
        count = torch.tensor(i + 1, dtype=torch.float32, device=dev)
        m_hat = m / (1 - _B1 ** count)
        u_hat = u / (1 - _B2 ** count)
        v = v + (m_hat / (torch.sqrt(u_hat) + _EPS)) * (-lr)
    return v


def adaround(net, x_calib, *, iters: int = 400, lr: float = 1e-2,
             lam: float = 1e-3, max_rows: int = 2048,
             max_images: int = 8, verbose: bool = False,
             report: dict | None = None):
    """Optimize the weight rounding of every Linear / Conv2d in ``net``.

    Call between calibration and ``convert()``.  ``x_calib`` is a
    representative batch (what the calibrators saw); the tapped forward
    suspends observation so that they do not see it twice.  ``max_rows``
    (Linear) / ``max_images`` (Conv2d) bound each layer's tapped input
    with a sorted sample from one ``np.random.default_rng(0)`` shared in
    layer order, the JAX package's rows and images.  ``report``, a dict,
    receives each layer's {"seconds", "mse_nearest", "mse_adaround",
    "reround"} (the errors on the sampled input, without the bias)."""
    if net.is_quant:
        raise RuntimeError("adaround must run before convert()")
    tap = tapped_forward(net, x_calib, observe=False)

    rng = np.random.default_rng(0)
    for name, layer in net.named_layers():
        if not isinstance(layer, (Linear, Conv2d)):
            continue
        xs = tap.get(id(layer))
        if not xs:
            continue
        x = torch.cat(xs, 0)
        limit = max_rows if isinstance(layer, Linear) else max_images
        if x.shape[0] > limit:
            idx = np.sort(rng.choice(x.shape[0], limit, replace=False))
            x = x[torch.as_tensor(idx, device=x.device)]

        t0 = time.perf_counter()
        w, s, bound, group_scales = weight_quant_spec(layer)
        wf = w / s
        floor_w = torch.floor(wf)
        frac = torch.clamp(wf - floor_w, 1e-4, 1 - 1e-4)
        out_ref = _layer_out(layer, w, x)
        v = _optimize(layer, _h_init(frac), floor_w, s, x, out_ref, iters,
                      lr, lam, bound)
        q_w = torch.clamp(floor_w + (_h(v) > 0.5).to(torch.float32),
                          -bound, bound).to(torch.int8)
        layer._adaround_qw = q_w
        if group_scales is not None:
            layer._adaround_scales = group_scales
        if not (verbose or report is not None):
            continue
        synchronize(x.device)
        seconds = time.perf_counter() - t0
        nearest = torch.clamp(torch.round(wf), -bound, bound)
        e_near = float(torch.mean(torch.square(
            _layer_out(layer, s * nearest, x) - out_ref)))
        e_ada = float(torch.mean(torch.square(
            _layer_out(layer, s * q_w.to(torch.float32), x) - out_ref)))
        flipped = int((q_w != nearest.to(torch.int8)).sum())
        if report is not None:
            report[name] = dict(seconds=seconds, mse_nearest=e_near,
                                mse_adaround=e_ada, reround=flipped)
        if verbose:
            print(f"adaround {name}: mse nearest {e_near:.3e} -> "
                  f"{e_ada:.3e} ({flipped} weights re-rounded)")
    return net
