"""GPTQ: Hessian-aware error-compensated weight quantization (Frantar et
al., ICLR 2023; counterpart of ``int8inferenceengine_tpu.utils.gptq``).

GPTQ quantizes a Linear's weight columns IN ORDER and folds each column's
rounding error into the columns not yet quantized through the inverse
input Hessian ``H = 2 X^T X``, the update that minimizes the layer-output
error given what is already committed:

    for k in 0..K-1:
        q_k    = quant(W[:, k])
        err    = (W[:, k] - dq(q_k)) / Hinv[k, k]
        W[:, k+1:] -= err · Hinv[k, k+1:]

The sweep keeps the JAX package's float order exactly, column by column
(no lazy-batch blocking, which is equal only in exact arithmetic): ``err``
in float32 over a float32 ``Hinv[k, k]``; the update's product in float64
(``Hinv`` is float64) and ``W`` rounded once to float32 after each
subtraction; round half to even.  It runs on the model's device with
stock torch ops.  ``H`` is formed in float64 from the float32 rows.

The s8 paths (W8A8 static and W8-float: the fixed per-tensor or
per-channel scale) and the 4-bit paths (W4A8 and W4 weight-only: the
group scales ``pack_w4`` picks from the original weights) share
``layers.weight_quant_spec``; the codes ride ``convert()``'s hooks
(``_adaround_qw`` / ``_adaround_scales``).

    net.load(...)
    gptq(net, x_calib)      # before prepare() and convert()
    net.prepare(); net(tensor(x_calib)); net.convert()
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..layers import Linear, weight_quant_spec
from .tap import synchronize, tapped_forward

__all__ = ["gptq"]


def inverse_hessian(x: torch.Tensor, damp: float) -> torch.Tensor:
    """float32 rows [R, K] -> ``inv(2 X^T X + (damp * mean(diag) + 1e-8) I)``
    in float64 [K, K]."""
    x64 = x.to(torch.float64)
    h = 2.0 * (x64.t() @ x64)
    k = h.shape[0]
    h += torch.eye(k, dtype=torch.float64, device=h.device) * (
        damp * float(torch.mean(torch.diagonal(h))) + 1e-8)
    return torch.linalg.inv(h)


def gptq_sweep(w: torch.Tensor, scale: torch.Tensor, bound: float,
               hinv: torch.Tensor) -> torch.Tensor:
    """The column sweep: float32 ``w`` [N, K] (not modified), ``scale``
    broadcasting to [N, K] (each code's float32 scale), ``hinv`` float64
    [K, K] -> int8 codes [N, K] in ``[-bound, bound]``."""
    w = w.to(torch.float32).clone()
    n, k = w.shape
    cols = torch.broadcast_to(scale.to(torch.float32), (n, k))
    diag = torch.diagonal(hinv).to(torch.float32)
    q = torch.empty((n, k), dtype=torch.float32, device=w.device)
    for j in range(k):
        s = cols[:, j]
        qj = torch.clamp(torch.round(w[:, j] / s), -bound, bound)
        q[:, j] = qj
        err = (w[:, j] - qj * s) / diag[j]
        if j + 1 < k:
            # float64 product, float64 difference, one rounding to float32
            w[:, j + 1:] -= torch.outer(err.to(torch.float64),
                                        hinv[j, j + 1:])
    return q.to(torch.int8)


def gptq_layers(layers, x: torch.Tensor, damp: float) -> None:
    """Choose the integer codes of ``layers`` (Linears that read the same
    tapped rows ``x``) and stash them, with the group scales of a 4-bit
    layer, for ``convert()``.  Rows never mix in the sweep, so the layers'
    weights run as one [sum N, K] sweep over their one inverse Hessian:
    the codes of each layer's own sweep, with fewer column steps."""
    specs = [weight_quant_spec(l) for l in layers]
    k = x.shape[1]
    per_row = all(s.dim() < 2 or s.shape[-1] == 1 for _, s, _, _ in specs)
    w = torch.cat([w for w, _, _, _ in specs])
    scale = torch.cat([torch.broadcast_to(s, (w_.shape[0], 1 if per_row
                                               else k))
                       for w_, s, _, _ in specs])
    bound = specs[0][2]
    assert all(b == bound for _, _, b, _ in specs)
    codes = gptq_sweep(w, scale, bound, inverse_hessian(x, damp))
    for layer, q, (_, _, _, group_scales) in zip(
            layers, torch.split(codes, [w_.shape[0] for w_, _, _, _ in specs]),
            specs):
        layer._adaround_qw = q.contiguous()
        if group_scales is not None:
            layer._adaround_scales = group_scales


def _same_rows(a: list, b: list) -> bool:
    return len(a) == len(b) and all(u is v for u, v in zip(a, b))


def output_errors(layer, x: torch.Tensor) -> tuple:
    """(GPTQ's, round-to-nearest's) layer-output MSE on rows ``x``, both at
    the scales of ``weight_quant_spec`` (at 4 bits: ``pack_w4``'s nearest
    codes), against the float weight's output."""
    w, s, bound, _ = weight_quant_spec(layer)
    ref = torch.matmul(x, w.t())
    nearest = torch.clamp(torch.round(w / s), -bound, bound)

    def mse(q):
        return float(torch.mean(torch.square(torch.matmul(x, (s * q).t())
                                             - ref)))

    return mse(layer._adaround_qw.to(torch.float32)), mse(nearest)


def gptq(net, x_calib, *, damp: float = 0.01, max_rows: int = 4096,
         layers=None, verbose: bool = False, report: dict | None = None):
    """Error-compensated quantization for every Linear in ``net``.

    Call before ``convert()``, best before ``prepare()``: the tapped
    forward observes while preparing, so a prepared model's calibrators
    see the batch again.  ``layers`` optionally restricts to a set of layer
    names; a layer with more than ``max_rows`` tapped rows takes a sorted
    sample of them from one ``np.random.default_rng(0)`` shared in layer
    order, the JAX package's rows.  Consecutive layers that read the same
    rows (wq, wk, wv; gate, up) and were not sampled run as one sweep.
    ``report``, a dict, receives each layer's {"seconds" (its rows' share
    of its sweep's), "k", "rows", "mse_gptq", "mse_nearest"}."""
    if net.is_quant:
        raise RuntimeError("gptq must run before convert()")
    tap = tapped_forward(net, x_calib)

    rng = np.random.default_rng(0)
    groups = []           # [names, layers, tapped list, rows]
    for name, layer in net.named_layers():
        if not isinstance(layer, Linear):
            continue
        if layers is not None and name not in layers:
            continue
        xs = tap.get(id(layer))
        if not xs:
            continue
        x = torch.cat([v.to(torch.float32) for v in xs], 0)
        if x.shape[0] > max_rows:
            idx = np.sort(rng.choice(x.shape[0], max_rows, replace=False))
            groups.append([[name], [layer], None,
                           x[torch.as_tensor(idx, device=x.device)]])
        elif groups and groups[-1][2] is not None and _same_rows(
                groups[-1][2], xs) and groups[-1][1][0].config == \
                layer.config:
            groups[-1][0].append(name)          # e.g. wq, wk, wv
            groups[-1][1].append(layer)
        else:
            groups.append([[name], [layer], xs, x])
    for names, group, _, x in groups:
        t0 = time.perf_counter()
        gptq_layers(group, x, damp)
        if report is not None:
            synchronize(x.device)
            rows = sum(l.out_channels for l in group)
            seconds = time.perf_counter() - t0
            for name, layer in zip(names, group):
                e_gptq, e_near = output_errors(layer, x)
                report[name] = dict(
                    seconds=seconds * layer.out_channels / rows,
                    k=x.shape[1], rows=x.shape[0], mse_gptq=e_gptq,
                    mse_nearest=e_near)
        if verbose:
            print(f"gptq {names}: K={x.shape[1]}, {x.shape[0]} rows")
    return net
