"""Cross-layer equalization (CLE): a data-free PTQ accuracy lever
(counterpart of ``int8inferenceengine_tpu.utils.equalize``).

For consecutive layers A -> f -> B where ``f`` is positively homogeneous
and channelwise (ReLU, max-pool), the function is invariant under

    W_A[i,:] /= s_i      b_A[i] /= s_i      W_B[:,i] *= s_i

and ``s_i = sqrt(r_A_i / r_B_i)`` (r = per-channel absolute weight range)
equalizes both layers' channel ranges at ``sqrt(r_A_i * r_B_i)`` (Nagel et
al., "Data-Free Quantization Through Weight Equalization and Bias
Correction", ICCV 2019, §4.1), shrinking the per-tensor quantization error
of both.  Max, divide and a correctly rounded sqrt are exact IEEE operations, so the
rewritten weights are the same bits on the card, on the CPU and in the JAX
package.

Run it BEFORE ``prepare()`` (calibration must see the equalized model):

    cross_layer_equalize(net, [("conv1", "conv2"), ("fc1", "fc2")])
    net.prepare(); net(calib); net.convert()

Pairs chain output -> input with only ReLU / max-pool between them; a
flatten between a conv and a Linear loses channel identity and is refused
by the channel-count check where the counts differ.
"""

from __future__ import annotations

import torch

from ..layers import Conv2d, Linear

__all__ = ["cross_layer_equalize"]


def _axes(layer):
    """(out_axis, in_axis) of a weight-bearing layer's ``weight`` (a
    Linear's [out, in], a conv's OIHW)."""
    if isinstance(layer, (Conv2d, Linear)):
        return 0, 1
    raise TypeError(f"cross_layer_equalize: unsupported layer {type(layer)}")


def _channel_range(w: torch.Tensor, axis: int) -> torch.Tensor:
    dims = tuple(i for i in range(w.dim()) if i != axis)
    return torch.amax(torch.abs(w), dim=dims)


def _along(s: torch.Tensor, ndim: int, axis: int) -> torch.Tensor:
    shape = [1] * ndim
    shape[axis] = -1
    return s.reshape(shape)


def cross_layer_equalize(model, pairs, iterations: int = 2,
                         eps: float = 1e-8):
    """Equalize each named (producer, consumer) layer pair in ``model``.

    ``pairs`` lists attribute-name tuples, e.g. ``[("conv1", "conv2")]``;
    chains share interior layers, so a couple of ``iterations`` over the
    list converge the whole chain.  Returns the model, its float weights
    rewritten in place and every cache built from them dropped."""
    layers = dict(model.named_layers())
    resolved = []
    for a_name, b_name in pairs:
        try:
            a, b = layers[a_name], layers[b_name]
        except KeyError as e:
            raise KeyError(f"cross_layer_equalize: no layer {e.args[0]!r} "
                           f"in model") from None
        if a.is_quantized or b.is_quantized:
            raise RuntimeError(
                "cross_layer_equalize must run before convert() — "
                f"({a_name!r}, {b_name!r}) already quantized")
        if a.is_preparing or b.is_preparing:
            raise RuntimeError(
                "cross_layer_equalize must run before prepare() — "
                "calibration ranges observed on pre-equalization weights "
                "would silently mismatch the rewritten model")
        a_out, _ = _axes(a)
        _, b_in = _axes(b)
        if isinstance(b, Conv2d) and b.groups != 1:
            raise ValueError(
                f"cross_layer_equalize: consumer {b_name!r} is grouped — "
                "input-channel scaling would cross group boundaries")
        n_out, n_in = a.weight.shape[a_out], b.weight.shape[b_in]
        if n_out != n_in:
            raise ValueError(
                f"cross_layer_equalize: {a_name!r} out={n_out} != "
                f"{b_name!r} in={n_in} (is something between them "
                "reshaping channels?)")
        resolved.append((a, a_out, b, b_in))

    for _ in range(iterations):
        for a, a_out, b, b_in in resolved:
            wa, wb = a.weight, b.weight
            r1 = torch.clamp_min(_channel_range(wa, a_out), eps)
            r2 = torch.clamp_min(_channel_range(wb, b_in), eps)
            # the root in float64, rounded once: the correctly rounded
            # float32 root, as numpy's and XLA's (torch's float32 sqrt on
            # the CPU is an ULP off on some inputs)
            s = torch.sqrt((r1 / r2).to(torch.float64)).to(torch.float32)
            a.weight = wa / _along(s, wa.dim(), a_out)
            a.bias = a.bias / s
            b.weight = wb * _along(s, wb.dim(), b_in)

    for _, layer in layers.items():
        layer._epilogue_cache = {}
        layer._merged_cache = {}
    return model
