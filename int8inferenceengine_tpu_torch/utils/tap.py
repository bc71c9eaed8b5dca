"""The levers' tapped forward: one FP32 pass over a calibration batch that
records every Linear's and Conv2d's input (``layers._INPUT_TAP``)."""

from __future__ import annotations

import torch

from ..layers import _INPUT_TAP
from ..tensor import tensor


def model_device(net) -> torch.device:
    """The device of ``net`` (a ``Module``, or any object with
    ``named_layers``)."""
    dev = getattr(net, "device", None)
    if dev is None:
        dev = next(iter(net.named_layers()))[1].device
    return dev


def synchronize(dev: torch.device) -> None:
    """Wait for the card's queue (a lever's per-layer seconds)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def tapped_forward(net, x_calib, observe: bool = True) -> dict:
    """``net.forward`` over ``x_calib`` (images, rows or token ids, taken as
    float32) with the tap set; returns {id(layer): [inputs]} on the model's
    device.  ``observe=False`` suspends calibration for the pass, so that a
    batch the calibrators already saw is not fed to them twice."""
    tap: dict = {}
    layers = [l for _, l in net.named_layers()]
    was = [l.is_preparing for l in layers]
    token = _INPUT_TAP.set(tap)
    try:
        if not observe:
            for l in layers:
                l.is_preparing = False
        with torch.no_grad():
            net.forward(tensor(x_calib, device=model_device(net)))
    finally:
        for l, p in zip(layers, was):
            l.is_preparing = p
        _INPUT_TAP.reset(token)
    return tap
