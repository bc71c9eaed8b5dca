"""Checkpointing: persist and restore a model, the quantized artifact
included (counterpart of ``int8inferenceengine_tpu.utils.checkpoint``).

The file is the JAX package's format, so an artifact written by either
package loads in the other:

* one ``.npz`` with ``__meta__`` (the JSON meta as a u8 array) and one
  ``<layer>/<param>`` array per layer param, or, with a ``.safetensors``
  path, the same arrays with the JSON under the header key ``i8ie_meta``;
* the meta holds ``format_version``, the model's ``is_quant`` and, per
  layer, ``type``, ``is_quantized``, ``scale``, ``zero_point``,
  ``weight_scale`` (a float, or a list per channel) and ``params`` (the
  sorted param names);
* the params are in the JAX package's layouts (``carry``'s module
  docstring): ``carry.export_state`` writes them and
  ``carry.load_jax_state`` installs them, on the model's own device.

Calibration becomes a one-time offline step: a converted model comes back
ready for INT8 inference.  ``read_state_dict`` reads a flat ``name.weight``
state dict from a .pt / .npz / .safetensors file for ``Module.load``.
``safetensors`` is imported only for a ``.safetensors`` path; without it
that path raises ``ImportError``.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..carry import export_state, load_jax_state

FORMAT_VERSION = 1


def state_dict(model) -> dict:
    """Flat {"layer.param": np.ndarray} view of every layer param, in the
    JAX package's layouts."""
    return {f"{name}.{k}": v for name, st in export_state(model).items()
            for k, v in st["params"].items()}


def _jsonable(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy().tolist()       # per-channel weight scales
    if isinstance(x, np.ndarray):
        return x.tolist()
    return float(np.float32(x))


def save(model, path: str) -> None:
    """Save a model (FP32 or quantized) to ``path`` (.npz or .safetensors);
    each array is copied from the device once."""
    arrays = {}
    meta = {"format_version": FORMAT_VERSION,
            "is_quant": bool(model.is_quant), "layers": {}}
    layers = dict(model.named_layers())
    for name, st in export_state(model).items():
        meta["layers"][name] = {
            "type": type(layers[name]).__name__,
            "is_quantized": bool(st["is_quantized"]),
            "scale": float(np.float32(st["scale"])),
            "zero_point": int(st["zero_point"]),
            "weight_scale": _jsonable(st["weight_scale"]),
            "params": sorted(st["params"]),
        }
        for k, v in st["params"].items():
            arrays[f"{name}/{k}"] = v
    if str(path).endswith(".safetensors"):
        from safetensors.numpy import save_file
        save_file({k: np.ascontiguousarray(v) for k, v in arrays.items()},
                  path, metadata={"i8ie_meta": json.dumps(meta)})
        return
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def _read(path: str) -> tuple[dict, dict]:
    """(meta, {key: array}) of a checkpoint file."""
    if str(path).endswith(".safetensors"):
        import safetensors
        with safetensors.safe_open(path, framework="numpy") as f:
            md = f.metadata()
            if not md or "i8ie_meta" not in md:
                raise ValueError(
                    f"{path} is not an i8ie checkpoint (no 'i8ie_meta' "
                    "header) — for a plain safetensors state_dict use "
                    "read_state_dict() + Module.load()")
            return (json.loads(md["i8ie_meta"]),
                    {k: f.get_tensor(k) for k in f.keys()})
    with np.load(path) as z:
        return (json.loads(bytes(z["__meta__"]).decode()),
                {k: z[k] for k in z.files if k != "__meta__"})


def load(model, path: str):
    """Restore ``model`` (the architecture must match) from ``path``, in
    place on the model's device, and return it.  A quantized checkpoint
    comes back ready for INT8 inference, no prepare/convert needed.  The
    format is chosen by extension (.safetensors, else npz).

    What the layers derived from their old state (operands built per
    input grid, merged groups, activation tables) is dropped, and
    ``generate()`` captures its programs anew at every call; a serving
    engine built on the model before the load keeps graphs over the old
    buffers, so build engines after it."""
    meta, arrays = _read(path)
    if meta.get("format_version", 0) > FORMAT_VERSION:
        raise ValueError(
            f"checkpoint format v{meta['format_version']} is newer than "
            f"supported v{FORMAT_VERSION}")
    layers = dict(model.named_layers())
    if set(layers) != set(meta["layers"]):
        raise ValueError(
            f"architecture mismatch: checkpoint layers "
            f"{sorted(meta['layers'])} != model layers {sorted(layers)}")
    state = {}
    for name, info in meta["layers"].items():
        layer = layers[name]
        if type(layer).__name__ != info["type"]:
            raise ValueError(
                f"layer {name!r}: checkpoint has {info['type']}, model "
                f"has {type(layer).__name__}")
        ws = info["weight_scale"]
        state[name] = {
            # np.load's arrays are this call's own: used without a copy
            "params": {k: torch.from_numpy(np.ascontiguousarray(
                arrays[f"{name}/{k}"])) for k in info["params"]},
            "scale": info["scale"], "zero_point": info["zero_point"],
            "weight_scale": np.float32(ws) if isinstance(ws, list) else ws,
            "is_quantized": info["is_quantized"]}
    load_jax_state(model, state)
    model.is_quant = bool(meta["is_quant"])
    return model


def read_state_dict(path: str) -> dict:
    """A flat ``name.weight`` / ``name.bias`` state dict for ``Module.load``
    from a .pt/.pth (torch), .npz or .safetensors file, as numpy arrays.
    A .safetensors file's bfloat16 arrays are widened to float32 (exact):
    the JAX package reads them too, where jax gives numpy ml_dtypes'
    bfloat16; a torch file's raise ``TypeError``, as there."""
    p = str(path)
    if p.endswith(".safetensors"):
        from safetensors.torch import load_file
        return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
                for k, v in load_file(p).items()}
    if p.endswith(".npz"):
        with np.load(p) as z:
            return {k: z[k] for k in z.files}
    if p.endswith((".pt", ".pth")):
        sd = torch.load(p, map_location="cpu", weights_only=True)
        return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
                for k, v in sd.items()}
    raise ValueError(
        f"read_state_dict: unsupported extension on {path!r} — "
        "expected .pt/.pth (torch), .npz, or .safetensors")
