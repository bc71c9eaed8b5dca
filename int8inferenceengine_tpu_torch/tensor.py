"""User-facing tensor wrapper (counterpart of ``int8inferenceengine_tpu.tensor``).

A thin wrapper over a ``torch.Tensor`` that carries per-tensor quantization
metadata: ``scale`` (default 1.0) and ``zero_point`` (default 0).  A uint8
tensor is a quantized activation tensor.

Quantized convolutions run NHWC internally, while the reference API is NCHW
(element order is observable through ``reshape``, e.g. AlexNet's
``x.reshape(-1, 9216)``).  A Tensor may therefore hold its data physically as
NHWC (``_nhwc=True``) while reporting the logical NCHW shape; any op that
depends on element order (reshape / numpy export) first re-materializes NCHW.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; the CPU only when asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda")
    return torch.device(device)


class Tensor:
    """Dense tensor + per-tensor quantization metadata."""

    __slots__ = ("data", "scale", "zero_point", "_nhwc")

    def __init__(self, data: torch.Tensor, scale: float = 1.0,
                 zero_point: int = 0, _nhwc: bool = False):
        self.data = data
        self.scale = float(scale)
        self.zero_point = int(zero_point)
        self._nhwc = _nhwc

    # -- layout ------------------------------------------------------------
    @property
    def logical_data(self) -> torch.Tensor:
        """Data in the reference's logical (NCHW) element order."""
        if self._nhwc:
            return self.data.permute(0, 3, 1, 2)
        return self.data

    def as_nhwc_data(self) -> torch.Tensor:
        """Physical NHWC data (for conv/pool); input must be 4D."""
        if self._nhwc:
            return self.data
        if self.data.dim() != 4:
            raise ValueError(f"expected 4D tensor, got shape {self.shape}")
        return self.data.permute(0, 2, 3, 1)

    # -- reference Tensor API ------------------------------------------------
    @property
    def shape(self):
        if self._nhwc:
            n, h, w, c = self.data.shape
            return (n, c, h, w)
        return tuple(self.data.shape)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def quantized(self) -> bool:
        return self.data.dtype == torch.uint8

    def numpy(self) -> np.ndarray:
        # C-contiguous like the JAX package's arrays, so that numpy's
        # reductions (``sum``) add in the same order
        return self.logical_data.detach().contiguous().cpu().numpy()

    def reshape(self, *args):
        if len(args) == 1 and isinstance(args[0], (tuple, list)):
            args = tuple(args[0])
        return Tensor(self.logical_data.reshape(args), self.scale,
                      self.zero_point)

    def sum(self):
        return self.numpy().sum()

    def __eq__(self, obj):  # elementwise equality -> float tensor, like i8ie
        other = obj.numpy() if isinstance(obj, Tensor) else np.asarray(obj)
        eq = np.float32(self.numpy() == other)
        return Tensor(torch.tensor(eq, device=self.data.device))

    def __hash__(self):
        return id(self)

    def __repr__(self):
        # Reference shows dequantized values: (q - zp) * scale
        return repr((self.numpy() - self.zero_point) * self.scale)


def tensor(ndarray, device=None) -> Tensor:
    """Factory matching ``i8ie.tensor``: always a float32 tensor, on the
    CUDA card unless ``device`` names another."""
    dev = resolve_device(device)
    if isinstance(ndarray, torch.Tensor):
        return Tensor(ndarray.detach().to(device=dev, dtype=torch.float32))
    arr = np.asarray(ndarray, dtype=np.float32)
    return Tensor(torch.tensor(arr, device=dev))
