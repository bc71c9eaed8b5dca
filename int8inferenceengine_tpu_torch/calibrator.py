"""Activation-range calibrator for post-training static quantization
(counterpart of ``int8inferenceengine_tpu.calibrator``).

The default observer is an exact streaming min/max: each observed batch
folds ``torch.amin`` / ``torch.amax`` into running 0-dim tensors on the
batch's device, and the host reads them once, when the range is derived.
A reference-style random reservoir is kept for ``quantile < 1`` and the MSE
objective; it needs the raw values on the host.

The (scale, zero_point) derivation reproduces the reference's
calibrator.cc:24-37 bit-for-bit in float32:

    min = fmin(observed_min, 0);  max = fmax(observed_max, 0)
    zp    = u8( 255 * (0 - min) / (max - min + 1e-9) )     # trunc toward 0
    scale = (max - min)/255  if zp == 0  else  (0 - min)/zp
    scale = 1 if scale == 0                                 # unsampled/edge
"""

from __future__ import annotations

import numpy as np
import torch


class Calibrator:
    def __init__(self, exact_minmax: bool = True, reservoir_size: int = 1000,
                 seed: int = 0, method: str = "minmax",
                 rounding: str = "trunc"):
        if method not in ("minmax", "mse"):
            raise ValueError(f"unknown calibration method {method!r}")
        self.method = method
        self.rounding = rounding   # the engine's float->code cast, so the
        #                            MSE objective simulates what runs
        # MSE search needs raw samples — force the reservoir on.
        self.exact_minmax = exact_minmax and method == "minmax"
        self.reservoir_size = reservoir_size
        self._min = None   # device scalars; read on the host at get_range
        self._max = None
        self._reservoir = np.empty(reservoir_size, dtype=np.float32)
        self._count = 0
        self._count_res = 0
        self._rng = np.random.default_rng(seed)

    def sample(self, out: torch.Tensor) -> None:
        """Observe a batch of layer outputs.  The reservoir takes values in
        ``out``'s logical C order."""
        lo, hi = torch.amin(out), torch.amax(out)
        if self._min is None:
            self._min, self._max = lo, hi
        else:
            self._min = torch.minimum(self._min, lo)
            self._max = torch.maximum(self._max, hi)
        self._count += out.numel()
        if not self.exact_minmax:
            self._sample_reservoir(
                out.detach().cpu().numpy().astype(np.float32).ravel())

    def _sample_reservoir(self, values: np.ndarray) -> None:
        # Reference semantics (calibrator.cc:6-23): fill first N, then each
        # value lands in a random slot with probability N/(2N+1).
        n = self.reservoir_size
        take = min(len(values), n - self._count_res)
        if take > 0:
            self._reservoir[self._count_res:self._count_res + take] = values[:take]
            self._count_res += take
            values = values[take:]
        if len(values):
            idx = self._rng.integers(0, 2 * n + 1, size=len(values))
            hit = idx < n
            self._reservoir[idx[hit]] = values[hit]

    def _host_minmax(self):
        return np.float32(self._min.item()), np.float32(self._max.item())

    def stats(self) -> dict:
        """Observed-range summary for observability/logging."""
        if self._count == 0:
            return {"count": 0, "min": None, "max": None}
        lo, hi = self._host_minmax()
        return {"count": int(self._count), "min": float(lo), "max": float(hi)}

    @staticmethod
    def _derive(out_min, out_max):
        """(min, max) -> (scale, zp), bit-matching calibrator.cc:24-37."""
        out_min = np.float32(min(out_min, np.float32(0.0)))
        out_max = np.float32(max(out_max, np.float32(0.0)))
        zp = int(np.float32(255.0) * (np.float32(0.0) - out_min)
                 / (out_max - out_min + np.float32(1e-9)))
        zp = max(0, min(255, zp))
        if zp == 0:
            scale = float((out_max - out_min) / np.float32(255.0))
        else:
            scale = float((np.float32(0.0) - out_min) / np.float32(zp))
        if scale == 0.0:
            scale = 1.0
        return scale, zp

    def _mse_range(self):
        """Grid-search the clip range minimizing reconstruction MSE over the
        reservoir plus the exactly tracked population extremes."""
        filled = self._reservoir[:min(self._count_res, self.reservoir_size)]
        lo, hi = self._host_minmax()
        lo0 = float(min(lo, np.float32(0.0)))
        hi0 = float(max(hi, np.float32(0.0)))
        samples = np.concatenate(
            [filled, np.float32([lo0, hi0])]).astype(np.float32)
        best = (None, np.inf)
        rb = 0.5 if self.rounding == "nearest" else 0.0
        for c in np.linspace(0.30, 1.0, 29):
            scale, zp = self._derive(np.float32(lo0 * c),
                                     np.float32(hi0 * c))
            t = np.clip(samples / np.float32(scale) + zp, 0.0, 255.0)
            deq = (np.trunc(t + rb) - zp) * np.float32(scale)
            mse = float(np.mean((deq - samples) ** 2))
            if mse < best[1]:
                best = ((scale, zp), mse)
        return best[0]

    def get_range(self, quantile: float = 1.0):
        """Derive per-tensor asymmetric-u8 (scale, zero_point)."""
        if self._count == 0:
            return 1.0, 0
        if self.method == "mse" and self._count_res > 0:
            if quantile < 1.0:
                raise ValueError(
                    "calib_quantile < 1 and calib_method='mse' are "
                    "mutually exclusive range policies — pick one")
            return self._mse_range()
        if self.exact_minmax or quantile >= 1.0:
            if self.exact_minmax:
                out_min, out_max = self._host_minmax()
            else:
                filled = self._reservoir[:min(self._count_res, self.reservoir_size)]
                out_min = np.float32(filled.min())
                out_max = np.float32(filled.max())
        else:
            filled = np.sort(
                self._reservoir[:min(self._count_res, self.reservoir_size)])
            cnt = len(filled)
            out_min = np.float32(filled[int((1.0 - quantile) * cnt)])
            out_max = np.float32(filled[int(quantile * (cnt - 1))])
        return self._derive(out_min, out_max)
