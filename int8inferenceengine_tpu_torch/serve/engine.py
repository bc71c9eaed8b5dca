"""Continuous-batching inference engine (counterpart of
``int8inferenceengine_tpu.serve.engine``).

Callers submit requests of any batch size; a scheduler thread coalesces
whatever is queued into one device batch, pads it to a fixed tile, runs the
forward and hands the result to a collector thread, which scatters it back
to per-request futures.

* **Static batch tiles.**  The forward always sees a tile's rows (one
  ``max_batch`` tile, or the smallest of ``batch_sizes`` that fits).
* **One captured forward per tile.**  On the card each tile's forward is a
  CUDA graph over a static float32 input ``[tile, C, H, W]``: the tile's
  first batch runs eagerly (the warm-up), the forward is captured after it,
  and every later batch is copied into the static input and replays the
  graph, as the JAX package compiles one program per tile.  On the CPU the
  forward runs eagerly.
* **Pipelining.**  The scheduler thread writes a batch's rows into one of
  two pinned staging buffers (one host copy; the padding rows are zeroed on
  the card), queues the input copy, the replay and the output copy (into
  pinned host memory) on the engine's stream and goes on to the next batch;
  the collector waits for that batch's output and resolves its futures.
  ``max_inflight`` bounds the batches in flight.

* **Host ingest.**  ``quantize_ingest=True`` (converted models only)
  quantizes each request's rows on the host with the native ``quantize_u8``
  at the model's input (scale, zp) and applies the first conv's
  space-to-depth pre-layout where the model has one
  (``Module.ingest_descriptor``, ``data.prelayout``): the tile's static
  input and its pinned staging buffers are u8 of the pre-laid-out shape, a
  quarter of the float32 tile's bytes, and the padding rows hold the zero
  point (quantized zeros).  The same codes as the float path under
  'trunc' rounding (the host quantize truncates, as the JAX package's
  does).
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from .. import graphs, native
from ..data import prelayout, wrap_quantized
from ..tensor import Tensor

__all__ = ["InferenceEngine", "EngineStats"]


@dataclasses.dataclass
class EngineStats:
    requests: int = 0
    images: int = 0
    steps: int = 0
    padded_rows: int = 0
    # Completed-request latencies (submit -> result materialized), seconds.
    # Bounded ring; the lock covers the trim+append vs snapshot race.
    latencies_s: list = dataclasses.field(default_factory=list)
    _max_latencies: int = 10_000
    _lat_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    @property
    def mean_batch_fill(self) -> float:
        total = self.images + self.padded_rows
        return self.images / total if total else 0.0

    def record_latency(self, dt: float) -> None:
        with self._lat_lock:
            if len(self.latencies_s) >= self._max_latencies:
                del self.latencies_s[: self._max_latencies // 2]
            self.latencies_s.append(dt)

    def latency_percentiles(self, ps=(50, 90, 99)) -> dict:
        """Request-latency percentiles in milliseconds, e.g. {'p50': 1.2}."""
        with self._lat_lock:
            snap = list(self.latencies_s)
        if not snap:
            return {f"p{p}": float("nan") for p in ps}
        arr = np.asarray(snap)
        return {f"p{p}": float(np.percentile(arr, p) * 1e3) for p in ps}


class _Request:
    __slots__ = ("data", "future", "n", "t_submit")

    def __init__(self, data: np.ndarray):
        self.data = data
        self.n = data.shape[0]
        self.future: Future = Future()
        self.t_submit = time.monotonic()


class _TileForward:
    """The forward at one tile on the card: a static input, two pinned host
    buffers that take turns staging a batch, and the captured forward
    (``graphs.Captured``: eager on the first batch, then replays).

    ``ingest`` is None (a float32 [tile, C, H, W] input) or ``(scale, zp,
    tag)``: a u8 input quantized on the host at (scale, zp), pre-laid-out
    for ``tag`` where it is set.  The tag is part of the tile: its captured
    forward takes only tensors of that tag."""

    def __init__(self, model, shape, stream, ingest=None):
        self.model = model
        self.stream = stream
        self.ingest = ingest
        dtype, static, fill = torch.float32, tuple(shape), 0
        if ingest is not None:
            dtype, fill, tag = torch.uint8, ingest[1], ingest[2]
            if tag is not None:
                static = native.s2d_shape(shape, *tag[1:4])
        self.fill = fill
        self.x = torch.full(static, fill, dtype=dtype, device=model.device)
        self.stage = [torch.empty(static, dtype=dtype, pin_memory=True)
                      for _ in range(2)]
        self.staged = [None, None]        # each buffer's copy-done event
        self.turn = 0
        self.forward = graphs.Captured(self._forward, stream)

    def _forward(self) -> torch.Tensor:
        t = Tensor(self.x) if self.ingest is None else Tensor(
            self.x, self.ingest[0], self.ingest[1], _ingest=self.ingest[2])
        return self.model(t).logical_data.contiguous()

    def _rows(self, data: np.ndarray) -> np.ndarray:
        """A request's rows as the static input holds them."""
        if self.ingest is None:
            return data
        scale, zp, tag = self.ingest
        return prelayout(native.quantize_u8(data, scale, zp), zp, tag)

    def __call__(self, reqs, rows: int) -> torch.Tensor:
        """Stage the requests' rows (the rest of the tile is zeros, or the
        zero point under ingest), copy them in and run the forward."""
        i, self.turn = self.turn, 1 - self.turn
        if self.staged[i] is not None:
            self.staged[i].synchronize()  # its previous copy has left
        host = self.stage[i].numpy()
        off = 0
        for r in reqs:
            host[off:off + r.n] = self._rows(r.data)
            off += r.n
        self.x[:rows].copy_(self.stage[i][:rows], non_blocking=True)
        self.x[rows:].fill_(self.fill)
        self.staged[i] = torch.cuda.Event()
        self.staged[i].record(self.stream)
        return self.forward()


class InferenceEngine:
    """Continuous-batching server around a (typically converted) Module.

    >>> engine = InferenceEngine(model, max_batch=256)
    >>> fut = engine.submit(images)           # [n, C, H, W] float32, any n
    >>> logits = fut.result()                 # [n, num_classes]
    """

    def __init__(self, model, max_batch: int = 256,
                 batch_timeout_s: float = 0.002, max_inflight: int = 2,
                 quantize_ingest: bool = False, batch_sizes=None):
        """``quantize_ingest=True`` (converted models only) quantizes and
        pre-lays-out each batch on the host (see the module docstring).

        ``batch_sizes``: optional ascending tile buckets, e.g. ``(32,
        256)``; each step pads only up to the smallest tile that fits the
        coalesced rows (one captured forward per tile); the largest tile
        caps request size.  Default: one ``max_batch`` tile."""
        self.quantize_ingest = bool(quantize_ingest)
        self._ingest = None
        if self.quantize_ingest:
            if not getattr(model, "is_quant", False):
                raise ValueError(
                    "quantize_ingest requires a converted (INT8) model")
            cfg = model.config
            self._ingest = (cfg.input_scale, cfg.input_zero_point,
                            model.ingest_descriptor())
        if batch_sizes:
            self.tiles = tuple(sorted(int(b) for b in set(batch_sizes)))
            max_batch = self.tiles[-1]
        else:
            self.tiles = (int(max_batch),)
        self.model = model
        self.max_batch = int(max_batch)
        self.batch_timeout_s = float(batch_timeout_s)
        self.stats = EngineStats()
        self._cuda = model.device.type == "cuda"
        self._stream = torch.cuda.Stream(model.device) if self._cuda \
            else None
        self._forwards: dict[tuple, _TileForward] = {}
        self._queue: queue.Queue[_Request | None] = queue.Queue()
        self._pending: _Request | None = None  # overflow carry between steps
        self._stopping = False  # shutdown sentinel seen; flush then exit
        # dispatched-but-unread steps; bounded so the scheduler can batch
        # ahead of the device without running away
        self._done: queue.Queue = queue.Queue(maxsize=max_inflight)
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._collector = threading.Thread(target=self._collect, daemon=True)
        self._thread.start()
        self._collector.start()

    # -- client API ----------------------------------------------------------
    def submit(self, x) -> Future:
        """Enqueue a request batch [n, ...]; returns a Future of np.ndarray."""
        if not self._running:
            raise RuntimeError("engine is shut down")
        arr = np.asarray(x, dtype=np.float32)
        if arr.shape[0] > self.max_batch:
            raise ValueError(
                f"request batch {arr.shape[0]} > max_batch {self.max_batch}; "
                "split the request")
        req = _Request(arr)
        self.stats.requests += 1
        self._queue.put(req)
        return req.future

    def infer(self, x) -> np.ndarray:
        """Synchronous convenience wrapper."""
        return self.submit(x).result()

    def shutdown(self, wait: bool = True) -> None:
        self._running = False
        self._queue.put(None)
        if wait:
            self._thread.join()
            self._done.put(None)
            self._collector.join()
        else:
            self._done.put(None)

    # -- scheduler -----------------------------------------------------------
    def _take_batch(self) -> list[_Request] | None:
        """Collect up to max_batch rows; None on shutdown."""
        if self._stopping and self._pending is None and self._queue.empty():
            return None
        reqs: list[_Request] = []
        rows = 0
        if self._pending is not None:
            reqs.append(self._pending)
            rows = self._pending.n
            self._pending = None
        deadline = None
        while True:
            timeout = None
            if reqs or self._stopping:
                if deadline is None:
                    deadline = time.monotonic() + self.batch_timeout_s
                timeout = max(0.0, deadline - time.monotonic())
            try:
                req = self._queue.get(timeout=timeout)
            except queue.Empty:
                return reqs if reqs else (None if self._stopping else [])
            if req is None:
                # shutdown sentinel: flush what is coalesced, then drain
                self._stopping = True
                return reqs if reqs else None
            if rows + req.n > self.max_batch:
                self._pending = req
                return reqs
            reqs.append(req)
            rows += req.n

    def _loop(self) -> None:
        """Scheduler: coalesce -> pad -> dispatch.  Results are read in the
        collector thread, so the next batch is assembled and queued while
        the card runs the current one."""
        try:
            with torch.no_grad(), (torch.cuda.stream(self._stream)
                                   if self._cuda
                                   else contextlib.nullcontext()):
                while True:
                    reqs = self._take_batch()
                    if reqs is None:
                        return
                    if not reqs:
                        continue
                    try:
                        self._dispatch(reqs)
                    except Exception as e:  # propagate to all waiters
                        for r in reqs:
                            self._resolve(r, exc=e)
        finally:
            # a submit() racing shutdown() can enqueue after the sentinel;
            # fail anything left so no future hangs forever
            while True:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                if req is not None:
                    self._resolve(req, exc=RuntimeError(
                        "engine shut down before this request was "
                        "scheduled"))

    def _dispatch(self, reqs: list[_Request]) -> None:
        reqs = [r for r in reqs if not r.future.cancelled()]
        if not reqs:
            return
        rows = sum(r.n for r in reqs)
        tile = next(t for t in self.tiles if t >= rows)
        pad = tile - rows
        shape = (tile,) + reqs[0].data.shape[1:]
        if any(r.data.shape[1:] != shape[1:] for r in reqs):
            raise ValueError(f"requests of shapes "
                             f"{[r.data.shape[1:] for r in reqs]} cannot "
                             f"share a batch")
        if not self._cuda:
            batch = np.concatenate([r.data for r in reqs]
                                   + [np.zeros((pad,) + shape[1:],
                                               np.float32)])
            if self._ingest is None:
                t = Tensor(torch.from_numpy(batch))
            else:
                scale, zp, tag = self._ingest
                t = wrap_quantized(native.quantize_u8(batch, scale, zp),
                                   scale, zp, tag, device="cpu")
            out = self.model(t).logical_data
            result = lambda: out[:rows].numpy()          # noqa: E731
        else:
            key = (shape, self._ingest)
            fwd = self._forwards.get(key)
            if fwd is None:
                fwd = self._forwards[key] = _TileForward(
                    self.model, shape, self._stream, self._ingest)
            out = fwd(reqs, rows)
            host = torch.empty((rows,) + tuple(out.shape[1:]),
                               dtype=out.dtype, pin_memory=True)
            host.copy_(out[:rows], non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._stream)

            def result():
                ready.synchronize()
                return host.numpy()
        self.stats.steps += 1
        self.stats.images += rows
        self.stats.padded_rows += pad
        self._done.put((reqs, result))   # bounded: applies backpressure

    @staticmethod
    def _resolve(req: _Request, result=None, exc=None) -> bool:
        """Set a request's outcome; a caller may have cancel()ed the future
        (allowed any time before set_result since it is never marked
        running), and set_result on a cancelled future raises
        InvalidStateError, which must not kill the collector thread."""
        try:
            if exc is not None:
                if not req.future.done():
                    req.future.set_exception(exc)
                    return True
            elif not req.future.cancelled():
                req.future.set_result(result)
                return True
        except Exception:   # lost the cancel race; result is dropped
            pass
        return False

    def _collect(self) -> None:
        while True:
            item = self._done.get()
            if item is None:
                return
            reqs, result = item
            try:
                result = result()   # waits for the card
            except Exception as e:
                for r in reqs:
                    self._resolve(r, exc=e)
                continue
            off = 0
            t_done = time.monotonic()
            for r in reqs:
                if self._resolve(r, result=result[off:off + r.n]):
                    self.stats.record_latency(t_done - r.t_submit)
                off += r.n
