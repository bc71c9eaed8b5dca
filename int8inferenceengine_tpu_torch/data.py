"""Prefetching data loader: host preprocessing overlapped with the card's
work (counterpart of ``int8inferenceengine_tpu.data``).

A background thread preprocesses the next batches natively
(``native/hostops.cc``) and copies them to the card while the consumer runs
the current one.

Two modes:

* float mode (default): yields float32 NCHW Tensors, for any model;
* quantized ingest (``quantize_to=(scale, zp)``): preprocessing and input
  quantization run on the host in one native pass, the card receives u8
  (a quarter of the bytes), and the yields are quantized Tensors that a
  converted model takes at their own (scale, zp).  With ``layout_for=model``
  the host also applies the first conv's zp-pad and space-to-depth
  (``Module.ingest_descriptor``), and the card's forward starts at a
  stride-1 conv.

On the card, the producer stages each batch in a pinned host buffer and
copies it with ``non_blocking=True`` on a side stream; it records an event
that the consumer's stream waits on before it uses the batch, and refills a
pinned buffer only after that buffer's copy has completed.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from . import native
from .tensor import Tensor, resolve_device

_STOP = object()


def prelayout(q_nchw_u8: np.ndarray, zero_point, ingest) -> np.ndarray:
    """A host-quantized u8 NCHW batch with the first-conv pre-layout of
    ``ingest`` (a ``Conv2d.ingest_descriptor`` tag) applied, or as it is
    when ``ingest`` is None."""
    if ingest is None:
        return q_nchw_u8
    _, k, s, p, _c = ingest
    return native.s2d_quantized(q_nchw_u8, k, s, p, int(zero_point))


def wrap_quantized(q_nchw_u8: np.ndarray, scale, zero_point, ingest=None,
                   device=None) -> Tensor:
    """A host-quantized u8 NCHW batch as a quantized Tensor on ``device``
    (the card unless it is ``"cpu"``), pre-laid-out for ``ingest`` when it
    is set: the one place the host-ingest contract lives, used by the
    DataLoader and the serving engine."""
    q = prelayout(q_nchw_u8, zero_point, ingest)
    data = torch.from_numpy(np.ascontiguousarray(q)).to(
        resolve_device(device))
    return Tensor(data, float(scale), int(zero_point), _ingest=ingest)


class DataLoader:
    """Iterate batches of a host array as Tensors on ``device``.

    Parameters
    ----------
    images : np.ndarray — either f32 NCHW (ready) or u8 NHWC (raw images,
        requires ``mean``/``std`` for preprocessing).
    batch_size : rows per yielded batch (the last one is yielded short, or
        dropped under ``drop_remainder``).
    labels : optional array; each batch is then ``(tensor, labels[rows])``.
    mean, std : per-channel normalization for u8 NHWC input.
    resize_to : optional (H, W) bilinear resize for u8 NHWC input (the
        AlexNet notebook's 32 -> 224 step).
    quantize_to : optional (scale, zero_point) — host-side input quantization.
    prefetch : max batches in flight ahead of the consumer.
    layout_for : a model (or its first Conv2d) whose first conv's pre-layout
        the host applies (needs ``quantize_to``; nothing when the conv does
        not qualify).
    device : where the batches go: the card unless it is ``"cpu"``.
    """

    def __init__(self, images, batch_size: int, *, labels=None, mean=None,
                 std=None, resize_to=None, quantize_to=None, prefetch: int = 2,
                 drop_remainder: bool = False, layout_for=None, device=None):
        self.images = images
        self.labels = labels
        self.batch_size = int(batch_size)
        self.mean = None if mean is None else np.asarray(mean, np.float32)
        self.std = None if std is None else np.asarray(std, np.float32)
        self.resize_to = resize_to
        self.quantize_to = quantize_to
        self.prefetch = int(prefetch)
        self.drop_remainder = drop_remainder
        self.device = resolve_device(device)
        if images.dtype == np.uint8 and (self.mean is None or self.std is None):
            raise ValueError("u8 NHWC input requires mean/std")
        if resize_to is not None and images.dtype != np.uint8:
            raise ValueError("resize_to only applies to u8 NHWC image input")
        self.ingest = None
        if layout_for is not None:
            if quantize_to is None:
                raise ValueError("layout_for requires quantize_to")
            self.ingest = layout_for.ingest_descriptor()

    def __len__(self):
        n = self.images.shape[0]
        return n // self.batch_size if self.drop_remainder else -(-n // self.batch_size)

    def prepare(self, chunk: np.ndarray) -> np.ndarray:
        """One batch's host work: a fresh u8 (quantized, maybe pre-laid-out)
        or float32 NCHW array."""
        if chunk.dtype == np.uint8:
            if self.resize_to is not None:
                chunk = native.resize_bilinear(chunk, *self.resize_to)
            if self.quantize_to is not None:
                s, zp = self.quantize_to
                return prelayout(native.preprocess_quantize(
                    chunk, self.mean, self.std, float(s), int(zp)), zp,
                    self.ingest)
            return native.normalize_nchw(chunk, self.mean, self.std)
        if self.quantize_to is not None:
            s, zp = self.quantize_to
            return prelayout(native.quantize_u8(chunk, float(s), int(zp)),
                             zp, self.ingest)
        return np.array(chunk, dtype=np.float32)

    def _tensor(self, data: torch.Tensor) -> Tensor:
        if self.quantize_to is None:
            return Tensor(data)
        s, zp = self.quantize_to
        return Tensor(data, float(s), int(zp), _ingest=self.ingest)

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        err: list[BaseException] = []
        stop = threading.Event()   # set when the consumer abandons iteration
        card = self.device.type == "cuda"

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            # on the card: pinned buffers taking turns, each with the event
            # of its last copy, and the side stream the copies run on
            ring = [[None, None] for _ in range(self.prefetch + 2)]
            side = torch.cuda.Stream(self.device) if card else None
            try:
                n = self.images.shape[0]
                for turn, i in enumerate(range(0, n, self.batch_size)):
                    if stop.is_set():
                        return
                    chunk = self.images[i:i + self.batch_size]
                    if self.drop_remainder and chunk.shape[0] < self.batch_size:
                        break
                    host = torch.from_numpy(self.prepare(chunk))
                    ready = None
                    if not card:
                        data = host
                    else:
                        data, ready = self._copy(host, ring[turn % len(ring)],
                                                 side)
                    item = (self._tensor(data), ready)
                    if self.labels is not None:
                        item += (self.labels[i:i + chunk.shape[0]],)
                    if not _put(item):
                        return
            except BaseException as e:  # surface in consumer
                err.append(e)
            finally:
                for slot in ring:        # no copy still reads a buffer
                    if slot[1] is not None:
                        slot[1].synchronize()
                ring.clear()
                _put(_STOP)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is _STOP:
                    if err:
                        raise err[0]
                    return
                t, ready = item[0], item[1]
                if ready is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(ready)
                    t.data.record_stream(stream)
                yield t if self.labels is None else (t, item[2])
        finally:
            stop.set()   # unblock the producer if iteration stopped early

    def _copy(self, host: torch.Tensor, slot: list, side) -> tuple:
        """Stage ``host`` in the slot's pinned buffer (once its last copy
        has completed) and copy it to the card on ``side``; returns the card
        tensor and the copy's event."""
        buf, done = slot
        if done is not None:
            done.synchronize()
        if buf is None or buf.numel() < host.numel() or buf.dtype != host.dtype:
            buf = torch.empty(host.numel(), dtype=host.dtype, pin_memory=True)
        staged = buf[:host.numel()].view(host.shape)
        staged.copy_(host)
        with torch.cuda.stream(side):
            data = torch.empty(host.shape, dtype=host.dtype,
                               device=self.device)
            data.copy_(staged, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        slot[0], slot[1] = buf, done
        return data, done
