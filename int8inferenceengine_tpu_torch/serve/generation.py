"""GenerationEngine: continuous batching for INT8 autoregressive decoding
(counterpart of ``int8inferenceengine_tpu.serve.generation``).

A fixed number of slots share one decode program, each slot at its own
sequence position over its own rows of the shared u8 KV cache.  Requests
stream in and out of slots:

* **One decode chunk program per variant.**  ``_decode_step`` takes
  per-slot positions; a chunk is ``chunk_steps`` of them with per-slot
  active/remaining/eos gates (``act``, ``rem``, ``eosv``).  On the card a
  variant's first chunk runs eagerly and is captured after it as a CUDA
  graph (``graphs.capture``), which every later chunk replays: the port's
  counterpart of the JAX package's jitted ``lax.scan``.  The greedy variant
  carries no sampling work; the sampled one adds the per-slot draw, and
  top-p/top-k variants add the histogram (``models.text_decoder.pick_u8``).
* **Multi-chunk syncs.**  With nothing queued, ``sync_chunks`` chunks run
  back to back with no host read in between; the on-device ``rem`` and eos
  gates stop each slot exactly where the host would drop its tokens.  The
  JAX package's ``while_loop`` exits as soon as every slot drains; the port
  always runs all ``sync_chunks`` chunks (a graph has no data-dependent
  exit), and ``stats.chunks`` counts every chunk run, so
  ``mean_slot_fill`` includes the drained ones.
* **Bucketed, batched prefill**, eager: prompts right-padded to a
  power-of-two bucket (the causal mask keeps the padding out), admissions
  grouped by bucket and split into power-of-two groups, each group's cache
  rows scattered into its slots.
* **Exactness.**  Slots are batch rows, every layer is row-independent and
  dead cache rows add exactly zero, so a greedy request's tokens equal
  ``model.generate()`` of its prompt alone.
* **Sampling** per request (``temperature``, ``seed``, ``top_p``,
  ``top_k``): the draw is keyed by (seed, position), with no per-slot state
  beyond the seed; a request sampled here with seed s gives the tokens of
  ``generate(prompt[None], ..., seed=s)`` (row 0's stream).
* ``eos_id`` (engine default or per request; never negative: -1 marks "no
  eos" on the device) and multi-token ``stop`` sequences (host-side).
* ``overlap=True`` dispatches chunk k+1 before reading chunk k's tokens;
  each chunk's tokens leave the static output buffer through a
  stream-ordered copy into pinned host memory.

Not ported, each refused with ``NotImplementedError``: chunked prefill
(``prefill_chunk``) and the prefix cache (``register_prefix``,
``prefix_id``), which need the multi-token ``_extend_step``; ring-cache
models; weight-only models (the float head-split cache); meshes.
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

from .. import graphs
from ..models.text_decoder import fold_seed
from ..tensor import Tensor

__all__ = ["GenerationEngine", "GenerationStats"]


@dataclasses.dataclass
class GenerationStats:
    requests: int = 0          # completed requests
    tokens: int = 0            # tokens delivered (prefill + decode)
    prefills: int = 0
    chunks: int = 0            # decode chunks run on the device
    chunk_slots_active: int = 0   # sum of active slots across chunks
    prefix_hits: int = 0       # always 0: the prefix cache is not ported
    latencies_s: list = dataclasses.field(default_factory=list)

    @property
    def mean_slot_fill(self) -> float:
        """Average number of slots doing useful work per chunk."""
        return (self.chunk_slots_active / self.chunks if self.chunks
                else 0.0)

    def latency_percentiles(self, ps=(50, 90, 99)) -> dict:
        if not self.latencies_s:
            return {f"p{p}": float("nan") for p in ps}
        arr = np.asarray(self.latencies_s)
        return {f"p{p}": float(np.percentile(arr, p) * 1e3) for p in ps}


class _GenRequest:
    __slots__ = ("prompt", "max_new", "future", "tokens", "t_submit",
                 "temperature", "seed", "top_p", "top_k", "eos_id",
                 "stream_q", "stop")

    def __init__(self, prompt: np.ndarray, max_new: int,
                 temperature: float = 0.0, seed: int = 0,
                 top_p: float = 1.0, top_k: int = 0,
                 eos_id: int | None = None):
        self.prompt = prompt
        self.max_new = max_new
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.top_p = float(top_p)
        self.top_k = int(top_k)            # 0 = off
        self.eos_id = eos_id               # None = no eos
        self.stream_q = None               # set by submit_stream
        self.stop = ()                     # multi-token stop sequences
        self.future: Future = Future()
        self.tokens: list[int] = []
        self.t_submit = time.perf_counter()


def _bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _unported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not implemented by the PyTorch port's GenerationEngine "
        f"yet (ROADMAP.md queue 1, {item})")


def _check_eos(eos_id) -> None:
    if eos_id is not None and int(eos_id) < 0:
        raise ValueError(
            f"eos_id must be >= 0, got {eos_id} (-1 marks 'no eos' on the "
            f"device)")


class GenerationEngine:
    """Continuous-batching decoding over a converted TextDecoder (or
    LlamaDecoder).

    >>> eng = GenerationEngine(model, slots=4)
    >>> fut = eng.submit([5, 17, 99], max_new_tokens=32)
    >>> fut.result()                       # np.ndarray of generated ids
    """

    def __init__(self, model, slots: int = 8, chunk_steps: int = 32,
                 eos_id: int | None = None, overlap: bool = False,
                 sync_chunks: int = 4, prefill_chunk: int | None = None):
        if not model.is_quant:
            raise RuntimeError("GenerationEngine requires a converted model")
        if getattr(model, "_mesh", None) is not None:
            raise _unported("serving a sharded model", "item 10")
        if model.config.weight_only:
            raise _unported("weight-only serving (the float head-split KV "
                            "cache)", "item 3")
        if getattr(model, "ring_cache", False):
            raise _unported("ring-cache serving", "item 2")
        if prefill_chunk is not None:
            raise _unported("chunked prefill (prefill_chunk), which needs "
                            "_extend_step", "item 2")
        _check_eos(eos_id)
        self.model = model
        self.slots = int(slots)
        self.chunk_steps = int(chunk_steps)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.overlap = bool(overlap)
        self.sync_chunks = max(1, int(sync_chunks))
        dev = self.device = model.device
        self._cuda = dev.type == "cuda"
        shape = (self.slots, model.max_len, model.kv_heads * model.head_dim)
        self._caches = {
            i: (torch.zeros(shape, dtype=torch.uint8, device=dev),
                torch.zeros(shape, dtype=torch.uint8, device=dev))
            for i in range(1, model.depth + 1)}

        def zeros(dtype, fill=0):
            return torch.full((self.slots,), fill, dtype=dtype, device=dev)

        self._pos = zeros(torch.int64)
        self._tok = zeros(torch.int64)
        self._act = zeros(torch.bool)
        self._rem = zeros(torch.int64)
        self._temp = zeros(torch.float32)         # 0 = greedy
        self._seed = zeros(torch.int64)
        self._topp = zeros(torch.float32, 1.0)    # 1 = no nucleus
        self._topk = zeros(torch.int64)           # 0 = no top-k
        self._eos = zeros(torch.int64, -1)        # -1 = none
        self._out = torch.zeros((self.slots,
                                 self.sync_chunks * self.chunk_steps),
                                dtype=torch.int64, device=dev)
        self._col = torch.zeros((1,), dtype=torch.int64, device=dev)
        self._work = torch.zeros((1,), dtype=torch.int64, device=dev)
        self._stream = torch.cuda.Stream(dev) if self._cuda else None
        self._queue: queue.Queue[_GenRequest | None] = queue.Queue()
        self._active = [None] * self.slots  # slot -> _GenRequest | None
        self.stats = GenerationStats()
        self._chunk_fns: dict[tuple, graphs.Captured] = {}
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- public API -----------------------------------------------------------
    def register_prefix(self, tokens) -> int:
        raise _unported("the prefix cache (register_prefix), which needs "
                        "_extend_step", "item 2")

    def _build_request(self, prompt, max_new_tokens: int,
                       temperature: float = 0.0, seed: int = 0,
                       top_p: float = 1.0, top_k: int | None = None,
                       prefix_id: int | None = None,
                       eos_id: int | None = None,
                       stop=None) -> _GenRequest:
        if not self._running:
            raise RuntimeError("engine is shut down")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if prefix_id is not None:
            raise _unported("the prefix cache (prefix_id), which needs "
                            "_extend_step", "item 2")
        if temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if top_k is not None and top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        _check_eos(eos_id)
        if len(prompt) + max_new_tokens > self.model.max_len:
            raise ValueError(
                f"prompt {len(prompt)} + max_new {max_new_tokens} exceeds "
                f"max_len {self.model.max_len}")
        req = _GenRequest(
            prompt, max_new_tokens, temperature, seed,
            top_p, 0 if top_k is None else int(top_k),
            self.eos_id if eos_id is None else int(eos_id))
        if stop:
            # multi-token stop sequences are matched on the host, like
            # max_new; the matched sequence is part of the output
            seqs = []
            for sq in stop:
                sq = [int(t) for t in np.asarray(sq).reshape(-1)]
                if not sq:
                    raise ValueError("empty stop sequence")
                seqs.append(tuple(sq))
            req.stop = tuple(seqs)
        return req

    def submit(self, prompt, max_new_tokens: int, **kw) -> Future:
        """Queue a request; the Future resolves to the generated ids
        (int32).  Per-request: ``temperature``/``seed``, ``top_p``,
        ``top_k``, ``eos_id`` (overrides the engine's) and ``stop`` (a list
        of token sequences; a match ends the output after it)."""
        req = self._build_request(prompt, max_new_tokens, **kw)
        self._queue.put(req)
        return req.future

    def submit_stream(self, prompt, max_new_tokens: int, **kw):
        """Like :meth:`submit`, but returns an iterator over the generated
        ids as the engine produces them (in bursts of up to a chunk).  It
        raises where the request fails and ends after the last token."""
        req = self._build_request(prompt, max_new_tokens, **kw)
        req.stream_q = queue.Queue()
        self._queue.put(req)

        def _iter():
            while True:
                t = req.stream_q.get()
                if t is None:
                    break
                yield t
            req.future.result()      # surface failures / cancellation

        return _iter()

    def generate(self, prompt, max_new_tokens: int) -> np.ndarray:
        return self.submit(prompt, max_new_tokens).result()

    def shutdown(self, wait: bool = True) -> None:
        self._running = False
        self._queue.put(None)
        if wait:
            self._thread.join()

    # -- device programs -------------------------------------------------------
    def _h2d(self, arr, dtype) -> torch.Tensor:
        """A small host array on the device, copied in stream order from
        pinned memory (the caching host allocator keeps the pinned block
        until the copy has run)."""
        t = torch.as_tensor(np.asarray(arr), dtype=dtype)
        if not self._cuda:
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _prefill_into(self, slots, prompts_pad, t0s, temps, seeds, topps,
                      topks, sampled: bool, use_topp: bool, use_topk: bool):
        """Batched prefill of the right-padded prompts [n, bucket] in one
        forward (eager; a graph per (bucket, n) is later work): the rows
        scatter into the slots' caches, and each prompt's first token is
        picked from its row ``t0 - 1``."""
        m = self.model
        codes, cache1 = m._prefill(Tensor(prompts_pad), last=t0s)
        for i, (k1, v1) in cache1.items():           # [n, max_len, C]
            self._caches[i][0].index_copy_(0, slots, k1)
            self._caches[i][1].index_copy_(0, slots, v1)
        if not sampled:
            return codes.argmax(-1)
        return m._pick(codes, temps, seeds, t0s - 1,
                       topps if use_topp else None,
                       topks if use_topk else None)

    def _chunk_body(self, sampled: bool, use_topp: bool, use_topk: bool):
        """``chunk_steps`` decode steps over every slot, in place on the
        static buffers: the token of an inactive slot stays, a slot stops
        (its position frozen) once its remaining count reaches 0 or it
        emits its eos, and step j's tokens land in column ``_col + j`` of
        ``_out``.  ``_work`` adds the slots active at the chunk's start."""
        m = self.model

        def body():
            self._work.add_(self._act.sum())
            for _ in range(self.chunk_steps):
                codes, _ = m._decode_step(self._caches, self._pos, self._tok)
                if sampled:
                    nxt = m._pick(codes, self._temp, self._seed, self._pos,
                                  self._topp if use_topp else None,
                                  self._topk if use_topk else None)
                else:
                    nxt = codes.argmax(-1)
                act = self._act
                nxt = torch.where(act, nxt, self._tok)
                self._rem.copy_(torch.where(act, self._rem - 1, self._rem))
                act = act & (self._rem > 0) & (nxt != self._eos)
                self._pos.copy_(torch.where(act, self._pos + 1, self._pos))
                self._act.copy_(act)
                self._tok.copy_(nxt)
                self._out.index_copy_(1, self._col, nxt[:, None])
                self._col.add_(1)

        return body

    def _chunk(self, sampled: bool, use_topp: bool = False,
               use_topk: bool = False):
        """The decode-chunk program of this variant, built at the first
        request that needs it: on the card its first call runs eagerly
        (the warm-up) and captures it, later calls replay the graph."""
        key = (sampled, use_topp, use_topk)
        fn = self._chunk_fns.get(key)
        if fn is None:
            fn = self._chunk_fns[key] = graphs.Captured(
                self._chunk_body(*key), self._stream)
        return fn

    def _fetch_async(self, ncols: int):
        """Start copying the first ``ncols`` token columns and the work
        counter to the host; returns a function that waits for the copy
        and gives (tokens [slots, ncols] int64, work)."""
        if not self._cuda:
            toks, work = self._out[:, :ncols].clone(), self._work.clone()
            return lambda: (toks.numpy(), int(work[0]))
        toks = torch.empty((self.slots, ncols), dtype=torch.int64,
                           pin_memory=True)
        work = torch.empty((1,), dtype=torch.int64, pin_memory=True)
        toks.copy_(self._out[:, :ncols], non_blocking=True)
        work.copy_(self._work, non_blocking=True)
        done = torch.cuda.Event()
        done.record(self._stream)

        def wait():
            done.synchronize()
            return toks.numpy(), int(work[0])

        return wait

    # -- scheduler -------------------------------------------------------------
    def _admit_batch(self, pairs) -> None:
        """Prefill a burst of admissions in as few calls as possible: group
        by prompt bucket, split groups into power-of-two sizes, one batched
        prefill (and one host sync) per sub-group."""
        by_bucket: dict[int, list] = {}
        for slot, req in pairs:
            # power-of-two bucket, capped at max_len
            bucket = min(_bucket(len(req.prompt)), self.model.max_len)
            by_bucket.setdefault(bucket, []).append((slot, req))
        for bucket, group in sorted(by_bucket.items()):
            while group:
                n = 1 << (len(group).bit_length() - 1)  # pow2 <= len
                part, group = group[:n], group[n:]
                self._admit_group(bucket, part)

    def _admit_group(self, bucket: int, part) -> None:
        n = len(part)
        pad = np.zeros((n, bucket), np.int64)
        t0s = np.zeros((n,), np.int64)
        slots = np.zeros((n,), np.int64)
        for j, (slot, req) in enumerate(part):
            t0s[j] = len(req.prompt)
            pad[j, :t0s[j]] = req.prompt
            slots[j] = slot
            # register BEFORE the device work: if prefill raises, the crash
            # handler must fail these requests' futures too
            self._active[slot] = req
        reqs = [req for _, req in part]
        temps = self._h2d([r.temperature for r in reqs], torch.float32)
        topps = self._h2d([r.top_p for r in reqs], torch.float32)
        topks = self._h2d([r.top_k for r in reqs], torch.int64)
        seeds = self._h2d([fold_seed(r.seed) for r in reqs], torch.int64)
        eos = self._h2d([-1 if r.eos_id is None else r.eos_id
                         for r in reqs], torch.int64)
        slots_d = self._h2d(slots, torch.int64)
        t0s_d = self._h2d(t0s, torch.int64)
        for buf, val in ((self._temp, temps), (self._topp, topps),
                         (self._topk, topks), (self._seed, seeds),
                         (self._eos, eos)):
            buf.index_copy_(0, slots_d, val)
        use_topp = any(r.top_p < 1.0 for r in reqs)
        use_topk = any(r.top_k > 0 for r in reqs)
        sampled = any(r.temperature > 0 for r in reqs)
        toks_d = self._prefill_into(
            slots_d, self._h2d(pad, torch.int64), t0s_d, temps, seeds,
            topps, topks, sampled, use_topp, use_topk)
        self._tok.index_copy_(0, slots_d, toks_d)
        self._pos.index_copy_(0, slots_d, t0s_d)
        toks = toks_d.cpu().numpy()
        self.stats.prefills += n
        for j, (slot, req) in enumerate(part):
            tok0 = int(toks[j])
            req.tokens.append(tok0)
            self._stream_push(req, tok0)
            if self._done(req, tok0):
                self._finish(slot)

    @staticmethod
    def _stream_push(req: _GenRequest, tok: int) -> None:
        if req.stream_q is not None and len(req.tokens) <= req.max_new:
            req.stream_q.put(tok)

    @staticmethod
    def _stream_close(req: _GenRequest) -> None:
        if req.stream_q is not None:
            req.stream_q.put(None)

    def _done(self, req: _GenRequest, tok: int) -> bool:
        if (len(req.tokens) >= req.max_new
                or (req.eos_id is not None and tok == req.eos_id)):
            return True
        if req.stop:
            t = req.tokens
            for sq in req.stop:
                n = len(sq)
                if len(t) >= n and tuple(t[-n:]) == sq:
                    return True
        return False

    def _finish(self, slot: int) -> None:
        # a freed slot's sampling and eos vectors stay: it decodes inactive
        # (its tokens dropped) until an admission overwrites them
        req = self._active[slot]
        self._active[slot] = None
        self.stats.requests += 1
        self.stats.tokens += min(len(req.tokens), req.max_new)
        if len(self.stats.latencies_s) < 10_000:
            self.stats.latencies_s.append(
                time.perf_counter() - req.t_submit)
        req.future.set_result(np.asarray(req.tokens[:req.max_new],
                                         np.int32))
        self._stream_close(req)

    def _loop(self) -> None:
        try:
            with torch.no_grad(), (torch.cuda.stream(self._stream)
                                   if self._cuda
                                   else contextlib.nullcontext()):
                self._loop_inner()
        except BaseException as e:          # fail pending futures, loudly
            # the engine is dead: later submit()s must raise instead of
            # enqueueing futures nothing will ever resolve
            self._running = False
            for s, req in enumerate(self._active):
                if req is not None and not req.future.done():
                    req.future.set_exception(e)
                if req is not None:
                    self._stream_close(req)
                self._active[s] = None
            while True:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                if req is not None and not req.future.done():
                    req.future.set_exception(e)
                    self._stream_close(req)
            raise

    def _loop_inner(self) -> None:
        try:
            self._drain_loop()
        finally:
            # shutdown: fail anything still queued — a request that will
            # never run must not leave its future pending forever
            while True:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                if req is not None and not req.future.done():
                    req.future.set_exception(
                        RuntimeError("engine shut down before this "
                                     "request was scheduled"))
                    self._stream_close(req)

    def _drain_loop(self) -> None:
        # overlap=True: ``pending`` holds the dispatched-but-unread chunk —
        # (its token fetch, the [(slot, req)] snapshot it decoded for).  By
        # fetch time a slot may already hold a different request.
        pending = None
        while (self._running or pending is not None
               or any(r is not None for r in self._active)):
            admits, taken = [], set()
            while self._running:
                slot = next((s for s, r in enumerate(self._active)
                             if r is None and s not in taken), None)
                if slot is None:
                    break
                idle = (not admits and pending is None
                        and all(r is None for r in self._active))
                try:
                    req = (self._queue.get(timeout=0.1) if idle
                           else self._queue.get_nowait())
                except queue.Empty:
                    break
                if req is None:          # shutdown: drain active slots
                    self._running = False
                    break
                admits.append((slot, req))
                taken.add(slot)
            if admits:
                self._admit_batch(admits)
            if any(r is not None for r in self._active):
                snapshot = list(self._active)
                n_act = sum(r is not None for r in snapshot)
                sampled = any(r is not None and r.temperature > 0
                              for r in snapshot)
                use_topp = any(r is not None and r.top_p < 1.0
                               for r in snapshot)
                use_topk = any(r is not None and r.top_k > 0
                               for r in snapshot)
                rem = np.zeros((self.slots,), np.int64)
                for s, r in enumerate(snapshot):
                    if r is not None:
                        rem[s] = max(1, r.max_new - len(r.tokens))
                self._act.copy_(self._h2d(rem > 0, torch.bool))
                self._rem.copy_(self._h2d(rem, torch.int64))
                self._col.zero_()
                self._work.zero_()
                chunk = self._chunk(sampled, use_topp, use_topk)
                # with nothing queued no slot can be refilled: run
                # sync_chunks chunks back to back before reading tokens
                # back (the JAX package's multi-chunk while_loop, without
                # its early exit)
                if (self.sync_chunks > 1 and pending is None
                        and self._queue.empty()):
                    for _ in range(self.sync_chunks):
                        chunk()
                    wait = self._fetch_async(self.sync_chunks
                                             * self.chunk_steps)
                    self.stats.chunks += self.sync_chunks
                    fetch = (wait, snapshot, True)
                else:
                    chunk()
                    wait = self._fetch_async(self.chunk_steps)
                    self.stats.chunks += 1
                    self.stats.chunk_slots_active += n_act
                    if self.overlap:
                        pending, fetch = (wait, snapshot, False), pending
                    else:
                        fetch = (wait, snapshot, False)
            else:
                fetch, pending = pending, None
            if fetch is None:
                continue
            wait, snapshot, multi = fetch
            toks, work = wait()                  # [slots, columns]
            if multi:
                # on-device per-chunk live-slot counts: slots drain mid-way
                self.stats.chunk_slots_active += work
            for s, req in enumerate(snapshot):
                # only requests still in their slot: _finish may have freed
                # it since this chunk was dispatched
                if req is None or self._active[s] is not req:
                    continue
                for t in toks[s]:
                    req.tokens.append(int(t))
                    self._stream_push(req, int(t))
                    if self._done(req, int(t)):
                        self._finish(s)
                        break

