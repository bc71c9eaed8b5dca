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
* **Chunked prefill** (``prefill_chunk=P``): a prompt longer than P, and
  every prefixed request, prefills one slot through fixed [1, P] chunks of
  the cached multi-token ``_extend_step``: one program per engine (on the
  card captured after its first chunk) copies the slot's rows into a
  one-row scratch cache by a device slot index, extends it and writes it
  back, so one graph serves every slot and every prompt length.  The last
  chunk slides back to end at ``max_len``; the rows it repeats are written
  again with the same codes.
* **Prefix cache** (``register_prefix``, ``submit(prefix_id=)``,
  ``unregister_prefix``; at most ``max_prefixes``): a registered prefix's
  KV rows are computed once, by the same chunked extend on a private
  scratch cache, and a prefixed request seeds them into its slot (all
  layers in one copy) and prefills only its suffix.  A position's cached
  codes depend only on the tokens up to it, so a prefixed request gives
  the tokens of the same prompt submitted cold.
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
* **Ring caches** (a ``ring_cache`` model: mistral, gemma-2's local
  blocks): a windowed layer's slot caches hold roundup32(2W) rows, its own
  buffer per layer.  Each slot's ring base follows its own position inside
  the captured chunk: every step writes a ring layer's row twice
  (``TextDecoder._write_rows``), so no slot ever copies its window, and
  the bucketed prefill keeps each prompt's ring tail.  Chunked prefill and
  the prefix cache need full-length slot caches and are refused with a
  ring model (``ValueError``), as in the JAX package.
* **Weight-only models** (W8-float, ``dynamic_act``, W4): float slot
  caches [depth, 2, slots, Hkv, max_len, D], head-split like
  ``generate()``'s, float rows in the prefix table and the chunked
  prefill, per-request top-k by a float sort and top-p by
  ``nucleus_float_cutoff`` (``models.text_decoder.pick_float``).  As in
  the JAX package they keep full-length slot caches even for a
  ``ring_cache`` model.  Float sums depend on the shapes they are taken
  at, so a request's tokens follow ``generate()``'s within the float
  path's tolerance rather than bit for bit.

* **Sharded serving** (a ``shard()``ed decoder; JAX ``serve/generation.py``
  "Sharded serving").  Every rank builds the engine with the same
  arguments.  World rank 0 takes ``submit``/``submit_stream``/
  ``register_prefix``, decides every admission and completion, and
  broadcasts one control record before each step (``parallel/lockstep.py``);
  the other ranks apply the records in order, their ``submit()`` raises,
  and their ``shutdown()`` returns once rank 0's has drained.  Slots split
  over the data axis (``slots % data_size == 0``; data group d owns the
  slot rows [d * slots / data_size, (d + 1) * slots / data_size)), and the
  slot caches are head-sharded over the model axis where ``wk1``'s output
  stays a channel shard (head-local, as the model's ``tp_roles`` make it,
  or overlap mode: ``_kv_sharded``), channel-replicated otherwise (the MQA
  fallback).  Prompts are replicated over the data axis:
  every rank prefills every admission under its TP roles and keeps the
  rows of its own slots; a chunked admission of a slot that another group
  owns runs on a spare row (``_rows``) so that every rank computes the
  same first token.  After each chunk the ranks all-gather the slots'
  tokens over the data group and rank 0 applies eos, ``stop`` and the
  remaining counts.  Prefix registrations run on the engine's thread, in
  order with the chunks.  The draw stays keyed by (seed, position), so the
  sharded engine's sampled tokens equal the unsharded engine's.  Every
  program runs eagerly (gloo's collectives cannot be captured; a graph over
  NCCL is later work), and ``weight_only`` models are refused
  (``NotImplementedError``), as in the JAX package.  Until ``shutdown()``
  the engine's thread owns the model's process groups: call nothing else
  on the sharded model meanwhile, or the ranks' collectives pair up
  wrongly.
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
    chunks: int = 0            # decode chunks run on the device (every
    #                            rank of a sharded engine counts its own)
    chunk_slots_active: int = 0   # sum of active slots across chunks
    prefix_hits: int = 0       # admissions seeded from a registered prefix
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
                 "temperature", "seed", "top_p", "top_k", "prefix_id",
                 "eos_id", "stream_q", "stop", "prefix_entry")

    def __init__(self, prompt: np.ndarray, max_new: int,
                 temperature: float = 0.0, seed: int = 0,
                 top_p: float = 1.0, top_k: int = 0,
                 prefix_id: int | None = None,
                 eos_id: int | None = None):
        self.prompt = prompt
        self.max_new = max_new
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.top_p = float(top_p)
        self.top_k = int(top_k)            # 0 = off
        self.prefix_id = prefix_id
        self.eos_id = eos_id               # None = no eos
        self.stream_q = None               # set by submit_stream
        self.stop = ()                     # multi-token stop sequences
        self.prefix_entry = None           # (tokens, rows), at admission
        self.future: Future = Future()
        self.tokens: list[int] = []
        self.t_submit = time.perf_counter()

    def fields(self, slot: int) -> tuple:
        """What an admission's control record carries (a sharded engine's
        other ranks rebuild the request from it: ``_from_fields``)."""
        return (slot, self.prompt, self.max_new, self.temperature,
                self.seed, self.top_p, self.top_k, self.eos_id,
                self.prefix_id)


class _Registration:
    """A prefix registration queued for a sharded engine's thread."""
    __slots__ = ("tokens", "future")

    def __init__(self, tokens: np.ndarray):
        self.tokens = tokens
        self.future: Future = Future()


def _bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _check_eos(eos_id) -> None:
    if eos_id is not None and int(eos_id) < 0:
        raise ValueError(
            f"eos_id must be >= 0, got {eos_id} (-1 marks 'no eos' on the "
            f"device)")


class GenerationEngine:
    """Continuous-batching decoding over a converted TextDecoder (or
    LlamaDecoder), unsharded or ``shard()``ed (see the module docstring).

    >>> eng = GenerationEngine(model, slots=4)
    >>> fut = eng.submit([5, 17, 99], max_new_tokens=32)
    >>> fut.result()                       # np.ndarray of generated ids
    """

    # seed programs kept at once (one per prefix length), as the JAX
    # package bounds its compiled ones
    _SEED_FN_CAP = 8

    def __init__(self, model, slots: int = 8, chunk_steps: int = 32,
                 eos_id: int | None = None, overlap: bool = False,
                 sync_chunks: int = 4, prefill_chunk: int | None = None,
                 max_prefixes: int = 32):
        if not model.is_quant:
            raise RuntimeError("GenerationEngine requires a converted model")
        mesh = getattr(model, "_mesh", None)
        self._pa = self._ctl = None
        self._kv_sharded = False
        if mesh is not None:
            if model.config.weight_only:
                raise NotImplementedError(
                    "sharded serving runs the static-INT8 u8-cache path; "
                    "weight_only + shard() serving is unsupported (as in "
                    "the JAX package): use the static mode, or an "
                    "unsharded engine")
            from ..parallel.lockstep import Lockstep
            self._pa = model._parallel_axes
            if int(slots) % self._pa.data_size:
                raise ValueError(
                    f"slots {slots} must divide over the data axis "
                    f"({self._pa.data_size})")
            self._ctl = Lockstep(mesh)
            # head-local TP (or overlap mode) keeps the captured k/v, and
            # so the slot caches, a channel shard; the MQA fallback
            # gathers them
            wk = model.wk1
            self._kv_sharded = bool(wk._tp_sharded and (
                wk._tp_local or self._pa.overlap))
        # this rank takes requests and resolves them: the unsharded engine,
        # or world rank 0 of a sharded one
        self._host = self._ctl is None or self._ctl.leader
        if prefill_chunk is not None and not \
                1 <= int(prefill_chunk) <= model.max_len:
            raise ValueError(f"prefill_chunk must be in [1, max_len="
                             f"{model.max_len}], got {prefill_chunk}")
        # a weight-only ring model serves from full-length float caches,
        # as in the JAX package (its serving prefill has no float ring tail)
        self._float = bool(model.config.weight_only)
        self._ring_serving = (bool(getattr(model, "ring_cache", False))
                              and not self._float)
        if self._ring_serving and prefill_chunk is not None:
            raise ValueError(
                "prefill_chunk needs full-length slot caches; a ring_cache "
                "model serves through bucketed prefill: drop prefill_chunk, "
                "or build the model with ring_cache=False")
        _check_eos(eos_id)
        self.model = model
        self.slots = int(slots)
        self.chunk_steps = int(chunk_steps)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.overlap = bool(overlap)
        self.sync_chunks = max(1, int(sync_chunks))
        self.prefill_chunk = (None if prefill_chunk is None
                              else int(prefill_chunk))
        dev = self.device = model.device
        self._cuda = dev.type == "cuda"
        # this rank's slot rows [_row0, _row0 + _rows) of the global slots
        data = self._pa.data_size if self._pa else 1
        self._rows = self.slots // data
        self._row0 = self._pa.data_index * self._rows if self._pa else 0
        self._kv_channels = model.kv_heads * model.head_dim // (
            self._pa.model_size if self._kv_sharded else 1)
        if self._ring_serving:
            # per-layer rows: a ring layer's slot caches are its own
            self._kv = None
            self._caches = {i: tuple(
                torch.zeros((self._rows, model._cache_rows(i),
                             self._kv_channels),
                            dtype=torch.uint8, device=dev) for _ in range(2))
                for i in range(1, model.depth + 1)}
        else:
            # every layer's k and v slot caches are views of one buffer
            # [depth, 2, slots, max_len, C]: a prefix seeds all of them in
            # one copy.  A sharded chunked engine keeps one spare row past
            # its slots for the admissions of the other data groups
            spare = int(self._pa is not None and prefill_chunk is not None)
            self._kv = self._kv_buffer(self._rows + spare)
            self._caches = self._views(self._kv.narrow(2, 0, self._rows))

        def zeros(dtype, fill=0):
            return torch.full((self._rows,), fill, dtype=dtype, device=dev)

        self._pos = zeros(torch.int64)
        self._tok = zeros(torch.int64)
        self._act = zeros(torch.bool)
        self._rem = zeros(torch.int64)
        self._temp = zeros(torch.float32)         # 0 = greedy
        self._seed = zeros(torch.int64)
        self._topp = zeros(torch.float32, 1.0)    # 1 = no nucleus
        self._topk = zeros(torch.int64)           # 0 = no top-k
        self._eos = zeros(torch.int64, -1)        # -1 = none
        self._out = torch.zeros((self._rows,
                                 self.sync_chunks * self.chunk_steps),
                                dtype=torch.int64, device=dev)
        self._col = torch.zeros((1,), dtype=torch.int64, device=dev)
        self._work = torch.zeros((1,), dtype=torch.int64, device=dev)
        self._stream = torch.cuda.Stream(dev) if self._cuda else None
        # the programs' capture stream: none for a sharded engine, whose
        # collectives cannot be captured over gloo
        self._capture = None if self._pa else self._stream
        self._queue: queue.Queue[_GenRequest | None] = queue.Queue()
        self._active = [None] * self.slots  # slot -> _GenRequest | None
        self.stats = GenerationStats()
        self._chunk_fns: dict[tuple, graphs.Captured] = {}
        self._extend_program: graphs.Captured | None = None
        # the prefix table: registered rows stay on the device until
        # unregistered, so the table is bounded
        self.max_prefixes = int(max_prefixes)
        self._prefix_lock = threading.Lock()
        self._next_pid = 1
        self._prefixes: dict[int, tuple] = {}   # id -> (tokens, kv rows)
        self._seed_fns: dict[int, object] = {}  # prefix length -> seed
        # a sharded engine's control state on rank 0: registrations queued
        # for the engine's thread, prefixes dropped and slots freed since
        # the last record
        self._regs: queue.Queue[_Registration] = queue.Queue()
        self._unregs: list[int] = []
        self._freed: list[int] = []
        self._error: BaseException | None = None
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _kv_buffer(self, rows: int) -> torch.Tensor:
        """Every layer's k and v caches of ``rows`` slots in one buffer:
        [depth, 2, rows, max_len, C] u8 (C this rank's channels), or
        head-split [depth, 2, rows, Hkv, max_len, D] float32 for a
        weight-only model."""
        m = self.model
        if self._float:
            return torch.zeros((m.depth, 2, rows, m.kv_heads, m.max_len,
                                m.head_dim), dtype=torch.float32,
                               device=self.device)
        return torch.zeros((m.depth, 2, rows, m.max_len, self._kv_channels),
                           dtype=torch.uint8, device=self.device)

    def _first_rows(self, kv: torch.Tensor, t: int) -> torch.Tensor:
        """The view of positions [0, t) of a ``_kv_buffer``."""
        return kv.narrow(4 if self._float else 3, 0, t)

    @staticmethod
    def _views(kv: torch.Tensor) -> dict:
        """Layer i's (k, v) caches as views of ``kv`` [depth, 2, ...]."""
        return {i: (kv[i - 1, 0], kv[i - 1, 1])
                for i in range(1, kv.shape[0] + 1)}

    def _bound(self):
        """The model's shards bound and its TP context active (a sharded
        engine), or nothing."""
        if self._pa is None:
            return contextlib.nullcontext()
        from ..parallel.sharding import sharded
        return sharded(self.model)

    def _owns(self, slot: int) -> bool:
        return self._row0 <= slot < self._row0 + self._rows

    def _local_row(self, slot: int) -> int:
        """Slot ``slot``'s row in this rank's caches: its own row, or the
        spare row past them for a slot that another data group owns."""
        return slot - self._row0 if self._owns(slot) else self._rows

    # -- public API -----------------------------------------------------------
    def register_prefix(self, tokens) -> int:
        """Compute a shared prompt prefix's KV rows once; a submission with
        ``prefix_id=`` seeds them into its slot and prefills only the rest
        of its prompt (a system prompt or few-shot context).

        The cache holds u8 codes at fixed calibrated grids, and position
        t's codes depend only on the tokens up to t, so the rows do not
        depend on what follows them: a prefixed request gives the tokens
        of the full prompt submitted cold.  A weight-only model's float
        rows come from the same program, but a float sum over a chunk can
        differ in its last bits from a bucketed prefill's, so there the
        prefixed tokens follow the cold ones within the float path's
        tolerance.  The rows come from the chunked extend
        (``prefill_chunk`` must be set), run eagerly on a private one-row
        cache: in the caller's thread, or on a sharded engine in the
        engine's thread on every rank (called on rank 0; it waits for
        them).  Raises ``RuntimeError`` when the table holds
        ``max_prefixes``."""
        if self._ctl is not None and not self._host:
            raise self._ctl.follower_error("register_prefix()")
        if self.prefill_chunk is None:
            raise ValueError(
                "prefix caching rides the chunked-prefill program; "
                "construct GenerationEngine(..., prefill_chunk=P)")
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        t0 = len(tokens)
        if t0 == 0:
            raise ValueError("empty prefix")
        if t0 >= self.model.max_len:
            raise ValueError(
                f"prefix {t0} leaves no room under max_len "
                f"{self.model.max_len}")
        if self._pa is not None:
            if not self._running:
                raise RuntimeError("engine is shut down")
            reg = _Registration(tokens)
            self._regs.put(reg)
            return reg.future.result()
        with torch.no_grad():
            rows = self._prefix_rows(tokens)
        if self._cuda:
            # the engine's stream reads the rows: they must be written
            torch.cuda.current_stream(self.device).synchronize()
        with self._prefix_lock:
            self._check_table()
            pid = self._next_pid
            self._next_pid += 1
            self._prefixes[pid] = (tokens, rows)
        return pid

    def _check_table(self) -> None:
        if len(self._prefixes) >= self.max_prefixes:
            raise RuntimeError(
                f"prefix table full ({self.max_prefixes} registered "
                f"prefixes, each holding KV rows on device); "
                f"unregister_prefix() one first or raise max_prefixes")

    def _prefix_rows(self, tokens: np.ndarray) -> torch.Tensor:
        """The prefix's rows of every layer [depth, 2, t0, ...]: the
        chunked extend over a private one-row cache."""
        m, t0 = self.model, len(tokens)
        kv = self._kv_buffer(1)
        caches = self._views(kv)
        pad = np.zeros((m.max_len,), np.int64)
        pad[:t0] = tokens
        with self._bound():
            for c0 in self._chunk_starts(0, t0):
                m._extend_step(caches, torch.tensor(
                    [c0], dtype=torch.int64, device=self.device),
                    torch.tensor(pad[None, c0:c0 + self.prefill_chunk],
                                 device=self.device))
        return self._first_rows(kv, t0)[:, :, 0].clone()

    def unregister_prefix(self, prefix_id: int) -> None:
        """Drop a registered prefix (its device rows are freed when no
        admission holds them).  A queued request that names it fails alone,
        at admission."""
        if self._ctl is not None and not self._host:
            raise self._ctl.follower_error("unregister_prefix()")
        with self._prefix_lock:
            if prefix_id not in self._prefixes:
                raise ValueError(f"unknown prefix_id {prefix_id}")
            del self._prefixes[prefix_id]
            if self._pa is not None:
                self._unregs.append(prefix_id)

    def _build_request(self, prompt, max_new_tokens: int,
                       temperature: float = 0.0, seed: int = 0,
                       top_p: float = 1.0, top_k: int | None = None,
                       prefix_id: int | None = None,
                       eos_id: int | None = None,
                       stop=None) -> _GenRequest:
        if self._ctl is not None and not self._host:
            raise self._ctl.follower_error("submit()")
        if not self._running:
            raise RuntimeError("engine is shut down")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if prefix_id is not None:
            with self._prefix_lock:
                entry = self._prefixes.get(prefix_id)
            if entry is None:
                raise ValueError(f"unknown prefix_id {prefix_id}")
            pre = entry[0]
            if len(prompt) <= len(pre):
                raise ValueError(
                    f"prompt ({len(prompt)} tokens) must EXTEND the "
                    f"{len(pre)}-token prefix by at least one token")
            if not np.array_equal(prompt[:len(pre)], pre):
                raise ValueError(
                    f"prompt does not start with prefix {prefix_id}'s "
                    "tokens")
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
            top_p, 0 if top_k is None else int(top_k), prefix_id,
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
        ``top_k``, ``prefix_id`` (a registered prefix that the prompt
        starts with), ``eos_id`` (overrides the engine's) and ``stop`` (a
        list of token sequences; a match ends the output after it).  On a
        sharded engine only world rank 0 takes requests."""
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
        """Stop taking requests, finish the admitted and queued ones, and
        end the engine's thread.  On a sharded engine every rank calls it:
        rank 0's ends the ranks' lockstep once its slots have drained, and
        another rank's returns then (raising if that rank's engine
        failed)."""
        self._running = False
        self._queue.put(None)
        if wait:
            self._thread.join()
            if not self._host and self._error is not None:
                raise RuntimeError(
                    f"the sharded engine failed on rank {self._ctl.rank}: "
                    f"{self._error!r}") from self._error

    # -- device programs -------------------------------------------------------
    def _h2d(self, arr, dtype) -> torch.Tensor:
        """A small host array on the device, copied in stream order from
        pinned memory (the caching host allocator keeps the pinned block
        until the copy has run)."""
        t = torch.as_tensor(np.asarray(arr), dtype=dtype)
        if not self._cuda:
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _prefill_into(self, part, prompts_pad, t0s, vecs, sampled: bool,
                      use_topp: bool, use_topk: bool):
        """Batched prefill of the right-padded prompts [n, bucket] of the
        admissions ``part`` in one forward (eager; a graph per (bucket, n)
        is later work): the rows (a ring layer's ring tail) of this rank's
        slots scatter into their caches, and each prompt's first token is
        picked from its row ``t0 - 1``.  ``vecs`` are the requests'
        sampling vectors (``_request_vectors``)."""
        m = self.model
        with self._bound():
            codes, cache1 = m._prefill(Tensor(prompts_pad), last=t0s,
                                       full_cache=not self._ring_serving)
        own = [j for j, (slot, _) in enumerate(part) if self._owns(slot)]
        if own:
            rows = self._h2d([part[j][0] - self._row0 for j in own],
                             torch.int64)
            pick = (None if len(own) == len(part)
                    else self._h2d(own, torch.int64))
            for i, (k1, v1) in cache1.items():           # [n, rows, C]
                if pick is not None:
                    k1, v1 = k1.index_select(0, pick), v1.index_select(0, pick)
                self._caches[i][0].index_copy_(0, rows, k1)
                self._caches[i][1].index_copy_(0, rows, v1)
        if not sampled:
            return codes.argmax(-1)
        temps, seeds, topps, topks, _ = vecs
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
        (the warm-up) and captures it, later calls replay the graph (a
        sharded engine's run eagerly every time)."""
        key = (sampled, use_topp, use_topk)
        fn = self._chunk_fns.get(key)
        if fn is None:
            fn = self._chunk_fns[key] = graphs.Captured(
                self._chunk_body(*key), self._capture)
        return fn

    def _run_chunks(self, key: tuple, rem: np.ndarray, multi: bool):
        """The chunk step of the scheduler on this rank: the slots' act and
        remaining counts from ``rem`` (every slot's), then one chunk of
        variant ``key``, or ``sync_chunks`` of them back to back with
        ``multi``; returns ``_fetch_async``'s wait."""
        rem = rem[self._row0:self._row0 + self._rows]
        self._act.copy_(self._h2d(rem > 0, torch.bool))
        self._rem.copy_(self._h2d(rem, torch.int64))
        self._col.zero_()
        self._work.zero_()
        chunk = self._chunk(*key)
        n = self.sync_chunks if multi else 1
        with self._bound():
            for _ in range(n):
                chunk()
        self.stats.chunks += n
        return self._fetch_async(n * self.chunk_steps)

    def _fetch_async(self, ncols: int):
        """Start copying the first ``ncols`` token columns and the work
        counter to the host (a sharded engine's gathered over the data
        group first, every slot's tokens on every rank); returns a
        function that waits for the copy and gives (tokens [slots, ncols]
        int64, work)."""
        out, work = self._out[:, :ncols], self._work
        if self._pa is not None:
            from ..parallel.sharding import all_gather_cat, all_reduce_sum
            out = all_gather_cat(out, self._pa.data_group, 0)
            work = all_reduce_sum(work.clone(), self._pa.data_group)
        if not self._cuda:
            toks, work = out.clone(), work.clone()
            return lambda: (toks.numpy(), int(work[0]))
        toks = torch.empty((self.slots, ncols), dtype=torch.int64,
                           pin_memory=True)
        host = torch.empty((1,), dtype=torch.int64, pin_memory=True)
        toks.copy_(out, non_blocking=True)
        host.copy_(work, non_blocking=True)
        done = torch.cuda.Event()
        done.record(self._stream)

        def wait():
            done.synchronize()
            return toks.numpy(), int(host[0])

        return wait

    # -- scheduler -------------------------------------------------------------
    def _admit_batch(self, pairs) -> None:
        """Prefill a burst of admissions in as few calls as possible: group
        by prompt bucket, split groups into power-of-two sizes, one batched
        prefill (and one host sync) per sub-group.  With ``prefill_chunk``
        set, prompts longer than it and prefixed requests take the chunked
        one-slot path instead."""
        if self.prefill_chunk is not None:
            rest = []
            for slot, req in pairs:
                if (req.prefix_id is not None
                        or len(req.prompt) > self.prefill_chunk):
                    self._admit_chunked(slot, req)
                else:
                    rest.append((slot, req))
            pairs = rest
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
        for j, (slot, req) in enumerate(part):
            t0s[j] = len(req.prompt)
            pad[j, :t0s[j]] = req.prompt
            # register BEFORE the device work: if prefill raises, the crash
            # handler must fail these requests' futures too
            self._active[slot] = req
        reqs = [req for _, req in part]
        t0s_d = self._h2d(t0s, torch.int64)
        vecs = self._request_vectors(reqs)
        toks_d = self._prefill_into(
            part, self._h2d(pad, torch.int64), t0s_d, vecs,
            any(r.temperature > 0 for r in reqs),
            any(r.top_p < 1.0 for r in reqs),
            any(r.top_k > 0 for r in reqs))
        self._started(part, t0s_d, toks_d, vecs)

    def _request_vectors(self, reqs):
        """The requests' (temps, seeds, topps, topks, eos) on the device."""
        return (self._h2d([r.temperature for r in reqs], torch.float32),
                self._h2d([fold_seed(r.seed) for r in reqs], torch.int64),
                self._h2d([r.top_p for r in reqs], torch.float32),
                self._h2d([r.top_k for r in reqs], torch.int64),
                self._h2d([-1 if r.eos_id is None else r.eos_id
                           for r in reqs], torch.int64))

    def _started(self, part, t0s_d, toks_d, vecs) -> None:
        """The admitted requests' sampling and eos settings, first tokens
        ``toks_d`` and positions (their prompts' lengths ``t0s_d``) into
        this rank's slots; then, on the host rank, the first tokens to the
        requests."""
        own = [j for j, (slot, _) in enumerate(part) if self._owns(slot)]
        if own:
            rows = self._h2d([part[j][0] - self._row0 for j in own],
                             torch.int64)
            if len(own) < len(part):
                pick = self._h2d(own, torch.int64)

                def mine(v):
                    return v.index_select(0, pick)
            else:
                def mine(v):
                    return v
            for buf, val in zip((self._temp, self._seed, self._topp,
                                 self._topk, self._eos), vecs):
                buf.index_copy_(0, rows, mine(val))
            self._tok.index_copy_(0, rows, mine(toks_d))
            self._pos.index_copy_(0, rows, mine(t0s_d))
        if not self._host:
            return
        toks = toks_d.cpu().numpy()
        self.stats.prefills += len(part)
        for j, (slot, req) in enumerate(part):
            tok0 = int(toks[j])
            req.tokens.append(tok0)
            self._stream_push(req, tok0)
            if self._done(req, tok0):
                self._finish(slot)

    # -- chunked prefill and the prefix cache -----------------------------------
    def _chunk_starts(self, base: int, t0: int) -> list:
        """The chunk starts over positions [base, t0): every
        ``prefill_chunk``, the last one slid back to end at ``max_len``
        (the rows it repeats are written again with the same codes)."""
        p, max_len = self.prefill_chunk, self.model.max_len
        starts = list(range(base, t0, p))
        if starts[-1] + p > max_len:
            starts[-1] = max_len - p
        return starts

    def _extend_body(self):
        """The one-slot extend program: slot row ``_xslot``'s rows into
        the one-row scratch cache, ``_extend_step`` over the [1, P] chunk
        ``_xtoks`` at position ``_xbase``, the rows written back; returns
        the chunk's logit codes [P, V]."""
        m = self.model
        self._xkv = self._kv_buffer(1)
        xcaches = self._views(self._xkv)
        dev = self.device
        self._xslot = torch.zeros((1,), dtype=torch.int64, device=dev)
        self._xbase = torch.zeros((1,), dtype=torch.int64, device=dev)
        self._xtoks = torch.zeros((1, self.prefill_chunk), dtype=torch.int64,
                                  device=dev)

        def body():
            self._xkv.copy_(self._kv.index_select(2, self._xslot))
            codes, _ = m._extend_step(xcaches, self._xbase, self._xtoks)
            self._kv.index_copy_(2, self._xslot, self._xkv)
            return codes[0]

        return body

    def _extend(self, row: int, chunk: np.ndarray, base: int):
        """Run the extend program on one chunk of a prompt in cache row
        ``row`` at position ``base``; returns the chunk's codes [P, V] (the
        program's output, valid until its next call)."""
        if self._extend_program is None:
            self._extend_program = graphs.Captured(self._extend_body(),
                                                   self._capture)
        self._xslot.copy_(self._h2d([row], torch.int64))
        self._xbase.copy_(self._h2d([base], torch.int64))
        self._xtoks.copy_(self._h2d(chunk[None], torch.int64))
        with self._bound():
            return self._extend_program()

    def _seed_fn(self, base: int):
        """The seed program of prefixes of ``base`` tokens: all layers'
        rows into one slot's first ``base`` rows, one copy.  At most
        ``_SEED_FN_CAP`` are kept (the oldest goes)."""
        fn = self._seed_fns.get(base)
        if fn is None:
            head = self._first_rows(self._kv, base)

            def fn(rows, slot):
                head[:, :, slot].copy_(rows)

            if len(self._seed_fns) >= self._SEED_FN_CAP:
                self._seed_fns.pop(next(iter(self._seed_fns)))
            self._seed_fns[base] = fn
        return fn

    def _admit_chunked(self, slot: int, req: _GenRequest) -> None:
        """Prefill one prompt through the extend program, chunk by chunk;
        with ``req.prefix_id``, seed the prefix's rows (``prefix_entry``)
        into the slot first and chunk only the suffix.  The first token is
        greedy or drawn with the request's (seed, position t0 - 1) stream,
        as the bucketed path's."""
        t0 = len(req.prompt)
        # registered before the device work: a failure below must fail
        # this request's future through the crash handler
        self._active[slot] = req
        row = self._local_row(slot)
        base = 0
        if req.prefix_id is not None:
            pre_tokens, rows = req.prefix_entry
            base = len(pre_tokens)
            if self._cuda:
                # rows made on another stream, read on this one: not freed
                # for reuse before the seed has run
                rows.record_stream(self._stream)
            self._seed_fn(base)(rows, row)
            if self._host:
                self.stats.prefix_hits += 1
        pad = np.zeros((self.model.max_len,), np.int64)
        pad[:t0] = req.prompt
        starts = self._chunk_starts(base, t0)
        for c0 in starts:
            codes = self._extend(row, pad[c0:c0 + self.prefill_chunk], c0)
        last = codes[(t0 - 1) - starts[-1]][None]          # [1, V]
        t0s_d = self._h2d([t0], torch.int64)
        vecs = self._request_vectors([req])
        if req.temperature > 0:
            temps, seeds, topps, topks, _ = vecs
            tok = self.model._pick(last, temps, seeds, t0s_d - 1,
                                   topps if req.top_p < 1.0 else None,
                                   topks if req.top_k > 0 else None)
        else:
            tok = last.argmax(-1)
        self._started([(slot, req)], t0s_d, tok, vecs)

    def _resolve_prefix(self, req: _GenRequest) -> bool:
        """Bind a prefixed request to its prefix's rows at admission; False
        (and the request failed alone) when the prefix was unregistered
        while the request was queued."""
        if req.prefix_id is None:
            return True
        with self._prefix_lock:
            req.prefix_entry = self._prefixes.get(req.prefix_id)
        if req.prefix_entry is not None:
            return True
        # a stale prefix_id is the caller's mistake: fail only this request
        req.future.set_exception(ValueError(
            f"prefix {req.prefix_id} was unregistered while the request "
            "was queued"))
        self._stream_close(req)
        return False

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
        if self._ctl is not None:
            self._freed.append(slot)
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
                if self._host:
                    self._loop_inner()
                else:
                    self._follow()
        except BaseException as e:          # fail pending futures, loudly
            # the engine is dead: later submit()s must raise instead of
            # enqueueing futures nothing will ever resolve
            self._running = False
            self._error = e
            if self._ctl is not None and self._host:
                # end the other ranks' lockstep now (their own collective
                # may have failed first: then this fails too)
                try:
                    self._ctl.send({"stop": True, "error": repr(e)})
                except Exception:
                    pass
            for s, req in enumerate(self._active):
                if req is not None and not req.future.done():
                    req.future.set_exception(e)
                if req is not None:
                    self._stream_close(req)
                self._active[s] = None
            self._fail_queued(e)
            raise
        finally:
            # the programs close over the engine: without them a dropped
            # engine (its model, caches and graphs' memory) is freed at once,
            # not at the next cyclic garbage collection
            self._chunk_fns.clear()
            self._extend_program = None
            self._seed_fns.clear()

    def _fail_queued(self, exc: BaseException) -> None:
        """Fail every queued request and registration with ``exc``."""
        for q in (self._queue, self._regs):
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                if item is not None and not item.future.done():
                    item.future.set_exception(exc)
                    if isinstance(item, _GenRequest):
                        self._stream_close(item)

    def _loop_inner(self) -> None:
        try:
            self._drain_loop()
            if self._ctl is not None:
                self._ctl.send({"stop": True})
        finally:
            # shutdown: fail anything still queued — a request that will
            # never run must not leave its future pending forever
            self._fail_queued(RuntimeError("engine shut down before this "
                                           "request was scheduled"))

    def _send(self, record: dict) -> None:
        """A sharded engine's control record to the other ranks (with the
        slots freed since the last one); nothing unsharded."""
        if self._ctl is not None:
            record["freed"], self._freed = self._freed, []
            self._ctl.send(record)

    def _registrations(self) -> list:
        """Rank 0 of a sharded engine: the queued prefix registrations,
        each given its id (or failed when the table is full)."""
        regs = []
        while True:
            try:
                reg = self._regs.get_nowait()
            except queue.Empty:
                return regs
            with self._prefix_lock:
                try:
                    self._check_table()
                except RuntimeError as e:
                    reg.future.set_exception(e)
                    continue
                pid = self._next_pid
                self._next_pid += 1
                # the id is held until the rows come (so the table bound
                # counts it); its entry is filled by _register
                self._prefixes[pid] = None
            regs.append((pid, reg))

    def _register(self, pid: int, tokens: np.ndarray) -> None:
        """A sharded engine's prefix rows, computed on every rank in the
        engine's thread (data-replicated, channel-sharded like the slot
        caches), under id ``pid``."""
        rows = self._prefix_rows(tokens)
        with self._prefix_lock:
            self._prefixes[pid] = (tokens, rows)

    def _from_fields(self, fields) -> tuple:
        """(slot, request) of an admission's control record on a rank that
        follows: the request rebuilt, its prefix rows from this rank's
        table."""
        slot, prompt, max_new, temp, seed, top_p, top_k, eos, pid = fields
        req = _GenRequest(prompt, max_new, temp, seed, top_p, top_k, pid,
                          eos)
        if pid is not None:
            req.prefix_entry = self._prefixes[pid]
        return slot, req

    def _apply(self, rec: dict, pairs=None) -> None:
        """The admission part of a control record, on every rank in one
        order: freed slots, prefix registrations, admissions (rank 0
        passes its own requests as ``pairs``), dropped prefixes."""
        for s in rec.get("freed", ()):
            self._active[s] = None
        for pid, tokens in rec.get("register", ()):
            self._register(pid, tokens)
        if pairs is None:
            pairs = [self._from_fields(f) for f in rec.get("admit", ())]
        if pairs:
            self._admit_batch(pairs)
        with self._prefix_lock:
            for pid in rec.get("unregister", ()):
                self._prefixes.pop(pid, None)

    def _follow(self) -> None:
        """A sharded engine's thread on a rank other than 0: apply rank
        0's records until its shutdown."""
        while True:
            rec = self._ctl.recv()
            if rec.get("stop"):
                if rec.get("error"):
                    raise RuntimeError(f"rank 0's engine failed: "
                                       f"{rec['error']}")
                return
            self._apply(rec)
            if "chunk" in rec:
                # the tokens are rank 0's to read
                self._run_chunks(rec["chunk"], rec["rem"], rec["multi"])

    def _drain_loop(self) -> None:
        # overlap=True: ``pending`` holds the dispatched-but-unread chunk —
        # (its token fetch, the [(slot, req)] snapshot it decoded for).  By
        # fetch time a slot may already hold a different request.
        pending = None
        while (self._running or pending is not None
               or any(r is not None for r in self._active)):
            regs = self._registrations() if self._ctl is not None else []
            admits, taken = [], set()
            while self._running:
                slot = next((s for s, r in enumerate(self._active)
                             if r is None and s not in taken), None)
                if slot is None:
                    break
                idle = (not admits and not regs and pending is None
                        and all(r is None for r in self._active))
                try:
                    req = (self._queue.get(timeout=0.1) if idle
                           else self._queue.get_nowait())
                except queue.Empty:
                    break
                if req is None:          # shutdown: drain active slots
                    self._running = False
                    break
                if not self._resolve_prefix(req):
                    continue
                admits.append((slot, req))
                taken.add(slot)
            with self._prefix_lock:
                unregs, self._unregs = self._unregs, []
            if admits or regs or unregs:
                rec = {"register": [(pid, r.tokens) for pid, r in regs],
                       "admit": [req.fields(slot) for slot, req in admits],
                       "unregister": unregs}
                self._send(rec)
                try:
                    self._apply(rec, admits)
                except BaseException as e:
                    for _, r in regs:
                        r.future.set_exception(e)
                    raise
                for pid, r in regs:
                    r.future.set_result(pid)
            if any(r is not None for r in self._active):
                snapshot = list(self._active)
                n_act = sum(r is not None for r in snapshot)
                key = tuple(any(r is not None and cond(r) for r in snapshot)
                            for cond in (lambda r: r.temperature > 0,
                                         lambda r: r.top_p < 1.0,
                                         lambda r: r.top_k > 0))
                rem = np.zeros((self.slots,), np.int64)
                for s, r in enumerate(snapshot):
                    if r is not None:
                        rem[s] = max(1, r.max_new - len(r.tokens))
                # with nothing queued no slot can be refilled: run
                # sync_chunks chunks back to back before reading tokens
                # back (the JAX package's multi-chunk while_loop, without
                # its early exit)
                multi = (self.sync_chunks > 1 and pending is None
                         and self._queue.empty())
                self._send({"chunk": key, "rem": rem, "multi": multi})
                wait = self._run_chunks(key, rem, multi)
                if multi:
                    fetch = (wait, snapshot, True)
                else:
                    self.stats.chunk_slots_active += n_act
                    if self.overlap:
                        pending, fetch = (wait, snapshot, False), pending
                    else:
                        fetch = (wait, snapshot, False)
            else:
                fetch, pending = pending, None
            if self._ctl is not None:
                self._ctl.heartbeat()
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
