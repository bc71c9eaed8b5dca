"""Captured CUDA graphs: the port's counterpart of ``jax.jit`` over the
decode step programs.

The JAX package runs every decode step inside one compiled program (a
``lax.scan`` in ``generate()``, a scan per decode chunk and a
``while_loop`` over chunks in the serving engine).  Eagerly, the port would
launch every kernel of a step from Python: about a thousand launches a
gpt2-small step, with the card idle most of the time.  Here a step (or a
chunk of steps, or a CNN forward) is captured once with stock
``torch.cuda.CUDAGraph`` and replayed:

* Everything the program reads or writes lives in static buffers allocated
  outside the graph (the KV caches, positions, tokens, per-slot sampling
  vectors, token outputs) and is updated in place; a value that changes
  between replays must be a device tensor, or the graph freezes it.
* The first call runs eagerly (the warm-up, on a side stream): it builds
  the kernels' libraries, runs each launcher's first attribute call and
  fills the operand caches that are built per input grid, which must not
  live in the graph's private pool.  Capture itself runs no work.
* Nothing inside a program syncs with the host, and capture runs in
  ``thread_local`` error mode on its own stream, so an engine's thread may
  capture while other threads use the card.
* Memory: a capture allocates from a private pool of its own and cannot
  release cached memory while it runs, and a dropped graph's pool stays
  cached until released.  So ``run_steps`` and ``run_until``, which
  capture a new program at every ``generate()``, first release the cache
  when less than a quarter of the card is free (``release_if_low``); and
  they capture on one side stream per thread and device (``side_stream``),
  since PyTorch keeps a cuBLAS workspace for every stream that a float
  GEMM has run on.
* A program that runs until a device value says it is done
  (``run_until``: speculative decoding's macro-steps) replays a few times
  between host reads of that value.
* Launch counts follow the work: a kernel wrapper adds to its ``launches``
  (a library route to its ``calls``) when it is called, so capture (which
  runs nothing) would count once and a replay (which calls no wrapper)
  never.  ``Captured`` therefore takes
  the counts that its capture added back out, keeps them as the graph's
  kernels, and adds them again at every replay.  This assumes that no
  other thread calls a kernel wrapper while a program is captured.

On the CPU nothing is captured: the same program runs eagerly every time.
"""

from __future__ import annotations

import threading

import torch

__all__ = ["capture", "Captured", "run_steps", "run_until",
           "launch_counters"]

_local = threading.local()


def launch_counters():
    """The kernel wrappers' launch counters and the library routes' call
    counters (the weight modes', the MoE experts', the ALiBi attention's,
    the encoders' attention's and the FP32 islands'), as (function,
    attribute) pairs."""
    from . import layers
    from .ops import attention, conv, gemm_int8, moe, w4, weight_only
    fns = (gemm_int8.qgemm, gemm_int8.qgemm_multi,
           attention.decode_attention_flat, w4.w4_gemm, w4.w4a8_v1,
           w4.w4a8_v2, conv.conv2d_int8_grouped, weight_only.w8f_matmul,
           weight_only.s8_matmul, conv.w8f_conv2d, conv.conv2d_s8,
           moe.experts, attention.decode_attention_alibi,
           attention.attention, layers.fp32_island)
    return [(fn, attr) for fn in fns
            for attr in ("launches", "merged_launches", "calls")
            if hasattr(fn, attr)]


def capture(fn, stream) -> torch.cuda.CUDAGraph:
    """Capture ``fn()`` on ``stream`` (after the current stream's queued
    work) into a new CUDA graph and return it; nothing runs.  A failure
    inside ``fn`` or in the capture raises."""
    graph = torch.cuda.CUDAGraph()
    stream.wait_stream(torch.cuda.current_stream(stream.device))
    with torch.cuda.stream(stream):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            fn()
        except BaseException:
            try:
                graph.capture_end()
            except Exception:       # the capture is invalid; fn's error wins
                pass
            raise
        graph.capture_end()
    return graph


class Captured:
    """``fn`` as a replayable program.  Without a ``stream`` (the CPU) each
    call runs ``fn``.  With one, the first call runs ``fn`` eagerly (the
    warm-up) and then captures it on ``stream`` without running it; every
    later call replays the graph on the current stream.  A call returns
    ``fn``'s result: the eager one first, then the captured output, which
    each replay overwrites.

    ``launches`` holds the kernel launches of one replay ({(wrapper,
    attribute): count}, from the counts the capture added, which it takes
    back out); each replay adds them to the wrappers' counts, and
    ``replays`` counts the replays."""

    def __init__(self, fn, stream=None):
        self.fn = fn
        self.stream = stream
        self.graph = None
        self.out = None
        self.launches = {}
        self.replays = 0

    def __call__(self):
        if self.graph is not None:
            self.graph.replay()
            self.replays += 1
            for (fn, attr), n in self.launches.items():
                setattr(fn, attr, getattr(fn, attr) + n)
            return self.out
        out = self.fn()
        if self.stream is not None:
            counters = launch_counters()
            before = [getattr(fn, attr) for fn, attr in counters]
            self.graph = capture(self._record, self.stream)
            for (fn, attr), was in zip(counters, before):
                if getattr(fn, attr) != was:
                    self.launches[fn, attr] = getattr(fn, attr) - was
                    setattr(fn, attr, was)
        return out

    def _record(self):
        self.out = self.fn()


def release_if_low(device) -> None:
    """Release the caching allocator's idle memory when less than a quarter
    of the card is free (a capture cannot release it)."""
    free, total = torch.cuda.mem_get_info(device)
    if free < total // 4:
        torch.cuda.empty_cache()


def side_stream(device) -> torch.cuda.Stream:
    """This thread's capture stream on ``device``, made at its first use
    and kept."""
    streams = getattr(_local, "streams", None)
    if streams is None:
        streams = _local.streams = {}
    stream = streams.get(device)
    if stream is None:
        stream = streams[device] = torch.cuda.Stream(device)
    return stream


def run_steps(step, n: int, device):
    """Run ``step()`` ``n`` times in order.  On the CPU: a loop.  On the
    card: the first call eagerly on a side stream (the warm-up), captured
    after it, and replayed ``n - 1`` times on the current stream.  Returns
    the ``Captured`` program (None on the CPU): keep it until the replays'
    results have been read."""
    device = torch.device(device)
    if device.type != "cuda":
        for _ in range(n):
            step()
        return None
    if n <= 0:
        return None
    release_if_low(device)
    side = side_stream(device)
    program = Captured(step, side)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        program()
    torch.cuda.current_stream(device).wait_stream(side)
    for _ in range(n - 1):
        program()
    return program


def run_until(step, done, device, first: int = 1, every: int = 1):
    """Run ``step()`` until ``done()`` (a host read of a device value) is
    true; nothing runs if it is true at once.  On the CPU: a loop that
    asks after every step.  On the card: the first call eagerly on a side
    stream (the warm-up), captured after it, then replays on the current
    stream; ``done()`` is read after ``first`` calls and then every
    ``every`` replays, so ``step`` must be harmless once done.  Returns the
    ``Captured`` program (None on the CPU or when nothing ran)."""
    device = torch.device(device)
    if done():
        return None
    if device.type != "cuda":
        while True:
            step()
            if done():
                return None
    release_if_low(device)
    side = side_stream(device)
    program = Captured(step, side)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        program()
    torch.cuda.current_stream(device).wait_stream(side)
    ran, budget = 1, max(1, first)
    while True:
        while ran < budget:
            program()
            ran += 1
        if done():
            return program
        budget = ran + max(1, every)
