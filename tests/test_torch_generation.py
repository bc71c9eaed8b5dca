"""PyTorch port vs JAX package: the ``GenerationEngine`` (continuous-batching
decode) on ``gpt_tiny`` (vocab 1000, dim 128, depth 2, max_len 64) with the
JAX package's converted state carried over.

* Greedy requests (mixed prompt lengths and ``max_new``, more requests than
  slots; ``slots=2``, ``chunk_steps=4``) give the JAX package's
  ``generate()`` tokens for each prompt **exactly**.
* The rest mirrors ``tests/test_generation.py`` against the port's own
  ``generate()``, exactly: eos, guards, stats, shutdown, per-request
  sampling (same seed same tokens; a sampled request equals ``generate()``'s
  row 0 with that seed), ``overlap``, ``sync_chunks`` (multi-chunk equals
  single-chunk), per-request eos and ``stop`` sequences, ``submit_stream``,
  a failing loop failing every future.
* A negative ``eos_id`` raises; the options the port does not implement
  (meshes) raise ``NotImplementedError``, and a ring
  cache with chunked prefill ``ValueError`` (chunked prefill and the prefix
  cache: ``test_torch_prefix_cache``; ring serving:
  ``test_torch_ring_cache``).
* A slot decoding past ``max_len`` stays in its own last cache row and
  leaves the other slots' results unchanged.
* On the card (``cuda``-marked): the captured ``generate()`` equals the
  eager step loop, a captured engine's greedy tokens equal ``generate()``,
  and an engine's chunk graph replays to the same tokens twice.

Every ``result()`` takes a timeout and every engine shuts down in a
``finally``.
"""

import sys
import threading

import numpy as np
import pytest
import torch

import int8inferenceengine_tpu as qj
from int8inferenceengine_tpu.models import zoo as jzoo
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch.carry import load_jax_state
from int8inferenceengine_tpu_torch.models import zoo as tzoo
from int8inferenceengine_tpu_torch.serve import GenerationEngine
from int8inferenceengine_tpu_torch.serve.generation import _bucket
from int8inferenceengine_tpu_torch.tensor import Tensor
from test_torch_text_decoder import jax_state
from test_torch_threads import one_torch_thread  # noqa: F401

WAIT = 120
# (prompt length, max_new): more requests than slots, one max_new of 1
CASES = [(5, 6), (12, 3), (3, 9), (20, 7), (7, 1)]


def _prompts(seed, lengths, vocab=1000):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, t0).astype(np.int32) for t0 in lengths]


@pytest.fixture(scope="module")
def ref():
    """The JAX package's gpt_tiny lifecycle and its generate() tokens for
    each prompt of CASES alone."""
    m = jzoo.build("gpt_tiny")
    m.load(jzoo.torch_twin("gpt_tiny").state_dict())
    m.prepare()
    m(qj.tensor(np.random.default_rng(1).integers(
        0, 1000, (8, 64)).astype(np.int32)))
    m.convert()
    prompts = _prompts(7, [t0 for t0, _ in CASES])
    tokens = [np.asarray(m.generate(p[None], n)[0])
              for p, (_, n) in zip(prompts, CASES)]
    return dict(state=jax_state(m), prompts=prompts, tokens=tokens)


@pytest.fixture(scope="module")
def model(ref):
    m = tzoo.build("gpt_tiny", device="cpu")
    load_jax_state(m, ref["state"])
    return m


def _engine(model, **kw):
    return GenerationEngine(model, **{"slots": 2, "chunk_steps": 4, **kw})


def test_engine_matches_jax_generate(ref, model):
    eng = _engine(model)
    try:
        futs = [eng.submit(p, n) for p, (_, n) in zip(ref["prompts"], CASES)]
        for fut, want, (_, n) in zip(futs, ref["tokens"], CASES):
            got = fut.result(timeout=WAIT)
            assert got.dtype == np.int32 and got.shape == (n,)
            np.testing.assert_array_equal(got, want)
    finally:
        eng.shutdown()


@pytest.mark.parametrize("kw", [dict(overlap=True), dict(sync_chunks=1)])
def test_engine_modes_match_jax_generate(ref, model, kw):
    eng = _engine(model, **kw)
    try:
        futs = [eng.submit(p, n) for p, (_, n) in zip(ref["prompts"], CASES)]
        for fut, want in zip(futs, ref["tokens"]):
            np.testing.assert_array_equal(fut.result(timeout=WAIT), want)
    finally:
        eng.shutdown()


def test_engine_eos_stops_early(model):
    prompt = _prompts(3, [6])[0]
    full = model.generate(prompt[None, :], 8)[0]
    eos = int(full[3])
    eng = GenerationEngine(model, slots=1, chunk_steps=2, eos_id=eos)
    try:
        got = eng.submit(prompt, 8).result(timeout=WAIT)
        k = int(np.where(full == eos)[0][0])
        np.testing.assert_array_equal(got, full[:k + 1])
    finally:
        eng.shutdown()


def test_engine_guards(model):
    eng = GenerationEngine(model, slots=1)
    try:
        with pytest.raises(ValueError, match="empty"):
            eng.submit([], 4)
        with pytest.raises(ValueError, match="max_len"):
            eng.submit(list(range(60)), 10)
        with pytest.raises(ValueError, match="temperature"):
            eng.submit([1, 2], 2, temperature=-1.0)
        with pytest.raises(ValueError, match="top_p"):
            eng.submit([1, 2], 2, top_p=0.0)
        with pytest.raises(ValueError, match="top_k"):
            eng.submit([1, 2], 2, top_k=0)
        with pytest.raises(ValueError, match="stop"):
            eng.submit([1, 2], 2, stop=[[]])
    finally:
        eng.shutdown()


def test_negative_eos_id_raises(model):
    with pytest.raises(ValueError, match="eos_id"):
        GenerationEngine(model, slots=1, eos_id=-1)
    eng = GenerationEngine(model, slots=1)
    try:
        with pytest.raises(ValueError, match="eos_id"):
            eng.submit([1, 2, 3], 2, eos_id=-3)
        with pytest.raises(ValueError, match="eos_id"):
            eng.submit_stream([1, 2, 3], 2, eos_id=-1)
    finally:
        eng.shutdown()


def test_unported_options_raise(model, monkeypatch):
    # ring caches are served since the windowed decoders were ported
    # (tests/test_torch_ring_cache.py); with chunked prefill they are refused
    with monkeypatch.context() as mp:
        mp.setattr(model, "ring_cache", True, raising=False)
        with pytest.raises(ValueError, match="prefill_chunk"):
            GenerationEngine(model, prefill_chunk=8)
    with monkeypatch.context() as mp:
        mp.setattr(model, "_mesh", object(), raising=False)
        with pytest.raises(NotImplementedError, match="sharded"):
            GenerationEngine(model)
    # weight-only models are served since the float KV cache was ported
    # (tests/test_torch_float_cache.py): float head-split slot caches
    wo = tzoo.build("llama_tiny", device="cpu", config=qt.QuantConfig(
        weight_only=True, weight_bits=4), vocab_size=64, max_len=16,
        dim=128, depth=1, heads=4, kv_heads=2)
    wo.convert()
    eng = GenerationEngine(wo, slots=2)
    try:
        assert eng._caches[1][0].dtype == torch.float32
        assert tuple(eng._caches[1][0].shape) == (2, 2, 16, 32)
    finally:
        eng.shutdown()
    with pytest.raises(RuntimeError, match="converted"):
        GenerationEngine(tzoo.build("gpt_tiny", device="cpu"))


def test_engine_stats(model):
    eng = _engine(model)
    try:
        futs = [eng.submit(np.arange(4 + i, dtype=np.int32) % 1000, 5)
                for i in range(3)]
        for f in futs:
            f.result(timeout=WAIT)
        s = eng.stats
        assert s.requests == 3 and s.prefills == 3
        assert s.tokens == 15
        assert s.chunks >= 1 and 0 < s.mean_slot_fill <= 2.0
        assert s.latency_percentiles()["p50"] > 0
    finally:
        eng.shutdown()


def test_submit_after_shutdown_raises(model):
    eng = GenerationEngine(model, slots=1)
    eng.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        eng.submit([1, 2, 3], 2)
    with pytest.raises(RuntimeError, match="shut down"):
        eng.submit_stream([1, 2, 3], 4)


def test_bucket_never_exceeds_max_len(model):
    assert _bucket(40) == 64 and _bucket(3) == 8
    eng = GenerationEngine(model, slots=1, chunk_steps=2)
    try:
        prompt = (np.arange(40, dtype=np.int32) * 7) % 1000
        got = eng.submit(prompt, 4).result(timeout=WAIT)
        np.testing.assert_array_equal(got,
                                      model.generate(prompt[None, :], 4)[0])
    finally:
        eng.shutdown()


def test_shutdown_fails_queued_requests(model):
    eng = GenerationEngine(model, slots=1, chunk_steps=2)
    a = eng.submit(np.arange(5, dtype=np.int32), 30)    # holds the slot
    b = eng.submit(np.arange(7, dtype=np.int32), 5)     # queued behind it
    eng.shutdown(wait=True)
    assert a.done() and b.done()
    try:
        b.result(timeout=1)          # admitted before the drain, or ...
    except RuntimeError:
        pass                         # ... failed loudly


def test_engine_sampling_per_request(model):
    """Greedy slots stay exact beside sampled ones; the draw is keyed by
    (seed, position): a sampled request equals generate()'s row 0 with
    the same seed, top_k and top_p."""
    p_greedy, p_sample = _prompts(5, [10, 9])
    kw = dict(temperature=0.9, top_k=50, top_p=0.9)
    eng = GenerationEngine(model, slots=4, chunk_steps=4)
    try:
        futs = [eng.submit(p_greedy, 8), eng.submit(p_sample, 8, seed=3, **kw),
                eng.submit(p_sample, 8, seed=3, **kw),
                eng.submit(p_sample, 8, seed=4, **kw)]
        g, s1, s2, s3 = (f.result(timeout=WAIT) for f in futs)
    finally:
        eng.shutdown()
    np.testing.assert_array_equal(g, model.generate(p_greedy[None], 8)[0])
    assert ((s1 >= 0) & (s1 < 1000)).all()
    np.testing.assert_array_equal(s1, s2)
    assert not np.array_equal(s1, s3)
    np.testing.assert_array_equal(
        s1, model.generate(p_sample[None], 8, seed=3, **kw)[0])


def test_engine_overlap_eos_and_sampling(model):
    prompt = _prompts(13, [6])[0]
    full = model.generate(prompt[None, :], 8)[0]
    eos = int(full[3])
    eng = GenerationEngine(model, slots=2, chunk_steps=3, eos_id=eos,
                           overlap=True)
    try:
        f1 = eng.submit(prompt, 8)
        f2 = eng.submit(prompt, 5, temperature=0.9, seed=3)
        k = int(np.where(full == eos)[0][0])
        np.testing.assert_array_equal(f1.result(timeout=WAIT), full[:k + 1])
        s = f2.result(timeout=WAIT)
        assert len(s) <= 5 and ((s >= 0) & (s < 1000)).all()
    finally:
        eng.shutdown()


def test_engine_multichunk_matches_single_sync(model):
    prompts = _prompts(11, [5, 9, 14])
    outs = {}
    for sync in (1, 4):
        eng = GenerationEngine(model, slots=2, chunk_steps=3,
                               sync_chunks=sync)
        try:
            futs = [eng.submit(p, 13) for p in prompts]
            outs[sync] = [f.result(timeout=WAIT) for f in futs]
        finally:
            eng.shutdown()
    for a, b, p in zip(outs[1], outs[4], prompts):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, model.generate(p[None, :], 13)[0])


def test_engine_multichunk_eos_and_sampling(model):
    prompt = _prompts(5, [6])[0]
    full = model.generate(prompt[None, :], 10)[0]
    eos = int(full[4])
    eng = GenerationEngine(model, slots=2, chunk_steps=3, eos_id=eos,
                           sync_chunks=3)
    try:
        got = eng.submit(prompt, 10).result(timeout=WAIT)
        k = int(np.where(full == eos)[0][0])
        np.testing.assert_array_equal(got, full[:k + 1])
        a = eng.submit(prompt, 8, temperature=0.7, seed=3).result(WAIT)
        single = GenerationEngine(model, slots=2, chunk_steps=3,
                                  eos_id=eos, sync_chunks=1)
        try:
            b = single.submit(prompt, 8, temperature=0.7,
                              seed=3).result(WAIT)
        finally:
            single.shutdown()
        np.testing.assert_array_equal(a, b)
    finally:
        eng.shutdown()


def _first_new(ref, lo=2, hi=10):
    """A position whose token does not occur before it."""
    return next(j for j in range(lo, hi)
                if int(ref[j]) not in ref[:j].tolist())


def test_per_request_eos_and_override(model):
    p = _prompts(31, [5])[0]
    kw = dict(temperature=1.0, seed=3)
    eng = _engine(model)
    try:
        ref = eng.submit(p, 12, **kw).result(WAIT)
        stop_at = _first_new(ref)
        e = int(ref[stop_at])
        out = eng.submit(p, 12, eos_id=e, **kw).result(WAIT)
        np.testing.assert_array_equal(out, ref[:stop_at + 1])
        f1 = eng.submit(p, 12, eos_id=e, **kw)
        f2 = eng.submit(p, 12, **kw)
        a, b = f1.result(WAIT), f2.result(WAIT)
        assert a.shape == (stop_at + 1,)
        np.testing.assert_array_equal(b, ref)
    finally:
        eng.shutdown()
    eng2 = _engine(model, eos_id=e)
    try:
        c = eng2.submit(p, 12, **kw).result(WAIT)
        assert c.shape == (stop_at + 1,)
        d = eng2.submit(p, 12, eos_id=1005, **kw).result(WAIT)  # never
        np.testing.assert_array_equal(d, ref)
    finally:
        eng2.shutdown()


def test_per_request_stop_sequences(model):
    p = _prompts(33, [5])[0]
    kw = dict(temperature=1.0, seed=4)
    eng = _engine(model)
    try:
        ref = eng.submit(p, 14, **kw).result(WAIT)
        for j in range(1, 11):
            sq = (int(ref[j]), int(ref[j + 1]))
            hits = [i for i in range(1, 13)
                    if (int(ref[i]), int(ref[i + 1])) == sq]
            if hits and hits[0] == j:
                break
        out = eng.submit(p, 14, stop=[list(sq)], **kw).result(WAIT)
        np.testing.assert_array_equal(out, ref[:j + 2])
        out2 = eng.submit(p, 14, stop=[[999] * 3, list(sq)], **kw).result(
            WAIT)
        np.testing.assert_array_equal(out2, out)
        out3 = eng.submit(p, 14, stop=[[999] * 2], **kw).result(WAIT)
        np.testing.assert_array_equal(out3, ref)
        got = list(eng.submit_stream(p, 14, stop=[list(sq)], **kw))
        np.testing.assert_array_equal(got, out)
    finally:
        eng.shutdown()


def test_submit_stream_yields_all_tokens_in_order(model):
    p = _prompts(32, [6])[0]
    eng = _engine(model, sync_chunks=2)
    try:
        got = list(eng.submit_stream(p, 13))
        np.testing.assert_array_equal(got, model.generate(p[None], 13)[0])
        sref = eng.submit(p, 13, temperature=1.0, seed=8).result(WAIT)
        stop_at = _first_new(sref)
        got2 = list(eng.submit_stream(p, 13, temperature=1.0, seed=8,
                                      eos_id=int(sref[stop_at])))
        np.testing.assert_array_equal(got2, sref[:stop_at + 1])
        it = eng.submit_stream(p, 9)
        fut = eng.submit(p, 9)
        np.testing.assert_array_equal(list(it), fut.result(WAIT))
    finally:
        eng.shutdown()


def test_threads_submitting_at_once(model):
    """More submitting threads than cores, a short switch interval: every
    request's tokens equal generate() of its prompt alone."""
    prompts = _prompts(61, [3, 5, 8, 11, 4, 6])
    want = [model.generate(p[None], 6)[0] for p in prompts]
    eng = _engine(model, slots=3)
    got = [None] * len(prompts)

    def worker(i):
        got[i] = eng.submit(prompts[i], 6).result(timeout=WAIT)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(prompts))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        eng.shutdown()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_dead_engine_fails_every_future(model):
    eng = _engine(model)

    def boom(*a, **k):
        raise RuntimeError("injected device failure")

    eng._chunk = boom
    try:
        fut = eng.submit([3, 5, 7], 8)
        queued = eng.submit([3, 5, 7, 9], 8)
        with pytest.raises(RuntimeError, match="injected"):
            fut.result(timeout=WAIT)
        with pytest.raises(RuntimeError):
            queued.result(timeout=WAIT)
        with pytest.raises(RuntimeError, match="shut down"):
            eng.submit([3, 5, 7], 8)
    finally:
        eng.shutdown(wait=False)


def test_decode_past_max_len_clamps_to_the_last_row(model):
    """Slot 1 overshoots max_len by 4 positions: its writes land in its own
    row max_len - 1, its codes stay valid u8, and slot 0 decodes exactly
    as alone."""
    T = model.max_len
    ids = torch.tensor(np.stack(_prompts(41, [T - 2, T - 2])).astype(
        np.int64))
    tok = torch.tensor([7, 9])
    with torch.no_grad():
        _, cache = model._prefill(Tensor(ids))
        alone, _ = model._decode_step(
            {i: (k[:1].clone(), v[:1].clone()) for i, (k, v) in
             cache.items()}, torch.tensor([T - 2]), tok[:1])
        before = {i: (k.clone(), v.clone()) for i, (k, v) in cache.items()}
        codes, cache = model._decode_step(cache, torch.tensor([T - 2, T + 3]),
                                          tok)
    assert codes.dtype == torch.uint8 and codes.shape == (2, 1000)
    assert torch.equal(codes[0], alone[0])
    for i, (k, v) in cache.items():
        for new, old in ((k, before[i][0]), (v, before[i][1])):
            assert torch.equal(new[1, :T - 1], old[1, :T - 1])
            assert torch.equal(new[0, T - 1:], old[0, T - 1:])
    with torch.no_grad():
        scalar, _ = model._decode_step(cache, torch.tensor(T + 5), tok)
    assert scalar.shape == (2, 1000)


def test_captured_counts_each_replay_not_the_capture(monkeypatch):
    """``graphs.Captured``'s launch accounting, with a stand-in for the CUDA
    capture: the eager first call counts what its wrappers launched, the
    capture (which runs nothing on the card) adds nothing, and each replay
    adds the launches that the capture recorded, exactly."""
    from int8inferenceengine_tpu_torch import graphs
    from int8inferenceengine_tpu_torch.ops import attention, gemm_int8

    qgemm, attn = gemm_int8.qgemm, attention.decode_attention_flat

    class Graph:
        def replay(self):
            pass

    def capture(fn, stream):
        fn()
        return Graph()

    def step():                     # a launching wrapper's counting
        qgemm.launches += 2
        attn.launches += 1

    monkeypatch.setattr(graphs, "capture", capture)
    monkeypatch.setattr(qgemm, "launches", 0)
    monkeypatch.setattr(attn, "launches", 0)
    program = graphs.Captured(step, stream=object())
    program()
    assert (qgemm.launches, attn.launches) == (2, 1)
    assert program.launches == {(qgemm, "launches"): 2,
                                (attn, "launches"): 1}
    for _ in range(3):
        program()
    assert (qgemm.launches, attn.launches, program.replays) == (8, 4, 3)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def card_model(ref):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the captured step has no CPU mode")
    m = tzoo.build("gpt_tiny")
    load_jax_state(m, ref["state"])
    return m


def _eager_loop(m, ids, steps):
    dev = m.device
    with torch.no_grad():
        codes, cache = m._prefill(Tensor(torch.tensor(
            ids.astype(np.int64), device=dev)))
        tok = codes.argmax(-1)
        out = [tok]
        pos = torch.full((), ids.shape[1], dtype=torch.int64, device=dev)
        for _ in range(1, steps):
            codes, cache = m._decode_step(cache, pos, tok)
            tok = codes.argmax(-1)
            out.append(tok)
            pos = pos + 1
    return torch.stack(out, 1).cpu().numpy()


@pytest.mark.cuda
def test_captured_generate_equals_eager_loop_on_card(card_model):
    ids = np.stack(_prompts(51, [9] * 4))
    np.testing.assert_array_equal(card_model.generate(ids, 20),
                                  _eager_loop(card_model, ids, 20))


@pytest.mark.cuda
def test_captured_generate_counts_every_step_on_card(card_model):
    """The wrappers' counts after ``generate(ids, s)``: the prefill alone
    (s = 1), one eager step more (s = 2), then one replay more for each
    step after it, each replay counting what the eager step launched."""
    from int8inferenceengine_tpu_torch.graphs import launch_counters
    ids = np.stack(_prompts(52, [9] * 4))
    counters = launch_counters()

    def counts(steps):
        for fn, attr in counters:
            setattr(fn, attr, 0)
        card_model.generate(ids, steps)
        return np.array([getattr(fn, attr) for fn, attr in counters])

    prefill, eager, replays = counts(1), counts(2), counts(20)
    step = eager - prefill
    assert step.sum() > 0
    np.testing.assert_array_equal(replays - eager, 18 * step)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, dict(overlap=True)])
def test_captured_engine_equals_generate_on_card(ref, card_model, kw):
    eng = GenerationEngine(card_model, slots=4, chunk_steps=4, **kw)
    try:
        for _ in range(2):             # the second pass replays the graph
            futs = [eng.submit(p, n) for p, (_, n) in
                    zip(ref["prompts"], CASES)]
            for fut, want in zip(futs, ref["tokens"]):
                np.testing.assert_array_equal(fut.result(timeout=WAIT), want)
        assert eng._chunk_fns[(False, False, False)].graph is not None
    finally:
        eng.shutdown()
