"""PyTorch port vs JAX package: the serving engine's chunked prefill
(``GenerationEngine(prefill_chunk=P)``) and prefix cache
(``register_prefix``, ``submit(prefix_id=)``, ``unregister_prefix``),
mirroring ``tests/test_prefix_cache.py`` and the ``prefill_chunk`` tests of
``tests/test_generation.py``.

The engine serves a gpt decoder (vocab 97, dim 64, depth 2, 4 heads,
max_len 64) carrying the JAX package's converted state:

* greedy requests give the JAX package's ``generate()`` tokens exactly:
  chunked prompts (longer than P, the last chunk sliding back near
  ``max_len``), prefixed ones (a suffix shorter than P, one sliding back
  over the prefix's rows) and concurrent slots sharing one prefix; and
  the port's own ``generate()`` tokens (equal to JAX's by
  ``test_torch_text_decoder``);
* a prefixed request equals the same prompt submitted cold, greedy and
  sampled (the first token drawn with the (seed, position) stream; the
  port's stream is not the JAX package's, so a sampled request is held to
  the port's ``generate()``);
* validation, the bounded prefix table, ``unregister_prefix``, the bounded
  seed programs, and a stale ``prefix_id`` failing only its own request;
* on the card (``cuda``-marked): chunked and prefixed requests equal
  ``generate()`` with the extend program captured once and replayed.

Every ``result()`` takes a timeout and every engine shuts down in a
``finally``.
"""

import numpy as np
import pytest
import torch

import int8inferenceengine_tpu as qj
from int8inferenceengine_tpu.models import zoo as jzoo
from int8inferenceengine_tpu.models.text_decoder import \
    torch_text_decoder as j_torch_text_decoder
from int8inferenceengine_tpu_torch.carry import load_jax_state
from int8inferenceengine_tpu_torch.models import zoo as tzoo
from int8inferenceengine_tpu_torch.serve import GenerationEngine
from test_torch_text_decoder import jax_state
from test_torch_threads import one_torch_thread  # noqa: F401

WAIT = 120
VOCAB = 97
GEO = dict(vocab_size=VOCAB, max_len=64, dim=64, depth=2, heads=4)
NEW = 7


def _tokens(seed, n):
    return np.random.default_rng(seed).integers(0, VOCAB, n).astype(np.int32)


PREFIX = _tokens(1, 21)
# prompts whose JAX generate() tokens the fixture holds, NEW tokens each
# (3 for the ones near max_len): three chunked at P = 8 and one on the
# bucketed path; PREFIX with suffixes of 1, 5 and 13 tokens; six requests
# sharing a 12-token prefix; one whose last chunk slides back at P = 6,
# and a 59-token prefix with 2 more tokens (its suffix chunk slides back
# over the prefix's rows)
CHUNKED = [_tokens(21 + i, n) for i, n in enumerate((20, 17, 5, 24))]
PREFIXED = [np.concatenate([PREFIX, _tokens(2 + n, n)]) for n in (1, 5, 13)]
SHARED = [np.concatenate([PREFIX[:12], _tokens(40 + i, 5)])
          for i in range(6)]
NEAR_END = _tokens(31, GEO["max_len"] - 3)
LONG_PREFIX = _tokens(3, GEO["max_len"] - 5)
PAST_PREFIX = np.concatenate([LONG_PREFIX, _tokens(4, 2)])


@pytest.fixture(scope="module")
def ref():
    """The JAX package's converted gpt and its generate() tokens of every
    prompt above, one call (one compile) per prompt length."""
    m = jzoo.build("gpt_tiny", **GEO)
    m.load(j_torch_text_decoder(**GEO).state_dict())
    m.prepare()
    m(qj.tensor(np.random.default_rng(0).integers(
        0, VOCAB, (2, 8)).astype(np.int32)))
    m.convert()
    by_len = {}
    for p in CHUNKED + PREFIXED + SHARED:
        by_len.setdefault((len(p), NEW), []).append(p)
    by_len[len(NEAR_END), 3] = [NEAR_END, PAST_PREFIX]
    want = {}
    for (_, steps), ps in by_len.items():
        for p, toks in zip(ps, np.asarray(m.generate(np.stack(ps), steps))):
            want[p.tobytes()] = toks
    return dict(state=jax_state(m), tokens=want)


def _want(ref, p):
    return ref["tokens"][np.asarray(p, np.int32).tobytes()]


@pytest.fixture(scope="module")
def model(ref):
    m = tzoo.build("gpt_tiny", device="cpu", **GEO)
    load_jax_state(m, ref["state"])
    return m


def _engine(model, **kw):
    return GenerationEngine(model, **{"slots": 2, "chunk_steps": 4,
                                      "prefill_chunk": 8, **kw})


def test_chunked_prefill_matches_jax_generate(ref, model):
    eng = _engine(model)
    try:
        futs = [eng.submit(p, NEW) for p in CHUNKED]
        for p, fut in zip(CHUNKED, futs):
            np.testing.assert_array_equal(fut.result(timeout=WAIT),
                                          _want(ref, p))
        assert eng.stats.prefills == len(CHUNKED)
    finally:
        eng.shutdown()


def test_chunked_prefill_near_max_len_slides_back(ref, model):
    p = 6
    assert -(-len(NEAR_END) // p) * p > GEO["max_len"]
    eng = _engine(model, slots=1, chunk_steps=2, prefill_chunk=p)
    try:
        np.testing.assert_array_equal(
            eng.submit(NEAR_END, 3).result(timeout=WAIT),
            _want(ref, NEAR_END))
    finally:
        eng.shutdown()


def test_prefix_bit_identical_to_cold_and_generate(ref, model):
    eng = _engine(model)
    try:
        pid = eng.register_prefix(PREFIX)
        for full in PREFIXED:              # incl. suffixes shorter than P
            a = eng.submit(full, NEW, prefix_id=pid).result(WAIT)
            b = eng.submit(full, NEW).result(WAIT)
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, _want(ref, full))
            np.testing.assert_array_equal(
                a, model.generate(full[None], NEW)[0])
        assert eng.stats.prefix_hits == 3
    finally:
        eng.shutdown()


def test_prefix_near_max_len_slide_back(ref, model):
    """A suffix chunk past max_len - P slides back over the prefix's rows,
    which it writes again with the same codes."""
    eng = _engine(model)
    try:
        pid = eng.register_prefix(LONG_PREFIX)
        np.testing.assert_array_equal(
            eng.submit(PAST_PREFIX, 3, prefix_id=pid).result(WAIT),
            _want(ref, PAST_PREFIX))
    finally:
        eng.shutdown()


def test_prefix_with_sampling_and_topp(model):
    eng = _engine(model)
    try:
        pid = eng.register_prefix(PREFIX[:16])
        full = np.concatenate([PREFIX[:16], _tokens(5, 5)])
        kw = dict(temperature=1.0, seed=4, top_p=0.8)
        a = eng.submit(full, 10, prefix_id=pid, **kw).result(WAIT)
        b = eng.submit(full, 10, **kw).result(WAIT)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            a, model.generate(full[None], 10, **kw)[0])
    finally:
        eng.shutdown()


def test_prefix_shared_across_concurrent_slots(ref, model):
    eng = _engine(model, slots=4)
    try:
        pid = eng.register_prefix(PREFIX[:12])
        futs = [eng.submit(p, NEW, prefix_id=pid)          # > 4 slots
                for p in SHARED]
        for p, f in zip(SHARED, futs):
            np.testing.assert_array_equal(f.result(WAIT), _want(ref, p))
    finally:
        eng.shutdown()


def test_prefix_validation(model):
    eng = _engine(model)
    try:
        prefix = PREFIX[:10]
        pid = eng.register_prefix(prefix)
        with pytest.raises(ValueError, match="EXTEND"):
            eng.submit(prefix, 4, prefix_id=pid)
        with pytest.raises(ValueError, match="start with"):
            eng.submit(np.concatenate([(prefix + 1) % VOCAB, prefix[:2]]),
                       4, prefix_id=pid)
        with pytest.raises(ValueError, match="unknown"):
            eng.submit([1, 2, 3], 4, prefix_id=999)
        with pytest.raises(ValueError, match="empty"):
            eng.register_prefix([])
        with pytest.raises(ValueError, match="no room"):
            eng.register_prefix(np.zeros(GEO["max_len"], np.int32))
    finally:
        eng.shutdown()
    eng2 = GenerationEngine(model, slots=2)          # no prefill_chunk
    try:
        with pytest.raises(ValueError, match="prefill_chunk"):
            eng2.register_prefix([1, 2, 3])
    finally:
        eng2.shutdown()
    for p in (0, GEO["max_len"] + 1):
        with pytest.raises(ValueError, match="prefill_chunk"):
            GenerationEngine(model, prefill_chunk=p)


def test_prefix_table_cap_and_unregister(model):
    """The table is bounded, unregister frees an entry and makes its id
    stale, and ids are never reused."""
    eng = _engine(model, max_prefixes=2)
    try:
        p1 = eng.register_prefix(_tokens(5, 9))
        p2 = eng.register_prefix(_tokens(6, 11))
        with pytest.raises(RuntimeError, match="full"):
            eng.register_prefix(_tokens(7, 5))
        eng.unregister_prefix(p1)
        with pytest.raises(ValueError, match="unknown"):
            eng.unregister_prefix(p1)
        p3 = eng.register_prefix(_tokens(8, 7))
        assert p3 not in (p1, p2)
        with pytest.raises(ValueError, match="unknown"):
            eng.submit(np.arange(12, dtype=np.int32), 4, prefix_id=p1)
        full = np.concatenate([_tokens(6, 11), _tokens(9, 4)])
        np.testing.assert_array_equal(
            eng.submit(full, 6, prefix_id=p2).result(WAIT),
            model.generate(full[None], 6)[0])
    finally:
        eng.shutdown()


def test_seed_fn_cache_capped(model):
    eng = _engine(model)
    try:
        eng._SEED_FN_CAP = 3
        for n in (3, 5, 7, 9, 11):                 # 5 distinct lengths
            pre = _tokens(50 + n, n)
            pid = eng.register_prefix(pre)
            full = np.concatenate([pre, _tokens(60 + n, 2)])
            np.testing.assert_array_equal(
                eng.submit(full, 4, prefix_id=pid).result(WAIT),
                model.generate(full[None], 4)[0])
        assert len(eng._seed_fns) <= 3
    finally:
        eng.shutdown()


def test_stale_prefix_fails_only_that_request(model):
    eng = _engine(model, slots=1)
    try:
        pre = _tokens(11, 9)
        pid = eng.register_prefix(pre)
        full = np.concatenate([pre, _tokens(12, 3)])
        # the only slot is busy, so the prefixed request queues; its
        # prefix goes before it is admitted
        blocker = eng.submit(_tokens(13, 4), 24)
        victim = eng.submit(full, 6, prefix_id=pid)
        eng.unregister_prefix(pid)
        blocker.result(WAIT)
        with pytest.raises(ValueError, match="unregistered"):
            victim.result(timeout=WAIT)
        np.testing.assert_array_equal(eng.submit(full, 6).result(WAIT),
                                      model.generate(full[None], 6)[0])
    finally:
        eng.shutdown()


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_captured_extend_program_on_card(cuda_device, ref):
    m = tzoo.build("gpt_tiny", device=cuda_device, **GEO)
    load_jax_state(m, ref["state"])
    eng = _engine(m)
    try:
        futs = [eng.submit(p, NEW) for p in CHUNKED]
        for p, fut in zip(CHUNKED, futs):
            np.testing.assert_array_equal(fut.result(timeout=WAIT),
                                          _want(ref, p))
        pid = eng.register_prefix(PREFIX)
        for p in PREFIXED:
            np.testing.assert_array_equal(
                eng.submit(p, NEW, prefix_id=pid).result(WAIT),
                _want(ref, p))
        # one program, captured after its first chunk, replayed since
        assert eng._extend_program.replays > 0
    finally:
        eng.shutdown()
