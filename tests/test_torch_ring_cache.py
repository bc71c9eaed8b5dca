"""PyTorch port vs JAX package: the ring KV cache of windowed layers
(``ring_cache=True``), mirroring ``tests/test_ring_cache.py`` at its size
(vocab 97, max_len 96, dim 64, depth 2, 4 heads, window 8, 'nearest').

A windowed layer's cache holds R = roundup32(2W) = 32 rows; its base moves
by S = R - W = 24 whenever the rows fill, at positions 32, 56 and 80.  The
port writes each step's row twice instead of copying the window when the
base moves (``TextDecoder._write_rows``), so:

* greedy tokens equal the full-length cache's bit for bit across two and
  three base moves, short and long (50 > R) prompts, and equal the JAX
  package's ring's (carried state); so do sampled tokens (the port's own
  stream, ring against full);
* a prompt's ring tail (``_ring_tail``) equals the rows that a shorter
  prompt and decode steps leave, on every row a later step can read;
* ``_ring_base`` is the JAX closed form, floor division included;
* gemma's interleave: odd blocks ring, even blocks full;
* the engine: ring slot caches, every request equal to ``generate()``
  (prompts shorter and longer than the ring, slots at different phases),
  gemma's per-layer shapes, sampled requests; chunked prefill and the
  prefix cache refused with a ring model;
* the guards: ``ring_cache`` without a window, extends over a ring.

Every comparison is equality.  The ``cuda``-marked tests (a card only)
hold B3 at gemma-2's attention shape against its plain version and a small
ring decoder on the card against a CPU copy.
"""

import numpy as np
import pytest
import torch

import int8inferenceengine_tpu as qj
from int8inferenceengine_tpu.models import zoo as jzoo
from int8inferenceengine_tpu.models.llama import torch_llama as j_torch_llama
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch.carry import export_state, load_jax_state
from int8inferenceengine_tpu_torch.models import zoo as tzoo
from int8inferenceengine_tpu_torch.models.gemma import torch_gemma
from int8inferenceengine_tpu_torch.models.llama import torch_llama
from int8inferenceengine_tpu_torch.models.text_decoder import TextDecoder
from int8inferenceengine_tpu_torch.ops import attention as TA
from int8inferenceengine_tpu_torch.serve import GenerationEngine
from int8inferenceengine_tpu_torch.tensor import Tensor as TT
from test_torch_text_decoder import jax_state
from test_torch_threads import one_torch_thread  # noqa: F401

GEO = dict(vocab_size=97, max_len=96, dim=64, depth=2, heads=4,
           sliding_window=8)
NEAREST = dict(rounding="nearest")
TWINS = {"llama_tiny": torch_llama, "gemma_tiny": torch_gemma}


def _ids(b, t, seed):
    return np.random.default_rng(seed).integers(
        0, GEO["vocab_size"], (b, t)).astype(np.int32)


def _build(fam, ring, device="cpu", **kw):
    geo = dict(GEO, kv_heads=2, **kw)
    m = tzoo.build(fam, ring_cache=ring, config=qt.QuantConfig(**NEAREST),
                   device=device, **geo)
    m.load(TWINS[fam](**geo).state_dict())
    m.prepare()
    m(qt.tensor(_ids(2, 8, 0), device=device))
    m.convert()
    return m


@pytest.fixture(scope="module")
def pair():
    """The port's llama ring model and the same state without the ring."""
    ring = _build("llama_tiny", True)
    full = tzoo.build("llama_tiny", config=qt.QuantConfig(**NEAREST),
                      device="cpu", **GEO, kv_heads=2)
    load_jax_state(full, export_state(ring))
    return ring, full


@pytest.fixture(scope="module")
def jax_ring():
    """The JAX package's llama ring model: its converted state and its
    greedy tokens across the wraps, from a short and a long prompt."""
    geo = dict(GEO, kv_heads=2)
    jm = jzoo.build("llama_tiny", ring_cache=True,
                    config=qj.QuantConfig(**NEAREST), **geo)
    jm.load(j_torch_llama(**geo).state_dict())
    jm.prepare()
    jm(qj.tensor(_ids(2, 8, 0)))
    jm.convert()
    assert jm._cache_rows(1) == 32
    short, long = _ids(2, 6, 1), _ids(2, 50, 2)
    return dict(state=jax_state(jm), short=short, long=long,
                short_tokens=np.asarray(jm.generate(short, 70)),
                long_tokens=np.asarray(jm.generate(long, 40)))


def test_ring_rows_shrink(pair):
    ring, full = pair
    assert [ring._cache_rows(i) for i in (1, 2)] == [32, 32]
    assert [full._cache_rows(i) for i in (1, 2)] == [96, 96]
    g = tzoo.build("gemma_tiny", ring_cache=True, device="cpu", **GEO)
    assert [g._cache_rows(i) for i in (1, 2)] == [32, 96]
    wide = tzoo.build("mistral_tiny", ring_cache=True, device="cpu",
                      **dict(GEO, sliding_window=40))
    assert wide._cache_rows(1) == 96          # roundup32(80) = 96 = max_len


def test_ring_base_closed_form():
    rows, window = 32, 8
    pos = torch.arange(-1, 200)
    s = rows - window
    want = [s * max(0, 1 + (p - rows) // s) for p in range(-1, 200)]
    got = TextDecoder._ring_base(pos, rows, window)
    assert got.tolist() == want
    r = pos[1:] - got[1:]
    assert int(r.max()) < rows and int(r[rows:].min()) >= window


def test_ring_tokens_equal_full_and_jax_across_wraps(pair, jax_ring):
    """Positions 6..75 move the base at 32 and 56."""
    ring, full = pair
    got = ring.generate(jax_ring["short"], 70)
    np.testing.assert_array_equal(got, full.generate(jax_ring["short"], 70))
    carried = tzoo.build("llama_tiny", ring_cache=True,
                         config=qt.QuantConfig(**NEAREST), device="cpu",
                         **GEO, kv_heads=2)
    load_jax_state(carried, jax_ring["state"])
    np.testing.assert_array_equal(carried.generate(jax_ring["short"], 70),
                                  jax_ring["short_tokens"])


def test_ring_long_prompt_prefill_tail(pair, jax_ring):
    """A 50-token prompt keeps the tail of its 50 rows (base 24), then
    moves the base at 56 and 80."""
    ring, full = pair
    np.testing.assert_array_equal(ring.generate(jax_ring["long"], 40),
                                  full.generate(jax_ring["long"], 40))
    carried = tzoo.build("llama_tiny", ring_cache=True,
                         config=qt.QuantConfig(**NEAREST), device="cpu",
                         **GEO, kv_heads=2)
    load_jax_state(carried, jax_ring["state"])
    np.testing.assert_array_equal(carried.generate(jax_ring["long"], 40),
                                  jax_ring["long_tokens"])


@pytest.mark.parametrize("t0,t", [(5, 31), (20, 57), (33, 80), (50, 61)])
def test_ring_tail_equals_decode_steps(pair, t0, t):
    """The ring after a t-token prompt equals the ring after its first t0
    tokens and t - t0 decode steps on every row that a later step reads
    (rows [0, t - base), base the ring base of position t - 1)."""
    ring, _ = pair
    ids = torch.tensor(_ids(2, t, 5), dtype=torch.int64)
    with torch.no_grad():
        _, want = ring._prefill(TT(ids))
        _, got = ring._prefill(TT(ids[:, :t0]))
        for p in range(t0, t):
            ring._decode_step(got, p, ids[:, p])
    live = t - int(TextDecoder._ring_base(torch.tensor(t - 1), 32, 8))
    for i in (1, 2):
        for a, b in zip(got[i], want[i]):
            assert a.shape == b.shape == (2, 32, 32)
            assert torch.equal(a[:, :live], b[:, :live]), (i, live)


def test_ring_gemma_mixed_local_global():
    ring = _build("gemma_tiny", True)
    full = tzoo.build("gemma_tiny", config=qt.QuantConfig(**NEAREST),
                      device="cpu", **GEO, kv_heads=2)
    load_jax_state(full, export_state(ring))
    ids = _ids(2, 6, 3)
    np.testing.assert_array_equal(ring.generate(ids, 70),
                                  full.generate(ids, 70))


def test_ring_sampling_rides(pair):
    ring, full = pair
    ids = _ids(2, 6, 4)
    kw = dict(temperature=1.0, top_p=0.8, seed=2)
    np.testing.assert_array_equal(ring.generate(ids, 40, **kw),
                                  full.generate(ids, 40, **kw))


def test_ring_engine_ring_slot_caches(pair):
    """Ring-sized slot caches; prompts within the ring and longer than it
    (40 > 32, the per-row tail), admitted together so that the slots move
    their bases at different steps."""
    ring, _ = pair
    eng = GenerationEngine(ring, slots=4, chunk_steps=4, sync_chunks=2)
    try:
        assert eng._ring_serving
        assert [eng._caches[i][0].shape[1] for i in (1, 2)] == [32, 32]
        rng = np.random.default_rng(9)
        prompts = [np.asarray([3, 5, 7], np.int32)] + [
            rng.integers(0, 97, (n,)).astype(np.int32) for n in (17, 40, 9)]
        outs = [f.result(timeout=120)
                for f in [eng.submit(p, 40) for p in prompts]]
    finally:
        eng.shutdown()
    for p, o in zip(prompts, outs):
        np.testing.assert_array_equal(o, ring.generate(p[None], 40)[0])


def test_ring_engine_gemma_interleave():
    g = _build("gemma_tiny", True)
    eng = GenerationEngine(g, slots=2, chunk_steps=4)
    try:
        assert [eng._caches[i][0].shape[1] for i in (1, 2)] == [32, 96]
        p = _ids(1, 11, 10)[0]
        out = eng.submit(p, 30).result(timeout=120)
    finally:
        eng.shutdown()
    np.testing.assert_array_equal(out, g.generate(p[None], 30)[0])


def test_ring_engine_sampled_and_guard(pair):
    ring, _ = pair
    with pytest.raises(ValueError, match="prefill_chunk"):
        GenerationEngine(ring, slots=2, prefill_chunk=8)
    eng = GenerationEngine(ring, slots=2, chunk_steps=4)
    try:
        kw = dict(temperature=1.0, seed=4, top_p=0.8)
        s = eng.submit([3, 5, 7], 40, **kw).result(timeout=120)
        with pytest.raises(ValueError, match="prefill_chunk"):
            eng.register_prefix([3, 5, 7])
    finally:
        eng.shutdown()
    np.testing.assert_array_equal(
        s, ring.generate(np.asarray([[3, 5, 7]]), 40, **kw)[0])


def test_ring_guards(pair):
    for fam in ("llama_tiny", "gemma_tiny"):
        with pytest.raises(ValueError, match="sliding_window"):
            tzoo.build(fam, device="cpu", ring_cache=True,
                       **dict(GEO, sliding_window=None))
    ring, full = pair
    with pytest.raises(NotImplementedError, match="RING"):
        ring.generate_speculative(full, _ids(2, 6, 5), 10)


# -- on the card --------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: kernel B3 runs only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("t", [8192, 16384])
def test_b3_at_gemma2_shape_matches_plain_on_card(card, t):
    """B3 at gemma-2's attention (D 256, 8 heads over 4, window 4,096,
    softcap 50) against its plain version: at most 1 code on 0.2% (the
    softcap's tanh and the exp)."""
    gen = torch.Generator(device=card).manual_seed(0)
    b, h, kv, d = 2, 8, 4, 256
    q = torch.randint(0, 256, (b, h * d), generator=gen, dtype=torch.uint8,
                      device=card)
    k, v = (torch.randint(0, 256, (b, t, kv * d), generator=gen,
                          dtype=torch.uint8, device=card) for _ in range(2))
    kw = dict(scale_q=0.021, zp_q=117, scale_k=0.034, zp_k=131,
              scale_v=0.027, zp_v=125, scale_s=0.4, zp_s=140,
              scale_p=0.0039, zp_p=0, scale_c=0.05, zp_c=128, alpha=1 / 16,
              n_heads=h, n_kv_heads=kv, window=4096, softcap=50.0)
    for valid in (1, 4095, 4096, 4097, t - 1):
        got = TA.decode_attention_flat(q, k, v, valid, **kw)
        want = TA.decode_attention_flat(q, k, v, valid, backend="xla", **kw)
        diff = (got.int() - want.int()).abs()
        assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) \
            <= 0.002, valid


@pytest.mark.cuda
def test_ring_decoder_on_card_equals_cpu(card):
    """A small ring gemma calibrated on the card, a CPU copy of its state:
    greedy tokens across the base moves equal."""
    m = _build("gemma_tiny", True, device=card)
    cpu = tzoo.build("gemma_tiny", ring_cache=True,
                     config=qt.QuantConfig(**NEAREST), device="cpu", **GEO,
                     kv_heads=2)
    load_jax_state(cpu, export_state(m))
    ids = _ids(2, 6, 1)
    np.testing.assert_array_equal(m.generate(ids, 70), cpu.generate(ids, 70))
