"""PyTorch port vs JAX package: the head-split float KV cache of the
weight-only modes (W8-float, ``dynamic_act``, W4), at a tiny size (vocab
97, max_len 48, dim 64, depth 2, 4 heads; llama and gemma over 2 kv heads,
gemma with a window of 8 on block 1).

* gpt_tiny, llama_tiny (GQA) and gemma_tiny (window and softcaps) in all
  three modes, with the JAX package's converted state carried over: the
  greedy tokens of a 7-token prompt's 10 steps equal JAX's ``generate()``,
  and the port's own cached decode equals its full recompute token for
  token;
* the float extend: m = 5 rows give the logits and the cache rows of 5
  decode steps (within 1e-5 of the largest |logit|; tokens equal), with a
  per-row position vector too;
* weight-only speculative decoding equals ``generate()`` (a weight-only
  draft, and an INT8 draft for a weight-only target);
* the ring rules copied from the JAX package: a float ring in
  ``generate()`` gives the full-length cache's tokens across the ring
  base's moves, and JAX's ring tokens; a weight-only ring model's engine
  keeps full-length float slot caches and equals ``generate()`` on a
  prompt longer than the ring; a serving prefill of right-padded prompts
  longer than a float ring raises ``NotImplementedError`` in both
  packages, and so does an extend over a ring.
"""

import numpy as np
import pytest
import torch

import int8inferenceengine_tpu as qj
from int8inferenceengine_tpu.models import zoo as jzoo
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch.carry import load_jax_state
from int8inferenceengine_tpu_torch.models import zoo as tzoo
from int8inferenceengine_tpu_torch.models.gemma import torch_gemma
from int8inferenceengine_tpu_torch.models.llama import torch_llama
from int8inferenceengine_tpu_torch.models.text_decoder import \
    torch_text_decoder
from int8inferenceengine_tpu_torch.serve import GenerationEngine
from int8inferenceengine_tpu_torch.tensor import Tensor
from test_torch_text_decoder import jax_state
from test_torch_threads import one_torch_thread  # noqa: F401

VOCAB = 97
GEO = {"gpt_tiny": dict(vocab_size=VOCAB, max_len=48, dim=64, depth=2,
                        heads=4),
       "llama_tiny": dict(vocab_size=VOCAB, max_len=48, dim=64, depth=2,
                          heads=4, kv_heads=2),
       "gemma_tiny": dict(vocab_size=VOCAB, max_len=48, dim=64, depth=2,
                          heads=4, kv_heads=2, sliding_window=8)}
TWINS = {"gpt_tiny": torch_text_decoder, "llama_tiny": torch_llama,
         "gemma_tiny": torch_gemma}
MODES = {"w8f": dict(weight_only=True),
         "dynamic": dict(weight_only=True, dynamic_act=True),
         "w4": dict(weight_only=True, weight_bits=4)}


def _ids(b, t, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, t)).astype(
        np.int32)


def _sd(fam, geo=None):
    return TWINS[fam](**(geo or GEO[fam])).state_dict()


def _port(fam, mode, geo=None, **kw):
    m = tzoo.build(fam, config=qt.QuantConfig(**MODES[mode]), device="cpu",
                   **(geo or GEO[fam]), **kw)
    m.load(_sd(fam, geo))
    m.convert()
    return m


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("fam", list(GEO))
def test_generate_equals_jax_and_recompute(fam, mode):
    jm = jzoo.build(fam, config=qj.QuantConfig(**MODES[mode]), **GEO[fam])
    jm.load(_sd(fam))
    jm.convert()
    prompt = _ids(2, 7, 5)
    want = np.asarray(jm.generate(prompt, 10))
    m = tzoo.build(fam, config=qt.QuantConfig(**MODES[mode]), device="cpu",
                   **GEO[fam])
    load_jax_state(m, jax_state(jm))
    got = m.generate(prompt, 10)
    np.testing.assert_array_equal(got, want)
    seq = prompt.copy()
    for s in range(10):
        nxt = m(qt.tensor(seq, device="cpu")).numpy()[:, -1].argmax(-1)
        np.testing.assert_array_equal(got[:, s], nxt, f"step {s}")
        seq = np.concatenate([seq, nxt[:, None].astype(np.int32)], 1)


def _clone(cache):
    return {i: (k.clone(), v.clone()) for i, (k, v) in cache.items()}


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("fam", ["llama_tiny", "gemma_tiny"])
def test_float_extend_equals_steps(fam, mode, per_row):
    m = _port(fam, mode)
    prompt = torch.tensor(_ids(2, 6, 1).astype(np.int64))
    toks = torch.tensor(_ids(2, 5, 2).astype(np.int64))
    with torch.no_grad():
        _, cache = m._prefill(Tensor(prompt))
        assert cache[1][0].dtype == torch.float32
        assert tuple(cache[1][0].shape) == (2, m.kv_heads, m.max_len,
                                            m.head_dim)
        steps_cache = _clone(cache)
        pos = torch.tensor([6, 6]) if per_row else torch.tensor(6)
        ext, _ = m._extend_step(cache, pos, toks)
        rows = []
        for j in range(5):
            out, _ = m._decode_step(steps_cache, pos + j, toks[:, j])
            rows.append(out)
    steps = torch.stack(rows, 1)
    tol = 1e-5 * float(steps.abs().max())
    torch.testing.assert_close(ext, steps, rtol=0, atol=tol)
    assert torch.equal(ext.argmax(-1), steps.argmax(-1))
    for i in cache:
        for a, b in zip(cache[i], steps_cache[i]):
            torch.testing.assert_close(a, b, rtol=0,
                                       atol=1e-5 * float(b.abs().max()))


@pytest.mark.parametrize("mode", list(MODES))
def test_float_speculative_equals_generate(mode):
    target = _port("llama_tiny", mode)
    draft = _port("gpt_tiny", mode)
    ids = _ids(3, 6, 7)
    want = target.generate(ids, 12)
    np.testing.assert_array_equal(
        target.generate_speculative(draft, ids, 12, k=3), want)
    np.testing.assert_array_equal(
        target.generate_speculative(target, ids, 12, k=4), want)
    if mode == "w8f":
        # a static INT8 draft for a weight-only target
        int8 = tzoo.build("gpt_tiny", config=qt.QuantConfig(
            rounding="nearest"), device="cpu", **GEO["gpt_tiny"])
        int8.load(_sd("gpt_tiny"))
        int8.prepare()
        int8(qt.tensor(_ids(2, 16, 0), device="cpu"))
        int8.convert()
        np.testing.assert_array_equal(
            target.generate_speculative(int8, ids, 12, k=2), want)


RING_GEO = dict(vocab_size=VOCAB, max_len=96, dim=64, depth=2, heads=4,
                kv_heads=2, sliding_window=8)


@pytest.mark.parametrize("mode", list(MODES))
def test_float_ring_generate_equals_full_cache(mode):
    """A ring gemma's float rows (32 rows for window 8: the base moves at
    32, 56 and 80) give the full-length cache's tokens, on prompts shorter
    and longer than the ring."""
    full = _port("gemma_tiny", mode, RING_GEO)
    ring = _port("gemma_tiny", mode, RING_GEO, ring_cache=True)
    assert ring._cache_rows(1) == 32 and ring._cache_rows(2) == 96
    for t0, steps in ((5, 80), (40, 50)):
        ids = _ids(2, t0, t0)
        np.testing.assert_array_equal(ring.generate(ids, steps),
                                      full.generate(ids, steps))
    with torch.no_grad():
        _, cache = ring._prefill(Tensor(torch.tensor(_ids(1, 5, 0)).long()))
    assert tuple(cache[1][0].shape) == (1, 2, 32, 16)


def test_float_ring_tokens_equal_jax():
    fam, cfg = "gemma_tiny", MODES["w8f"]
    jm = jzoo.build(fam, config=qj.QuantConfig(**cfg), ring_cache=True,
                    **RING_GEO)
    jm.load(_sd(fam, RING_GEO))
    jm.convert()
    ids = _ids(2, 5, 3)
    want = np.asarray(jm.generate(ids, 60))
    m = tzoo.build(fam, config=qt.QuantConfig(**cfg), ring_cache=True,
                   device="cpu", **RING_GEO)
    load_jax_state(m, jax_state(jm))
    np.testing.assert_array_equal(m.generate(ids, 60), want)
    # JAX's serving prefill refuses right-padded prompts beyond a float
    # ring, and so does the port's
    long = _ids(2, 40, 4)
    lens = np.asarray([40, 33], np.int32)
    with pytest.raises(NotImplementedError, match="ring"):
        jm._prefill(qj.Tensor(np.asarray(long, np.float32)), last=lens)
    with pytest.raises(NotImplementedError, match="ring"):
        m._prefill(Tensor(torch.tensor(long).long()),
                   last=torch.tensor(lens).long())


def test_float_ring_engine_keeps_full_caches():
    """The JAX package's ``test_ring_engine_weight_only_full_caches``:
    full-length float slot caches, and a prompt longer than the ring
    serves equal to ``generate()``."""
    d = _port("llama_tiny", "w8f", dict(RING_GEO), ring_cache=True)
    assert d._cache_rows(1) == 32
    eng = GenerationEngine(d, slots=2, chunk_steps=4)
    try:
        assert not eng._ring_serving
        assert eng._caches[1][0].shape[2] == 96          # full length
        assert eng._caches[1][0].dtype == torch.float32
        p = _ids(1, 40, 12)[0]
        out = eng.submit(p, 8).result(timeout=120)
        np.testing.assert_array_equal(out, d.generate(p[None], 8)[0])
    finally:
        eng.shutdown()
    with pytest.raises(NotImplementedError, match="RING"):
        d.generate_speculative(d, _ids(1, 6, 0), 8)
