"""PyTorch port vs JAX package: sampling on the u8 logit grid.

The same numpy codes go through the JAX package's ``code_histogram``,
``nucleus_code_floor`` and ``topk_code_floor`` and the port's, over several
p, k and s/T, alone and composed (top-k, then top-p over the kept classes):
the histograms and the floors are equal **exactly** (the port adds the
nucleus mass in XLA:CPU's cumsum order).

Given the same uniform noise, the port's ``pick_u8`` equals the JAX
package's ``GenerationEngine._pick`` **exactly**, token for token, on
greedy, temperature-only, top-k, top-p and composed rows.  JAX's noise is
fed by replacing ``jax.random.fold_in``/``jax.random.uniform`` inside the
test only, so that its draw reads row ``pos`` of a [positions, V] table,
and the port's by replacing its ``uniform_hash`` with the same lookup.

Also: the port's own draw (``uniform_hash``) is uniform in [1e-7, 1),
deterministic and keyed by (seed, position); and ``generate()`` raises
the JAX package's errors on the same bad arguments.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import int8inferenceengine_tpu as qj
from int8inferenceengine_tpu.models import text_decoder as JTD
from int8inferenceengine_tpu.models import zoo as jzoo
from int8inferenceengine_tpu.serve.generation import (
    GenerationEngine as JaxEngine)
from int8inferenceengine_tpu_torch.carry import load_jax_state
from int8inferenceengine_tpu_torch.models import text_decoder as TTD
from int8inferenceengine_tpu_torch.models import zoo as tzoo
from test_torch_text_decoder import jax_state
from test_torch_threads import one_torch_thread  # noqa: F401

V = 1000


def _codes(seed, b=6):
    """u8 logit codes with a peaked top, as a head's codes are: most
    tokens low, a few classes near the maximum."""
    rng = np.random.default_rng(seed)
    base = rng.normal(110, 18, (b, V))
    hot = rng.random((b, V)) < 0.02
    base[hot] += rng.uniform(30, 120, hot.sum())
    return np.clip(base, 0, 255).astype(np.uint8)


def _both(codes):
    return jnp.asarray(codes), torch.tensor(codes)


@pytest.mark.parametrize("seed", [0, 1])
def test_histogram_equals_jax(seed):
    jc, tc = _both(_codes(seed))
    want = np.asarray(JTD.code_histogram(jc))
    got = TTD.code_histogram(tc).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [0.05, 0.5, 0.9, 0.99, 1.0])
@pytest.mark.parametrize("s_over_t", [0.02, 0.1, 0.7])
def test_nucleus_floor_equals_jax(p, s_over_t):
    codes = _codes(3)
    jc, tc = _both(codes)
    b = codes.shape[0]
    sot = np.full((b,), s_over_t, np.float32) * np.linspace(
        0.5, 1.5, b).astype(np.float32)
    pp = np.full((b,), p, np.float32)
    want = np.asarray(JTD.nucleus_code_floor(jc, jnp.asarray(sot),
                                             jnp.asarray(pp)))
    got = TTD.nucleus_code_floor(tc, torch.tensor(sot), torch.tensor(pp))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    if p < 1.0:
        assert len(np.unique(want)) > 1 or want.min() > 0


@pytest.mark.parametrize("k", [1, 5, 40, 500, 5000])
def test_topk_floor_equals_jax(k):
    codes = _codes(4)
    jc, tc = _both(codes)
    kk = np.full((codes.shape[0],), k, np.int32)
    want = np.asarray(JTD.topk_code_floor(jc, jnp.asarray(kk)))
    got = TTD.topk_code_floor(tc, torch.tensor(kk.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)
    # the static semantics: the k-th largest code, ties kept
    if k <= V:
        kth = -np.sort(-codes, -1)[:, k - 1]
        np.testing.assert_array_equal(want, kth)


@pytest.mark.parametrize("k,p", [(5, 0.5), (40, 0.9), (200, 0.3)])
def test_composed_floors_equal_jax(k, p):
    """top-k then top-p: the nucleus over the kept tokens, by ``keep``
    and by the class-masked histogram alike."""
    codes = _codes(5)
    jc, tc = _both(codes)
    b = codes.shape[0]
    kk = np.full((b,), k, np.int32)
    sot = np.full((b,), 0.08, np.float32)
    pp = np.full((b,), p, np.float32)
    jfl = JTD.topk_code_floor(jc, jnp.asarray(kk))
    tfl = TTD.topk_code_floor(tc, torch.tensor(kk.astype(np.int64)))
    want = np.asarray(JTD.nucleus_code_floor(
        jc, jnp.asarray(sot), jnp.asarray(pp), keep=jc >= jfl[:, None]))
    got = TTD.nucleus_code_floor(tc, torch.tensor(sot), torch.tensor(pp),
                                 keep=tc >= tfl[:, None])
    np.testing.assert_array_equal(got.numpy(), want)
    hist = TTD.code_histogram(tc)
    vcls = torch.arange(256, dtype=torch.uint8)
    masked = hist * (vcls[None, :] >= tfl[:, None])
    np.testing.assert_array_equal(
        TTD.nucleus_code_floor(tc, torch.tensor(sot), torch.tensor(pp),
                               hist=masked).numpy(), want)


SCALE, ZP = 0.0731, 97


def test_pick_equals_jax_engine_pick_given_the_same_noise(monkeypatch):
    """Rows: greedy; temperature only; top-k; top-p; top-k and top-p;
    a second temperature.  The same [positions, V] uniforms feed both."""
    codes = _codes(6)
    b = codes.shape[0]
    pos = np.arange(b, dtype=np.int32) * 3 + 5
    table = np.random.default_rng(9).uniform(
        1e-7, 1.0, (int(pos.max()) + 1, V)).astype(np.float32)
    temps = np.array([0.0, 0.7, 1.0, 0.8, 1.3, 0.4], np.float32)
    topps = np.array([1.0, 1.0, 1.0, 0.6, 0.9, 1.0], np.float32)
    topks = np.array([0, 0, 20, 0, 50, 0], np.int32)

    jtable = jnp.asarray(table)
    monkeypatch.setattr(jax.random, "fold_in", lambda key, p: p)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, minval, maxval: jtable[key])
    stub = types.SimpleNamespace(model=types.SimpleNamespace(
        _head_scale_zp=lambda: (SCALE, ZP)))
    keys = jnp.zeros((b, 2), jnp.uint32)
    want = np.asarray(JaxEngine._pick(
        stub, jnp.asarray(codes), jnp.asarray(temps), keys,
        jnp.asarray(pos), jnp.asarray(topps), jnp.asarray(topks)))

    monkeypatch.setattr(TTD, "uniform_hash",
                        lambda seeds, p, vocab: torch.tensor(table)[p])
    got = TTD.pick_u8(torch.tensor(codes), SCALE, ZP, torch.tensor(temps),
                      torch.zeros(b, dtype=torch.int64),
                      torch.tensor(pos.astype(np.int64)),
                      torch.tensor(topps), torch.tensor(topks.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == codes[0].argmax()
    assert len(set(got.tolist())) > 3


def test_uniform_hash_is_a_keyed_uniform_stream():
    seeds = torch.tensor([0, 0, 7, 2 ** 32 - 1], dtype=torch.int64)
    pos = torch.tensor([5, 6, 5, 5], dtype=torch.int64)
    u = TTD.uniform_hash(seeds, pos, 50_000)
    assert u.dtype == torch.float32 and u.shape == (4, 50_000)
    assert float(u.min()) >= np.float32(1e-7) and float(u.max()) < 1.0
    assert torch.equal(u, TTD.uniform_hash(seeds, pos, 50_000))
    for a, b in ((0, 1), (0, 2), (0, 3)):
        assert not torch.equal(u[a], u[b])
    m = u.double().mean(-1)
    assert bool(((m - 0.5).abs() < 0.01).all()), m
    rows = TTD.row_seeds(7, 3, "cpu")
    assert int(rows[0]) == 7 and len(set(rows.tolist())) == 3


GEO = dict(vocab_size=64, max_len=16, dim=32, depth=1, heads=2)


@pytest.fixture(scope="module")
def tiny():
    """A tiny converted JAX decoder and the port's copy of its state."""
    jm = jzoo.build("gpt_tiny", **GEO)
    jm.load(JTD.torch_text_decoder(**GEO).state_dict())
    jm.prepare()
    jm(qj.tensor(np.random.default_rng(0).integers(
        0, GEO["vocab_size"], (4, 16)).astype(np.int32)))
    jm.convert()
    tm = tzoo.build("gpt_tiny", device="cpu", **GEO)
    load_jax_state(tm, jax_state(jm))
    return jm, tm


@pytest.mark.parametrize("args,kw", [
    ((np.zeros((1, 4), np.int32), 0), {}),
    ((np.zeros((1, 10), np.int32), 7), {}),
    ((np.zeros((1, 4), np.int32), 3), dict(temperature=0.5, top_p=0.0)),
    ((np.zeros((1, 4), np.int32), 3), dict(temperature=0.5, top_p=1.5)),
])
def test_generate_argument_errors_match_jax(tiny, args, kw):
    jm, tm = tiny
    with pytest.raises(ValueError) as jerr:
        jm.generate(*args, **kw)
    with pytest.raises(ValueError) as terr:
        tm.generate(*args, **kw)
    word = str(jerr.value).split()[0]
    assert word in str(terr.value), (jerr.value, terr.value)
    unconverted = tzoo.build("gpt_tiny", device="cpu", **GEO)
    with pytest.raises(RuntimeError, match="converted"):
        unconverted.generate(*args, **kw)


def test_sampled_generate_is_seeded_and_filtered(tiny):
    _, tm = tiny
    ids = np.random.default_rng(1).integers(0, 64, (3, 5)).astype(np.int32)
    a = tm.generate(ids, 8, temperature=0.9, top_k=8, top_p=0.8, seed=11)
    b = tm.generate(ids, 8, temperature=0.9, top_k=8, top_p=0.8, seed=11)
    c = tm.generate(ids, 8, temperature=0.9, top_k=8, top_p=0.8, seed=12)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.dtype == np.int32 and ((a >= 0) & (a < 64)).all()
