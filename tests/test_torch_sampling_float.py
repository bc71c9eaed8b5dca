"""PyTorch port vs JAX package: sampling on the float logits of the
weight-only modes, mirroring the float cases of
``tests/test_sampling_topp.py`` and ``tests/test_prefix_cache.py``'s
weight-only case (gpt_tiny: vocab 97, max_len 48, dim 64, depth 2, 4
heads; W8-float).

* ``nucleus_float_cutoff`` equals the JAX package's on the same logits
  (values equal; p = 1 keeps every logit, a tiny p only the largest);
* ``generate()`` on the float path: top_p = 1 equals no top-p, a tiny top_p
  equals greedy, top_k = 1 equals greedy, and top-k then top-p draws only
  tokens inside the top-k set (``pick_float``);
* the engine, per request: a greedy slot equals ``generate()``, top_p = 1
  equals plain sampling, top-k and top-p requests repeat and equal
  ``generate()`` with the same seed (the draw is keyed by (seed,
  position));
* the weight-only prefix path runs and gives the cold submission's tokens.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from int8inferenceengine_tpu.models.text_decoder import \
    nucleus_float_cutoff as j_cutoff
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch.models import zoo as tzoo
from int8inferenceengine_tpu_torch.models.text_decoder import (
    nucleus_float_cutoff, pick_float, torch_text_decoder)
from int8inferenceengine_tpu_torch.serve import GenerationEngine
from test_torch_threads import one_torch_thread  # noqa: F401

GEO = dict(vocab_size=97, max_len=48, dim=64, depth=2, heads=4)


@pytest.fixture(scope="module")
def dec():
    m = tzoo.build("gpt_tiny", config=qt.QuantConfig(weight_only=True),
                   device="cpu", **GEO)
    m.load(torch_text_decoder(**GEO).state_dict())
    m.convert()
    return m


def _ids():
    return np.random.default_rng(0).integers(0, 97, (2, 6)).astype(np.int32)


def test_float_cutoff_basics_equal_jax():
    rng = np.random.default_rng(2)
    lg = rng.normal(size=(5, 50)).astype(np.float32)
    p = np.asarray([1.0, 0.5, 0.01, 0.9, 0.3], np.float32)
    got = nucleus_float_cutoff(torch.tensor(lg), torch.tensor(p)).numpy()
    want = np.asarray(j_cutoff(jnp.asarray(lg), jnp.asarray(p)))
    np.testing.assert_array_equal(got, want)
    assert (lg[0] >= got[0, 0]).all()              # p = 1 keeps everything
    assert int((lg[2] >= got[2, 0]).sum()) == 1    # tiny p: only the max


def test_generate_topp_weight_only_float_path(dec):
    ids = _ids()
    a = dec.generate(ids, 8, temperature=1.0, seed=3)
    b = dec.generate(ids, 8, temperature=1.0, top_p=1.0, seed=3)
    np.testing.assert_array_equal(a, b)
    g = dec.generate(ids, 8)
    np.testing.assert_array_equal(
        dec.generate(ids, 8, temperature=1.0, top_p=1e-6, seed=3), g)
    np.testing.assert_array_equal(
        dec.generate(ids, 8, temperature=1.0, top_k=1, seed=3), g)
    out = dec.generate(ids, 8, temperature=0.8, top_k=20, top_p=0.9,
                       seed=7)
    assert out.shape == (2, 8) and (out >= 0).all() and (out < 97).all()


def test_pick_float_topk_then_topp_stays_in_topk():
    rng = np.random.default_rng(9)
    lg = torch.tensor(rng.normal(size=(4, 97)).astype(np.float32))
    topk = torch.tensor([5, 1, 0, 97])
    kth = torch.sort(lg, -1, descending=True).values
    allowed = [set(torch.nonzero(lg[r] >= kth[r, max(int(k) - 1, 0)])
                   .flatten().tolist()) if int(k) > 0 else set(range(97))
               for r, k in enumerate(topk)]
    seen = [set() for _ in range(4)]
    for s in range(48):
        tok = pick_float(lg, torch.ones(4), torch.full((4,), s),
                         torch.full((4,), 3), topps=torch.full((4,), 0.95),
                         topks=topk)
        for r in range(4):
            seen[r].add(int(tok[r]))
    for r in range(4):
        assert seen[r] <= allowed[r], r
    assert seen[1] == {int(lg[1].argmax())}
    assert len(seen[2]) > 1                  # k = 0 is off


def test_engine_per_request_topp_topk_float_path(dec):
    eng = GenerationEngine(dec, slots=4, chunk_steps=4)
    p = [3, 5, 7]
    try:
        f1 = eng.submit(p, 10)
        f2 = eng.submit(p, 10, temperature=1.0, seed=5)
        f3 = eng.submit(p, 10, temperature=1.0, seed=5, top_p=0.6)
        f4 = eng.submit(p, 10, temperature=1.0, seed=5, top_p=1.0)
        r1, r2, r3, r4 = (f.result(timeout=120) for f in (f1, f2, f3, f4))
        prompt = np.asarray([p], np.int32)
        np.testing.assert_array_equal(r1, dec.generate(prompt, 10)[0])
        np.testing.assert_array_equal(r2, r4)
        np.testing.assert_array_equal(
            r3, eng.submit(p, 10, temperature=1.0, seed=5,
                           top_p=0.6).result(timeout=120))
        np.testing.assert_array_equal(
            r3, dec.generate(prompt, 10, temperature=1.0, top_p=0.6,
                             seed=5)[0])
        a = eng.submit(p, 8, temperature=1.0, seed=5, top_k=4).result(
            timeout=120)
        b = eng.submit(p, 8, temperature=1.0, seed=5, top_k=4).result(
            timeout=120)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            a, dec.generate(prompt, 8, temperature=1.0, top_k=4, seed=5)[0])
        c = eng.submit(p, 8, temperature=1.0, seed=5, top_k=6,
                       top_p=0.7).result(timeout=120)
        np.testing.assert_array_equal(
            c, dec.generate(prompt, 8, temperature=1.0, top_k=6, top_p=0.7,
                            seed=5)[0])
    finally:
        eng.shutdown()


def test_prefix_weight_only_path_runs(dec):
    eng = GenerationEngine(dec, slots=2, chunk_steps=4, prefill_chunk=8)
    try:
        rng = np.random.default_rng(5)
        prefix = rng.integers(0, 97, (16,)).astype(np.int32)
        pid = eng.register_prefix(prefix)
        assert eng._prefixes[pid][1].dtype == torch.float32
        full = np.concatenate(
            [prefix, rng.integers(0, 97, (4,)).astype(np.int32)])
        a = eng.submit(full, 8, prefix_id=pid).result(timeout=120)
        b = eng.submit(full, 8).result(timeout=120)
        assert a.shape == (8,)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, dec.generate(full[None], 8)[0])
    finally:
        eng.shutdown()
