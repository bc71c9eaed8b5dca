"""PyTorch port vs JAX package: the CNN ``InferenceEngine`` (continuous
batching) on LeNet with the JAX package's converted state carried over.

* Coalesced, padded requests give the JAX model's logits on the same
  inputs **exactly** (``test_torch_models``' contract for carried state:
  the INT8 forward is bit-identical).
* The rest mirrors ``tests/test_serve.py``: concurrent requests coalesce and
  scatter back, an oversized request is refused, shutdown flushes what is
  queued and refuses new work, a cancelled future does not stop the engine,
  latencies are recorded, tile buckets pad to the smallest fitting tile,
  and a request that breaks the model fails its own future only.
* ``quantize_ingest=True`` raises ``NotImplementedError`` (no native host
  ops in the port yet).
* On the card (``cuda``-marked): each tile's captured forward, replayed,
  equals the direct call.

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
from int8inferenceengine_tpu_torch.carry import load_jax_state
from int8inferenceengine_tpu_torch.models import zoo as tzoo
from int8inferenceengine_tpu_torch.serve import InferenceEngine
from test_torch_models import jax_state
from test_torch_threads import one_torch_thread  # noqa: F401

WAIT = 60
SHAPE = (1, 28, 28)


def _rand(n, seed):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n,) + SHAPE).astype(np.float32)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's LeNet lifecycle and its INT8 logits on 64 test
    images (as one padded 64-row batch)."""
    m = jzoo.build("lenet")
    m.load(jzoo.torch_twin("lenet").state_dict())
    m.prepare()
    m(qj.tensor(_rand(16, 0)))
    m.convert()
    x = _rand(64, 1)
    return dict(state=jax_state(m), x=x, logits=m(qj.tensor(x)).numpy())


def _model(ref, device="cpu"):
    m = tzoo.build("lenet", device=device)
    load_jax_state(m, ref["state"])
    return m


@pytest.fixture(scope="module")
def model(ref):
    return _model(ref)


def test_results_match_jax(ref, model):
    engine = InferenceEngine(model, max_batch=64, batch_timeout_s=0.02)
    try:
        x, want = ref["x"], ref["logits"]
        futs = [engine.submit(x[a:b]) for a, b in
                ((0, 3), (3, 10), (10, 33), (33, 64))]
        got = np.concatenate([f.result(timeout=WAIT) for f in futs])
        assert got.dtype == np.float32 and got.shape == (64, 10)
        np.testing.assert_array_equal(got, want)
    finally:
        engine.shutdown()


def test_concurrent_requests_coalesce_and_scatter_correctly(model):
    engine = InferenceEngine(model, max_batch=64, batch_timeout_s=0.02)
    solo = InferenceEngine(model, max_batch=64)
    try:
        xs = [_rand(n, 10 + n) for n in (1, 3, 7, 16, 5, 2, 30)]
        futs = [engine.submit(x) for x in xs]
        outs = [f.result(timeout=WAIT) for f in futs]
        for x, out in zip(xs, outs):
            assert out.shape == (x.shape[0], 10)
            np.testing.assert_array_equal(
                out, solo.submit(x).result(timeout=WAIT))
        assert engine.stats.requests == len(xs)
        assert engine.stats.images == sum(x.shape[0] for x in xs)
        assert engine.stats.steps <= len(xs)
    finally:
        engine.shutdown()
        solo.shutdown()


def test_many_threads_hammering(model):
    """More submitting threads than cores, a short switch interval: every
    request gets its own rows back."""
    engine = InferenceEngine(model, max_batch=32, batch_timeout_s=0.005)
    xs = [_rand(1 + i % 5, 20 + i) for i in range(8)]
    want = [engine.submit(x).result(timeout=WAIT) for x in xs]
    errors = []

    def worker(i):
        try:
            for _ in range(4):
                got = engine.submit(xs[i]).result(timeout=WAIT)
                np.testing.assert_array_equal(got, want[i])
        except Exception as e:           # reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
    finally:
        sys.setswitchinterval(interval)
        engine.shutdown()


def test_oversized_request_rejected(model):
    engine = InferenceEngine(model, max_batch=8)
    try:
        with pytest.raises(ValueError, match="max_batch"):
            engine.submit(_rand(9, 0))
    finally:
        engine.shutdown()


def test_shutdown_rejects_new_work_and_flushes_pending(model):
    engine = InferenceEngine(model, max_batch=16, batch_timeout_s=0.5)
    futs = [engine.submit(_rand(3, i)) for i in range(3)]
    engine.shutdown()
    for f in futs:
        assert f.result(timeout=WAIT).shape == (3, 10)
    with pytest.raises(RuntimeError, match="shut down"):
        engine.submit(_rand(1, 0))


def test_latency_stats_populated(model):
    engine = InferenceEngine(model, max_batch=16)
    try:
        for i in range(5):
            engine.submit(_rand(4, i)).result(timeout=WAIT)
    finally:
        engine.shutdown()
    assert len(engine.stats.latencies_s) == 5
    pct = engine.stats.latency_percentiles()
    assert pct["p50"] > 0 and pct["p99"] >= pct["p50"]


def test_cancelled_future_does_not_kill_engine(model):
    engine = InferenceEngine(model, max_batch=16, batch_timeout_s=0.1)
    try:
        fut = engine.submit(_rand(4, 0))
        fut.cancel()
        for i in range(3):
            assert engine.submit(_rand(4, i)).result(
                timeout=WAIT).shape == (4, 10)
    finally:
        engine.shutdown()


def test_batch_size_buckets(model):
    x = _rand(4, 3)
    base_engine = InferenceEngine(model, max_batch=64)
    engine = InferenceEngine(model, batch_sizes=(8, 64),
                             batch_timeout_s=0.01)
    try:
        base = base_engine.submit(x).result(timeout=WAIT)
        assert engine.max_batch == 64
        np.testing.assert_array_equal(engine.submit(x).result(timeout=WAIT),
                                      base)
        assert engine.stats.padded_rows == 4          # 4 rows -> the 8 tile
        out = engine.submit(_rand(40, 4)).result(timeout=WAIT)
        assert out.shape == (40, 10)
        assert engine.stats.padded_rows == 4 + 24     # 40 -> the 64 tile
    finally:
        engine.shutdown()
        base_engine.shutdown()


def test_bad_request_fails_future_not_engine(model):
    engine = InferenceEngine(model, max_batch=16, batch_timeout_s=0.01)
    try:
        bad = engine.submit(np.zeros((2, 3, 28, 28), np.float32))
        with pytest.raises(Exception):
            bad.result(timeout=WAIT)
        assert engine.submit(_rand(4, 0)).result(
            timeout=WAIT).shape == (4, 10)
    finally:
        engine.shutdown()


def test_quantize_ingest_is_not_ported(model):
    with pytest.raises(NotImplementedError, match="quantize_ingest"):
        InferenceEngine(model, quantize_ingest=True)


@pytest.fixture
def card_model(ref):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the captured forward has no CPU "
                    "mode")
    return _model(ref, device=None)


@pytest.mark.cuda
def test_captured_tiles_equal_direct_call_on_card(ref, card_model):
    m = card_model
    engine = InferenceEngine(m, batch_sizes=(8, 64), batch_timeout_s=0.01)
    try:
        x = ref["x"]
        for _ in range(2):             # the second pass replays the graphs
            for a, b in ((0, 5), (5, 64)):
                got = engine.submit(x[a:b]).result(timeout=WAIT)
                np.testing.assert_array_equal(got, ref["logits"][a:b])
    finally:
        engine.shutdown()
