"""PyTorch port vs JAX package: quantization primitives and the Calibrator.

Inputs are made with numpy from fixed seeds and go through both packages'
functions (the JAX ones eagerly, as its own unit tests call them); every
comparison is bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from int8inferenceengine_tpu import calibrator as jcal
from int8inferenceengine_tpu.ops import quant as jq
from int8inferenceengine_tpu_torch import calibrator as tcal
from int8inferenceengine_tpu_torch.ops import quant as tq
from test_torch_threads import one_torch_thread  # noqa: F401

ROUNDINGS = ("trunc", "nearest")


def _x(n=20000, seed=0, spread=10.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * spread).astype(np.float32)
    # values that land exactly on rounding ties and range ends
    x[:6] = [0.0, -0.0, 1e9, -1e9, 0.0125, 3.1875]
    return x


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("scale,zp", [(0.025, 127), (0.0237, 0), (0.3, 255)])
def test_quantize_u8_matches_jax(rounding, scale, zp):
    x = _x()
    want = np.asarray(jq.quantize_u8(jnp.asarray(x), scale, zp, rounding))
    got = tq.quantize_u8(torch.tensor(x), scale, zp, rounding).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_quantize_s8_and_dequantize_match_jax(rounding):
    x = _x(spread=1.0)
    s = np.float32(0.0078125 * 1.37)
    want = np.asarray(jq.quantize_s8(jnp.asarray(x), jnp.float32(s), rounding))
    got = tq.quantize_s8(torch.tensor(x), torch.tensor(s), rounding).numpy()
    np.testing.assert_array_equal(got, want)
    codes = np.random.default_rng(3).integers(0, 256, 5000).astype(np.uint8)
    np.testing.assert_array_equal(
        tq.dequantize_u8(torch.tensor(codes), 0.0173, 91).numpy(),
        np.asarray(jq.dequantize_u8(jnp.asarray(codes), 0.0173, 91)))


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("per_channel", [False, True])
def test_down_scale_matches_jax(rounding, per_channel):
    rng = np.random.default_rng(5)
    acc = rng.integers(-2 ** 20, 2 ** 20, (64, 48)).astype(np.int32)
    s_w = (rng.uniform(0.001, 0.02, 48).astype(np.float32) if per_channel
           else 0.0113)
    want = np.asarray(jq.down_scale(jnp.asarray(acc), 0.021, jnp.asarray(s_w),
                                    0.37, 117, rounding=rounding))
    got = tq.down_scale(torch.tensor(acc), 0.021, torch.tensor(s_w), 0.37,
                        117, rounding).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_weight_quantization_matches_jax(rounding):
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((16, 3, 5, 5)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(16) * 0.05).astype(np.float32)
    jw, jb, js = jq.quantize_weight_joint_scale(jnp.asarray(w),
                                                jnp.asarray(b), rounding)
    tw, tb, ts = tq.quantize_weight_joint_scale(torch.tensor(w),
                                                torch.tensor(b), rounding)
    assert ts == js
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    # per output channel: JAX holds conv weights HWIO (axis 3), the port OIHW
    jw, jb, js = jq.quantize_weight_per_channel(
        jnp.asarray(w.transpose(2, 3, 1, 0)), jnp.asarray(b), channel_axis=3,
        rounding=rounding)
    tw, tb, ts = tq.quantize_weight_per_channel(
        torch.tensor(w), torch.tensor(b), channel_axis=0, rounding=rounding)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tw.numpy().transpose(2, 3, 1, 0),
                                  np.asarray(jw))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_calibrator_derive_matches_jax():
    rng = np.random.default_rng(11)
    pairs = [(np.float32(lo), np.float32(hi)) for lo, hi in
             zip(rng.standard_normal(300) * 5, rng.standard_normal(300) * 5)]
    pairs += [(np.float32(0), np.float32(0)), (np.float32(-1), np.float32(0)),
              (np.float32(0), np.float32(3)), (np.float32(-1e-12),
                                               np.float32(1e-12))]
    for lo, hi in pairs:
        assert tcal.Calibrator._derive(lo, hi) == jcal.Calibrator._derive(lo, hi)


@pytest.mark.parametrize("kw,quantile", [
    (dict(), 1.0),                                         # streaming min/max
    (dict(exact_minmax=False, reservoir_size=200), 0.99),  # reservoir
    (dict(exact_minmax=False, reservoir_size=200), 1.0),
    (dict(method="mse", reservoir_size=300), 1.0),
    (dict(method="mse", reservoir_size=300, rounding="nearest"), 1.0),
])
def test_calibrator_matches_jax(kw, quantile):
    rng = np.random.default_rng(13)
    batches = [(rng.standard_normal((4, 37)) * 3 + 0.5).astype(np.float32)
               for _ in range(5)]
    cj = jcal.Calibrator(seed=0, **kw)
    ct = tcal.Calibrator(seed=0, **kw)
    for b in batches:
        cj.sample(jnp.asarray(b))
        ct.sample(torch.tensor(b))
    filled = min(cj._count_res, cj.reservoir_size)
    assert ct._count_res == cj._count_res
    np.testing.assert_array_equal(ct._reservoir[:filled],
                                  cj._reservoir[:filled])
    assert ct.get_range(quantile) == cj.get_range(quantile)
    assert ct.stats() == cj.stats()
