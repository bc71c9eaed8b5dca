"""PyTorch port vs JAX package: the llama family and W4 weight-only.

Both packages see the same numpy inputs and the same ``torch_llama`` weights
(vocab 128, dim 128, depth 2, 4 heads over 2 kv heads, max_len 64):

* ``QuantRMSNorm`` (with ``unit_offset``), ``QuantRoPE`` (scalar and
  per-row starts, ``linear``/``ntk`` scaling, partial ``rotary_dim``) and
  ``QuantMul``, each through prepare -> calibrate -> convert with the JAX
  layer's output grid carried over: within the repo's contract, at most one
  code off on at most 0.2% (rsqrt, cos/sin and the float sums are not
  bitwise equal across the frameworks); ``repeat_kv`` exactly;
* the FP32 forward against ``torch_llama`` and the JAX package: 1e-5 of the
  largest logit;
* W8A8 (the default config) with the JAX converted state carried over, at
  batch 2 and batch 8: logit codes within the contract, greedy tokens
  equal, and the port's cached decode equal to its own full recompute
  (``test_torch_llama_w4a8`` does the same for W4A8 with these helpers);
* the W4 weight-only forward within 1e-4 of the largest JAX logit;
* the carry round trip of W4 Linears and ``QuantRMSNorm``;
* ``dynamic_act`` with 4-bit weights raises ``ValueError`` at convert, and
  so does a ring cache without a window.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import int8inferenceengine_tpu as qj
from int8inferenceengine_tpu import layers as JL
from int8inferenceengine_tpu.models import zoo as jzoo
from int8inferenceengine_tpu.models.llama import torch_llama as j_torch_llama
from int8inferenceengine_tpu.ops import functional as JF
from int8inferenceengine_tpu.ops import rope as JR
from int8inferenceengine_tpu.tensor import Tensor as JT
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch.carry import export_state, load_jax_state
from int8inferenceengine_tpu_torch.models import zoo as tzoo
from int8inferenceengine_tpu_torch.models.llama import (LlamaDecoder,
                                                        torch_llama)
from int8inferenceengine_tpu_torch.ops import functional as TF
from int8inferenceengine_tpu_torch.ops import rope as TR
from int8inferenceengine_tpu_torch.tensor import Tensor as TT
from test_torch_text_decoder import assert_own_gate, own_calibration_gap
from test_torch_threads import one_torch_thread  # noqa: F401

GEO = dict(vocab_size=128, max_len=64, dim=128, depth=2, heads=4, kv_heads=2)
WEIGHT_ONLY = dict(weight_only=True, weight_bits=4)


def assert_contract(got, want, what=""):
    """At most one code off, on at most 0.2% of the elements."""
    d = np.abs(np.asarray(got).astype(np.int32)
               - np.asarray(want).astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 0.002, (
        what, int(d.max()), float((d > 0).mean()))


def _rng(seed):
    return np.random.default_rng(seed)


def _ids(b, t, seed):
    return _rng(seed).integers(0, GEO["vocab_size"], (b, t)).astype(np.int32)


def _float(x):
    return JT(jnp.asarray(x)), TT(torch.tensor(x))


def _codes(x, scale, zp):
    return JT(jnp.asarray(x), scale, zp), TT(torch.tensor(x), scale, zp)


def _calibrate(pair, calib_args, test_args, **kw):
    """prepare -> FP32 calibration call -> convert on both layers; the port
    layer takes the JAX layer's output grid; returns (jax, port) outputs."""
    jl, tl = pair
    for layer in pair:
        layer.prepare()
    jl(*(j for j, _ in calib_args), **kw)
    tl(*(t for _, t in calib_args), **kw)
    for layer in pair:
        layer.convert()
    assert tl.zero_point == jl.zero_point
    assert tl.scale == pytest.approx(jl.scale, rel=1e-5)
    tl.scale, tl.zero_point = jl.scale, jl.zero_point
    return (np.asarray(jl(*(j for j, _ in test_args)).data),
            tl(*(t for _, t in test_args)).data.numpy())


def jax_state(model) -> dict:
    """A JAX Module's per-layer state in ``load_jax_state``'s format."""
    state = {}
    for name, layer in model.named_layers():
        ws = layer.weight_scale
        state[name] = {
            "params": {k: np.asarray(v) for k, v in layer.params.items()},
            "scale": layer.scale, "zero_point": layer.zero_point,
            "weight_scale": ws if isinstance(ws, float) else np.asarray(ws),
            "is_quantized": layer.is_quantized}
    return state


# -- the llama layers ------------------------------------------------------------

@pytest.mark.parametrize("unit_offset", [False, True])
def test_rmsnorm_within_contract(unit_offset):
    rng = _rng(5)
    gain = (0.1 * rng.standard_normal(128)).astype(np.float32)
    if not unit_offset:
        gain += 1
    x = rng.standard_normal((64, 128)).astype(np.float32) * 3
    codes = rng.integers(0, 256, (64, 128)).astype(np.uint8)
    pair = (JL.QuantRMSNorm(128, unit_offset=unit_offset),
            qt.QuantRMSNorm(128, unit_offset=unit_offset, device="cpu"))
    for layer in pair:
        layer.load_weight(gain)
    fp = [np.asarray(pair[0](JT(jnp.asarray(x))).data),
          pair[1](TT(torch.tensor(x))).data.numpy()]
    np.testing.assert_allclose(fp[1], fp[0], rtol=1e-5, atol=1e-5)
    want, got = _calibrate(pair, [_float(x)], [_codes(codes, 0.02, 128)])
    assert len(np.unique(want)) > 64
    assert_contract(got, want)


@pytest.mark.parametrize("scaling", [None, ("linear", 4.0), ("ntk", 2.0)])
def test_rope_angles_match_jax(scaling):
    pos = np.array([[0, 3, 17], [40, 41, 63]], np.int32)
    jc, js = JR.rope_angles(jnp.asarray(pos), 32, 10000.0, scaling)
    tc, ts = TR.rope_angles(torch.tensor(pos), 32, 10000.0, scaling)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-6)


@pytest.mark.parametrize("scaling,rotary_dim", [
    (None, None), (("linear", 4.0), None), (("ntk", 2.0), None), (None, 16)])
def test_rope_within_contract(scaling, rotary_dim):
    rng = _rng(8)
    x = rng.standard_normal((2, 4, 12, 32)).astype(np.float32) * 2
    codes = rng.integers(0, 256, (2, 4, 12, 32)).astype(np.uint8)
    kw = dict(scaling=scaling, rotary_dim=rotary_dim)
    pair = (JL.QuantRoPE(32, **kw), qt.QuantRoPE(32, device="cpu", **kw))
    want, got = _calibrate(pair, [_float(x)], [_codes(codes, 0.02, 130)])
    assert_contract(got, want, "prefill")
    # a decode position: a scalar start, then per-row starts
    one = codes[:, :, :1]
    for js, ts in ((jnp.int32(37), torch.tensor(37)),
                   (jnp.asarray([5, 60], np.int32),
                    torch.tensor([5, 60], dtype=torch.int32))):
        want = np.asarray(pair[0](JT(jnp.asarray(one), 0.02, 130),
                                  start=js).data)
        got = pair[1](TT(torch.tensor(one), 0.02, 130),
                      start=ts).data.numpy()
        assert_contract(got, want, "start")


def test_quant_mul_within_contract():
    rng = _rng(4)
    x, y = (rng.standard_normal((32, 128)).astype(np.float32)
            for _ in range(2))
    ca, cb = (rng.integers(0, 256, (32, 128)).astype(np.uint8)
              for _ in range(2))
    want, got = _calibrate((JL.QuantMul(), qt.QuantMul(device="cpu")),
                           [_float(x), _float(y)],
                           [_codes(ca, 0.017, 120), _codes(cb, 0.031, 99)])
    assert len(np.unique(want)) > 64
    assert_contract(got, want)


def test_repeat_kv_is_exact():
    x = _rng(2).integers(0, 256, (2, 2, 5, 8)).astype(np.uint8)
    want = np.asarray(JF.repeat_kv(JT(jnp.asarray(x), 0.1, 3), 3).data)
    got = TF.repeat_kv(TT(torch.tensor(x), 0.1, 3), 3)
    assert got.scale == 0.1 and got.zero_point == 3
    np.testing.assert_array_equal(got.data.numpy(), want)


# -- the model ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    return j_torch_llama(**GEO).state_dict()


def test_fp32_logits_match_twin_and_jax(weights):
    geo = dict(GEO)
    tw = torch_llama(**geo)
    for key, v in tw.state_dict().items():
        assert torch.equal(v, weights[key]), key
    ids = _ids(3, 20, 0)
    m = tzoo.build("llama_tiny", device="cpu", **geo)
    m.load(weights)
    got = m(qt.tensor(ids, device="cpu")).numpy()
    want = tw(torch.tensor(ids, dtype=torch.long)).detach().numpy()
    jm = jzoo.build("llama_tiny", **geo)
    jm.load(weights)
    jwant = jm(qj.tensor(ids)).numpy()
    for ref in (want, jwant):
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())


@pytest.fixture(scope="module")
def ref(weights):
    """The JAX package's W8A8 llama lifecycle, run once: its converted
    state, forward codes and greedy tokens at batch 2 and 8."""
    return jax_reference(weights, {})


def jax_reference(weights, cfg):
    jm = jzoo.build("llama_tiny", config=qj.QuantConfig(**cfg), **GEO)
    jm.load(weights)
    jm.prepare()
    jm(qj.tensor(_ids(8, 32, 1)))
    jm.convert()
    out = dict(cfg=cfg, state=jax_state(jm), x={}, codes={}, prompt={},
               tokens={})
    with pltpu.force_tpu_interpret_mode():
        for b, t in ((2, 11), (8, 12)):
            out["x"][b] = _ids(b, t, 3 + b)
            out["codes"][b] = np.asarray(jm(qj.tensor(out["x"][b])).data)
            out["prompt"][b] = _ids(b, 8, 5 + b)
            out["tokens"][b] = np.asarray(jm.generate(out["prompt"][b], 6))
    return out


def own_calibrated(weights, cfg):
    """The port's own lifecycle on the JAX reference's weights and 8 x 32
    calibration ids."""
    m = tzoo.build("llama_tiny", config=qt.QuantConfig(**cfg),
                   device="cpu", **GEO)
    m.load(weights)
    m.prepare()
    m(qt.tensor(_ids(8, 32, 1), device="cpu"))
    m.convert()
    return m


def own_gap(m, ref, b):
    return own_calibration_gap(
        m, ref["state"], m(qt.tensor(ref["x"][b], device="cpu")).data
        .numpy(), ref["codes"][b], m.generate(ref["prompt"][b], 6),
        ref["tokens"][b])


def carried(ref):
    m = tzoo.build("llama_tiny", config=qt.QuantConfig(**ref["cfg"]),
                   device="cpu", **GEO)
    load_jax_state(m, ref["state"])
    return m


@pytest.mark.parametrize("b", [2, 8])
def test_carried_codes_match_jax(ref, b):
    got = carried(ref)(qt.tensor(ref["x"][b], device="cpu")).data.numpy()
    want = ref["codes"][b]
    assert got.shape == want.shape == ref["x"][b].shape + (128,)
    assert len(np.unique(want)) > 64
    assert_contract(got, want)


@pytest.mark.parametrize("b", [2, 8])
def test_own_calibration_gate(weights, ref, b):
    """The port's own W8A8 lifecycle ('trunc'): every zero point equal,
    the output scales within 2 float32 ULPs of the JAX package's (the
    first min or max to depart is wq1's, 1 ULP: the RMSNorm before it
    reads the same rows, but its float32 mean of squares and XLA's
    approximate rsqrt are ULPs from the port's float64 ones, rounded
    once), the forward's head codes all equal at batch 2 and equal on
    98.67% at batch 8 (within 2 steps: the ULPs move codes on truncation
    boundaries, and the moves travel), and the 6 greedy tokens equal."""
    gap = own_gap(own_calibrated(weights, {}), ref, b)
    equal, dist = {2: (1.0, 0), 8: (0.9867, 2)}[b]
    assert_own_gate(gap, scale_ulps=2, equal=equal, max_dist=dist,
                    token_steps=6)


@pytest.mark.parametrize("b", [2, 8])
def test_generate_tokens_match_jax(ref, b):
    got = carried(ref).generate(ref["prompt"][b], 6)
    assert got.dtype == np.int32 and got.shape == (b, 6)
    np.testing.assert_array_equal(got, ref["tokens"][b])


def recompute(m, prompt, steps):
    seq = prompt.copy()
    for _ in range(steps):
        codes = m(qt.tensor(seq, device="cpu")).data.numpy()
        nxt = codes[:, -1].argmax(-1).astype(np.int32)
        seq = np.concatenate([seq, nxt[:, None]], axis=1)
    return seq[:, prompt.shape[1]:]


@pytest.mark.parametrize("b", [2, 8])
def test_cached_decode_equals_full_recompute(ref, b):
    m = carried(ref)
    prompt = ref["prompt"][b]
    np.testing.assert_array_equal(m.generate(prompt, 6),
                                  recompute(m, prompt, 6))


@pytest.fixture(scope="module")
def weight_only_ref(weights):
    jm = jzoo.build("llama_tiny", config=qj.QuantConfig(**WEIGHT_ONLY), **GEO)
    jm.load(weights)
    jm.convert()
    x = _ids(3, 16, 7)
    return dict(state=jax_state(jm), x=x, logits=jm(qj.tensor(x)).numpy())


def test_weight_only_forward_matches_jax(weights, weight_only_ref):
    want = weight_only_ref["logits"]
    x = weight_only_ref["x"]
    carried = tzoo.build("llama_tiny", config=qt.QuantConfig(**WEIGHT_ONLY),
                         device="cpu", **GEO)
    load_jax_state(carried, weight_only_ref["state"])
    own = tzoo.build("llama_tiny", config=qt.QuantConfig(**WEIGHT_ONLY),
                     device="cpu", **GEO)
    own.load(weights)
    own.convert()                      # no calibration pass needed
    for m in (carried, own):
        got = m(qt.tensor(x, device="cpu"))
        assert not got.quantized and got.data.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    assert own.wq1.w4_packed.dtype == torch.uint8
    assert own.wq1.w4_wsum is None and own.embed.weight is not None


def assert_round_trip(m, state):
    back = export_state(m)
    assert set(back) == set(state)
    for name, st in state.items():
        got = back[name]
        assert got["scale"] == st["scale"] and \
            got["zero_point"] == st["zero_point"], name
        assert sorted(got["params"]) == sorted(st["params"]), name
        for key, arr in st["params"].items():
            np.testing.assert_array_equal(got["params"][key], arr)


@pytest.mark.parametrize("kind", ["w8a8", "weight_only"])
def test_carry_round_trip_w4_and_rmsnorm(ref, weight_only_ref, kind):
    if kind == "w8a8":
        m, state = carried(ref), ref["state"]
    else:
        state = weight_only_ref["state"]
        m = tzoo.build("llama_tiny", config=qt.QuantConfig(**WEIGHT_ONLY),
                       device="cpu", **GEO)
        load_jax_state(m, state)
        assert {"w4_packed", "w4_scales", "bias"} == set(
            state["wq1"]["params"])
    assert set(state["ln1_1"]["params"]) == {"weight"}
    assert_round_trip(m, state)


def test_w4_weight_only_artifact_equals_jax(weight_only_ref, tmp_path):
    """W4 weight-only (no ``w4_wsum``): the JAX package's artifact equals
    the port's of the carried state, and the port loads JAX's with the
    carried model's logits."""
    from int8inferenceengine_tpu_torch import utils
    from test_torch_checkpoint import assert_same_artifact, install_state
    state = weight_only_ref["state"]
    cfg = qt.QuantConfig(**WEIGHT_ONLY)
    m = tzoo.build("llama_tiny", config=cfg, device="cpu", **GEO)
    load_jax_state(m, state)
    jm = install_state(jzoo.build("llama_tiny",
                                  config=qj.QuantConfig(**WEIGHT_ONLY),
                                  **GEO), state)
    jp, _ = assert_same_artifact(jm, m, tmp_path)
    x = qt.tensor(_ids(2, 9, 4), device="cpu")
    got = utils.load(tzoo.build("llama_tiny", config=cfg, device="cpu",
                                **GEO), jp)
    np.testing.assert_array_equal(got(x).numpy(), m(x).numpy())


def test_unported_modes_raise():
    # the 8-bit weight modes are ported (tests/test_torch_weight_only.py);
    # what raises is the JAX package's own rule: dynamic_act needs s8
    # weights, at convert()
    for cfg in (dict(weight_only=True), dict(dynamic_act=True)):
        tzoo.build("llama_tiny", config=qt.QuantConfig(**cfg),
                   device="cpu", **GEO)
    m = tzoo.build("llama_tiny", config=qt.QuantConfig(
        weight_only=True, weight_bits=4, dynamic_act=True), device="cpu",
        **GEO)
    with pytest.raises(ValueError, match="dynamic_act"):
        m.convert()
    # the mistral window and its ring cache are ported (test_torch_sliding_
    # window.py, test_torch_ring_cache.py); a ring without a window raises
    with pytest.raises(ValueError, match="sliding_window"):
        LlamaDecoder(device="cpu", **GEO, ring_cache=True)
    # weight-only generate() runs over the float KV cache
    # (tests/test_torch_float_cache.py)
    m = tzoo.build("llama_tiny", config=qt.QuantConfig(**WEIGHT_ONLY),
                   device="cpu", **GEO)
    m.convert()
    assert m.generate(_ids(2, 4, 0), 3).shape == (2, 3)
