"""PyTorch port vs JAX package: the GPT-style decoder (``gpt_tiny``).

Both packages load the same ``torch_twin`` weights (vocab 1000, dim 128,
depth 2, heads 2, max_len 64) and see the same numpy token ids:

* FP32 logits agree to rtol 1e-5 of the largest logit;
* with the JAX package's converted state carried over, the INT8 prefill
  logit codes are equal on at least 99% of entries and within 2 codes
  everywhere (the glue's float reductions and transcendentals differ by an
  ULP between the frameworks, which moves codes on truncation boundaries);
* greedy ``generate`` gives the JAX package's tokens on its own test case
  (batch 3, 7-token prompt, 9 steps);
* the port's cached decode equals its own full recompute token for token,
  with the fused and the composed paths, and with per-row positions;
* the state carries both ways unchanged;
* speculative decoding with the decoder as its own draft equals its
  ``generate()`` (``test_torch_speculative`` holds it to the JAX package);
* the port's own ``prepare -> convert`` on the JAX lifecycle's weights and
  ids gives the JAX package's grids (``own_calibration_gap``; every
  decoder family's test file gates its own).
"""

import numpy as np
import pytest
import torch

import int8inferenceengine_tpu as qj
from int8inferenceengine_tpu.models import zoo as jzoo
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch.carry import export_state, load_jax_state
from int8inferenceengine_tpu_torch.models import zoo as tzoo
from int8inferenceengine_tpu_torch.tensor import Tensor
from test_torch_threads import one_torch_thread  # noqa: F401


def _ids(b, t, seed=0, vocab=1000):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(b, t)).astype(np.int32)


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


def _ulps(a, b) -> int:
    """The distance of two float32 values in units in the last place."""
    ia, ib = (int(np.float32(v).view(np.int32)) for v in (a, b))
    ia, ib = (-2 ** 31 - i if i < 0 else i for i in (ia, ib))
    return abs(ia - ib)


def _head_codes(logits, grid) -> np.ndarray:
    """The head's INT8 codes back from its dequantized logits."""
    scale, zp = grid
    return np.rint(logits / np.float32(scale)).astype(np.int32) + zp


def own_calibration_gap(m, state, got, want, tokens=None,
                        want_tokens=None) -> dict:
    """What separates the port's own calibration of ``m`` from the JAX
    package's converted ``state``: the layers whose zero points differ,
    the largest output-scale distance in float32 ULPs, the share of equal
    head codes (``got`` and ``want`` are the two forwards' dequantized
    logits, each at its own head grid) with their largest distance, and
    the greedy steps up to the first token that differs (None without
    ``tokens``)."""
    zps = [n for n, layer in m.named_layers()
           if layer.zero_point != state[n]["zero_point"]]
    ulps = max(_ulps(layer.scale, state[n]["scale"])
               for n, layer in m.named_layers())
    head = state["head"]
    dist = np.abs(_head_codes(got, (m.head.scale, m.head.zero_point))
                  - _head_codes(want, (head["scale"], head["zero_point"])))
    steps = None
    if tokens is not None:
        off = np.nonzero((tokens != want_tokens).any(0))[0]
        steps = int(off[0]) if len(off) else tokens.shape[1]
    return dict(zero_points=zps, scale_ulps=ulps,
                equal=float((dist == 0).mean()), max_dist=int(dist.max()),
                token_steps=steps)


def assert_own_gate(gap, scale_ulps, equal, max_dist, token_steps=None):
    """No zero point apart, and the scales, codes and tokens within the
    bounds a family's gate states."""
    assert gap["zero_points"] == [], gap
    assert gap["scale_ulps"] <= scale_ulps, gap
    assert gap["equal"] >= equal and gap["max_dist"] <= max_dist, gap
    if token_steps is not None:
        assert gap["token_steps"] >= token_steps, gap


@pytest.fixture(scope="module")
def ref():
    """The JAX package's decoder lifecycle, run once."""
    sd = jzoo.torch_twin("gpt_tiny").state_dict()
    m = jzoo.build("gpt_tiny")
    m.load(sd)
    x_fp = _ids(4, 24)
    fp32 = m(qj.tensor(x_fp)).numpy()
    m.prepare()
    m(qj.tensor(_ids(8, 64, seed=1)))
    m.convert()
    x_test = _ids(4, 32, seed=3)
    prompt = _ids(3, 7, seed=5)
    return dict(sd=sd, x_fp=x_fp, fp32=fp32, x_test=x_test,
                int8=m(qj.tensor(x_test)).numpy(), prompt=prompt,
                codes=np.asarray(m(qj.tensor(x_test)).data),
                tokens=m.generate(prompt, 9), state=jax_state(m), model=m)


def _run(m, ids):
    return m(qt.tensor(ids, device="cpu")).numpy()


def _carried(ref, config=qt.DEFAULT_CONFIG):
    m = tzoo.build("gpt_tiny", config=config, device="cpu")
    load_jax_state(m, ref["state"])
    return m


def test_fp32_matches_jax(ref):
    m = tzoo.build("gpt_tiny", device="cpu")
    m.load(ref["sd"])
    want = ref["fp32"]
    np.testing.assert_allclose(_run(m, ref["x_fp"]), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_carried_int8_prefill_codes_match_jax(ref):
    m = _carried(ref)
    assert m.is_quant
    got = _run(m, ref["x_test"])
    steps = np.abs(got - ref["int8"]) / m.head.scale
    assert steps.max() <= 2 + 1e-3, steps.max()
    assert (steps < 0.5).mean() >= 0.99, (steps < 0.5).mean()


def test_generate_tokens_match_jax(ref):
    got = _carried(ref).generate(ref["prompt"], 9)
    assert got.dtype == np.int32 and got.shape == (3, 9)
    np.testing.assert_array_equal(got, ref["tokens"])


def test_own_calibration_gate(ref):
    """The port's own lifecycle on the JAX one's weights and 8 x 64
    calibration ids ('trunc'): every zero point equal, output scales
    within 6 float32 ULPs (fc2_1; the first min or max to depart is
    wq1's, 3 ULPs: the LayerNorm before it reads the same rows, but its
    float32 mean and XLA's approximate rsqrt are ULPs from the port's
    float64 ones, rounded once, on some rows), the 4 x 32 x 1,000 head
    codes equal on 99.78% (282 one step apart: an ULP of a grid moves a
    code on a truncation boundary, and the move travels), and the 9
    greedy tokens equal."""
    m = tzoo.build("gpt_tiny", device="cpu")
    m.load(ref["sd"])
    m.prepare()
    _run(m, _ids(8, 64, seed=1))
    m.convert()
    gap = own_calibration_gap(
        m, ref["state"], m(qt.tensor(ref["x_test"], device="cpu")).data
        .numpy(), ref["codes"], m.generate(ref["prompt"], 9),
        ref["tokens"])
    assert_own_gate(gap, scale_ulps=6, equal=0.9977, max_dist=1,
                    token_steps=9)


def test_artifact_equals_jax_and_loads_across(ref, tmp_path):
    """The JAX package's artifact of its converted model equals the port's
    of the carried state (meta and arrays); each package loads the other's
    and gives its codes (the JAX package's with one compile)."""
    from int8inferenceengine_tpu import utils as jutils
    from int8inferenceengine_tpu_torch import utils
    from test_torch_checkpoint import assert_same_artifact
    m = _carried(ref)
    jp, tp = assert_same_artifact(ref["model"], m, tmp_path)
    x = ref["x_test"]
    got = utils.load(tzoo.build("gpt_tiny", device="cpu"), jp)
    np.testing.assert_array_equal(_run(got, x), _run(m, x))
    jm = jutils.load(jzoo.build("gpt_tiny"), tp)
    np.testing.assert_array_equal(np.asarray(jm(qj.tensor(x)).data),
                                  ref["codes"])


def test_carry_round_trip(ref):
    m = _carried(ref)
    back = export_state(m)
    assert set(back) == set(ref["state"])
    for name, st in ref["state"].items():
        got = back[name]
        assert got["scale"] == st["scale"] and \
            got["zero_point"] == st["zero_point"], name
        assert sorted(got["params"]) == sorted(st["params"]), name
        for key, arr in st["params"].items():
            np.testing.assert_array_equal(got["params"][key], arr)
    again = tzoo.build("gpt_tiny", device="cpu")
    load_jax_state(again, back)
    np.testing.assert_array_equal(_run(again, ref["x_test"][:1]),
                                  _run(m, ref["x_test"][:1]))


def _own(heads=4, **cfg):
    """A port decoder calibrated on its own (no JAX state)."""
    config = qt.QuantConfig(**cfg)
    m = tzoo.build("gpt_tiny", config=config, device="cpu", heads=heads)
    m.load(tzoo.torch_twin("gpt_tiny").state_dict())
    m.prepare()
    _run(m, _ids(8, 64, seed=1))
    m.convert()
    return m


def _recompute(m, prompt, steps):
    seq = prompt.copy()
    for _ in range(steps):
        nxt = _run(m, seq)[:, -1].argmax(-1).astype(np.int32)
        seq = np.concatenate([seq, nxt[:, None]], axis=1)
    return seq[:, prompt.shape[1]:]


@pytest.mark.parametrize("cfg", [
    {}, {"fuse_qkv": "off", "decode_attention": "off",
         "fuse_linear_act": False}])
def test_cached_decode_equals_full_recompute(cfg):
    m = _own(**cfg)
    prompt = _ids(3, 5, seed=9)
    got = m.generate(prompt, 8)
    np.testing.assert_array_equal(got, _recompute(m, prompt, 8))


def test_per_row_positions_match_scalar_position():
    m = _own()
    prompt = torch.tensor(_ids(2, 6, seed=4).astype(np.int64))
    with torch.no_grad():
        codes, cache = m._prefill(Tensor(prompt))
        tok = codes.argmax(-1)
        scalar, _ = m._decode_step({i: (k.clone(), v.clone())
                                    for i, (k, v) in cache.items()},
                                   torch.tensor(6), tok)
        rows, cache2 = m._decode_step(cache, torch.tensor([6, 6]), tok)
    assert torch.equal(scalar, rows)
    assert bool((cache2[1][0][:, 6] != 0).any())


def test_decoder_guards():
    m = tzoo.build("gpt_tiny", device="cpu")
    with pytest.raises(RuntimeError, match="converted"):
        m.generate(_ids(2, 4), 3)
    m = _own(heads=2)
    with pytest.raises(ValueError, match="max_len"):
        m.generate(_ids(2, 60), 10)
    with pytest.raises(ValueError, match="top_p"):
        m.generate(_ids(2, 4), 3, temperature=0.7, top_p=0.0)
    ids = _ids(2, 4)
    np.testing.assert_array_equal(m.generate_speculative(m, ids, 3),
                                  m.generate(ids, 3))


def _fma_epilogue(orig):
    """``ops/gemm_int8._requant_epilogue`` with the GEMM order's ``acc *
    mult + zp`` rounded once, as a fused multiply-add rounds it (the
    product and the sum taken in float64, then rounded to float32)."""
    from int8inferenceengine_tpu_torch.ops.functional import ACTIVATIONS
    from int8inferenceengine_tpu_torch.ops.quant import f32, quantize_u8

    def epilogue(c, ep, *, scale_a, scale_c, zp_c, relu=False,
                 rounding="trunc", order="gemm", act=None):
        if order != "gemm":
            return orig(c, ep, scale_a=scale_a, scale_c=scale_c, zp_c=zp_c,
                        relu=relu, rounding=rounding, order=order, act=act)
        q = (c.to(torch.float64) * ep.reshape(1, -1).to(torch.float64)
             + float(zp_c)).to(torch.float32).clamp(0.0, 255.0)
        if rounding == "nearest":
            q = q + f32(0.5, c.device)
        qi = q.to(torch.int32)
        if act is not None:
            name, act_scale, act_zp = act
            x = ((qi.to(torch.float32) - f32(zp_c, c.device))
                 * f32(scale_c, c.device))
            return quantize_u8(ACTIVATIONS[name](x), act_scale, act_zp,
                               rounding)
        return (qi.clamp_min(int(zp_c)) if relu else qi).to(torch.uint8)

    return epilogue


def test_nearest_tie_moves_with_xla_fma_contraction(monkeypatch):
    """gpt_tiny (vocab 97, dim 128, depth 2, 4 heads) under 'nearest',
    converted by the port on the tenth 4 x 16 draw of seed 0 and carried
    into the JAX package: its jitted ``generate(prompt[:, :8], 20)`` leaves
    the port's tokens on row 0 from step 12.  The cause is XLA:CPU, not
    the port: the jitted program contracts the GEMM epilogue's ``acc *
    mult + zp`` into one fused multiply-add, which rounds once, where the
    reference's order (the JAX package run op by op, the port, the card's
    ``__fmul_rn``/``__fadd_rn``) rounds the product and then the sum.  A
    value such as fc1's 22524 * 0.002020067 + 128 is 173.5 exactly when
    rounded twice (code 174 under 'nearest') and 173.49998 when fused
    (code 173).  The port's greedy tokens with its epilogue rounded once
    are JAX's jitted tokens on every row and step."""
    from int8inferenceengine_tpu_torch.ops import gemm_int8 as G
    from test_torch_cnn_zoo import install_jax_state
    from test_torch_parallel import twin_state
    geo = dict(vocab_size=97, max_len=48, dim=128, depth=2, heads=4)
    rng = np.random.default_rng(0)
    for _ in range(10):
        ids = rng.integers(0, 97, (4, 16)).astype(np.int32)
    m = tzoo.build("gpt_tiny", config=qt.QuantConfig(rounding="nearest"),
                   device="cpu", **geo)
    m.load(twin_state("gpt_tiny", **geo))
    m.prepare()
    m(qt.tensor(ids, device="cpu"))
    m.convert()
    jm = jzoo.build("gpt_tiny", config=qj.QuantConfig(rounding="nearest"),
                    **geo)
    install_jax_state(jm, export_state(m))
    prompt = ids[:, :8]
    want = np.asarray(jm.generate(prompt, 20))
    got = m.generate(prompt, 20)
    np.testing.assert_array_equal(np.argwhere(got != want)[:, 0], [0] * 8)
    np.testing.assert_array_equal(np.argwhere(got != want)[:, 1],
                                  np.arange(12, 20))
    monkeypatch.setattr(G, "_requant_epilogue",
                        _fma_epilogue(G._requant_epilogue))
    np.testing.assert_array_equal(m.generate(prompt, 20), want)
