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
  ``generate()`` (``test_torch_speculative`` holds it to the JAX package).
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
