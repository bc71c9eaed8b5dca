"""PyTorch port vs JAX package: sliding-window attention (the mistral
family, ``LlamaDecoder(sliding_window=)``), mirroring
``tests/test_sliding_window.py`` at a tiny size (vocab 128, max_len 64, dim
64, depth 2, 4 heads over 2 kv heads, 'nearest').

* the mistral decoder's logit codes and greedy tokens with the JAX converted
  state carried over: equal (no tanh here; at these seeds no code sits on a
  boundary of the float64-rounded norms and exps);
* the FP32 forward against ``torch_llama(sliding_window=)``'s band mask:
  1e-5 of the largest logit;
* ``QuantSoftmax(window=)``: out-of-window probabilities are exactly the
  zero point, equal to the JAX layer's codes; square causal scores with a
  ``valid_len`` stay finite and normalized (no NaN);
* the port's own windowed cached decode equal to its recompute (W = 8, 16,
  48); a window of at least max_len equal to none; a small window changes
  the tokens; speculative decoding target-exact; the engine, and the
  engine's chunked prefill, equal to ``generate()``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import int8inferenceengine_tpu as qj
from int8inferenceengine_tpu import layers as JL
from int8inferenceengine_tpu.models import zoo as jzoo
from int8inferenceengine_tpu.models.llama import torch_llama as j_torch_llama
from int8inferenceengine_tpu.tensor import Tensor as JT
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch.carry import load_jax_state
from int8inferenceengine_tpu_torch.models import zoo as tzoo
from int8inferenceengine_tpu_torch.models.llama import torch_llama
from int8inferenceengine_tpu_torch.serve import GenerationEngine
from int8inferenceengine_tpu_torch.tensor import Tensor as TT
from test_torch_text_decoder import jax_state
from test_torch_threads import one_torch_thread  # noqa: F401

GEO = dict(vocab_size=128, max_len=64, dim=64, depth=2, heads=4, kv_heads=2)
NEAREST = dict(rounding="nearest")


def _ids(b, t, seed):
    return np.random.default_rng(seed).integers(
        0, GEO["vocab_size"], (b, t)).astype(np.int32)


def _built(w, name="llama_tiny"):
    """The port's windowed llama (the mistral topology), calibrated on
    its own 2 x 12 ids."""
    m = tzoo.build(name, sliding_window=w, config=qt.QuantConfig(**NEAREST),
                   device="cpu", **GEO)
    m.load(torch_llama(**GEO).state_dict())
    ids = _ids(2, 12, 1)
    m.prepare()
    m(qt.tensor(ids, device="cpu"))
    m.convert()
    return m, ids


@pytest.fixture(scope="module")
def ref():
    """The JAX mistral's converted state (window 16), its codes and its
    greedy tokens past the window."""
    jm = jzoo.build("mistral_tiny", config=qj.QuantConfig(**NEAREST), **GEO)
    assert jm.sliding_window == 16
    jm.load(j_torch_llama(**GEO, sliding_window=16).state_dict())
    jm.prepare()
    jm(qj.tensor(_ids(2, 12, 1)))
    jm.convert()
    x, prompt = _ids(3, 40, 2), _ids(2, 20, 3)
    return dict(state=jax_state(jm), x=x, prompt=prompt,
                codes=np.asarray(jm(qj.tensor(x)).data),
                tokens=np.asarray(jm.generate(prompt, 30)))


def _carried(ref):
    m = tzoo.build("mistral_tiny", config=qt.QuantConfig(**NEAREST),
                   device="cpu", **GEO)
    assert m.sliding_window == 16 and m.smax2.window == 16
    load_jax_state(m, ref["state"])
    return m


def test_mistral_codes_equal_jax(ref):
    got = _carried(ref)(qt.tensor(ref["x"], device="cpu")).data.numpy()
    assert len(np.unique(ref["codes"])) > 32
    np.testing.assert_array_equal(got, ref["codes"])


def test_mistral_tokens_equal_jax(ref):
    np.testing.assert_array_equal(_carried(ref).generate(ref["prompt"], 30),
                                  ref["tokens"])


def test_fp32_band_mask_matches_twin():
    tw = torch_llama(**GEO, sliding_window=8)
    for key, v in j_torch_llama(**GEO, sliding_window=8).state_dict().items():
        assert torch.equal(tw.state_dict()[key], v), key
    ids = _ids(2, 30, 4)
    want = tw(torch.tensor(ids, dtype=torch.long)).detach().numpy()
    m = tzoo.build("mistral_tiny", sliding_window=8, device="cpu", **GEO)
    m.load(tw.state_dict())
    got = m(qt.tensor(ids, device="cpu")).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    full = torch_llama(**GEO)(torch.tensor(ids, dtype=torch.long))
    assert not np.allclose(full.detach().numpy(), want)


def test_out_of_window_probabilities_are_exact_zero_codes():
    x = np.random.default_rng(0).normal(size=(1, 1, 12, 12)).astype(
        np.float32)
    codes = np.clip(np.round(x / 0.05) + 110, 0, 255).astype(np.uint8)
    jl = JL.QuantSoftmax(causal=True, window=4)
    tl = qt.QuantSoftmax(causal=True, window=4, device="cpu")
    jl.prepare()
    jl(JT(jnp.asarray(x)))
    jl.convert()
    tl.is_quantized, tl.scale, tl.zero_point = True, jl.scale, jl.zero_point
    want = np.asarray(jl(JT(jnp.asarray(codes), 0.05, 110)).data)
    got = tl(TT(torch.tensor(codes), 0.05, 110)).data.numpy()
    np.testing.assert_array_equal(got, want)
    row, col = np.meshgrid(np.arange(12), np.arange(12), indexing="ij")
    dead = (col > row) | (col <= row - 4)
    assert (got[0, 0][dead] == tl.zero_point).all()
    assert (got[0, 0][~dead] != tl.zero_point).any()


def test_windowed_square_causal_with_valid_len_no_nan():
    sm = qt.QuantSoftmax(causal=True, window=4, device="cpu")
    x = np.random.default_rng(2).normal(size=(1, 1, 12, 12)).astype(
        np.float32)
    out = sm(TT(torch.tensor(x)), valid_len=torch.tensor(9)).data.numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out[0, 0, :9].sum(-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("w", [8, 16, 48])
def test_windowed_cached_decode_equals_recompute(w):
    m, ids = _built(w)
    toks = m.generate(ids, 20)
    longer = np.concatenate([ids, toks[:, :10]], 1)
    np.testing.assert_array_equal(m.generate(longer, 10), toks[:, 10:20])


def test_window_ge_max_len_equals_unwindowed():
    wide, ids = _built(1000)
    plain = tzoo.build("llama_tiny", config=qt.QuantConfig(**NEAREST),
                       device="cpu", **GEO)
    plain.load(torch_llama(**GEO).state_dict())
    plain.prepare()
    plain(qt.tensor(ids, device="cpu"))
    plain.convert()
    np.testing.assert_array_equal(wide.generate(ids, 20),
                                  plain.generate(ids, 20))


def test_window_actually_changes_attention():
    narrow, ids = _built(4)
    wide, _ = _built(1000)
    assert not (narrow.generate(ids, 24) == wide.generate(ids, 24)).all()


def test_windowed_speculative_decode_target_exact():
    m, ids = _built(16)
    draft = tzoo.build("gpt_tiny", vocab_size=128, max_len=64, dim=32,
                       depth=1, heads=2, device="cpu")
    from int8inferenceengine_tpu_torch.models.text_decoder import \
        torch_text_decoder
    draft.load(torch_text_decoder(vocab_size=128, max_len=64, dim=32,
                                  depth=1, heads=2).state_dict())
    draft.prepare()
    draft(qt.tensor(ids, device="cpu"))
    draft.convert()
    np.testing.assert_array_equal(
        m.generate_speculative(draft, ids, 16, k=3), m.generate(ids, 16))


@pytest.mark.parametrize("prefill_chunk", [None, 8])
def test_windowed_engine_matches_generate(prefill_chunk):
    m, ids = _built(12)
    prompts = [ids[0], ids[1], _ids(1, 21, 17)[0]]      # 21: 3 chunks
    eng = GenerationEngine(m, slots=2, chunk_steps=4,
                           prefill_chunk=prefill_chunk)
    try:
        outs = [f.result(timeout=120)
                for f in [eng.submit(p, 10) for p in prompts]]
    finally:
        eng.shutdown()
    for p, o in zip(prompts, outs):
        np.testing.assert_array_equal(o, m.generate(p[None], 10)[0])
