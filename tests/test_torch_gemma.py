"""PyTorch port vs JAX package: the gemma-2 family (``models/gemma.py``),
mirroring ``tests/test_gemma.py`` at a tiny size (vocab 211, max_len 48,
dim 64, depth 2, 4 heads over 2 kv heads, a window of 8 on block 1).

* the FP32 forward against the port's ``torch_gemma`` twin, whose weights
  and logits equal the JAX package's twin: 1e-5 of the largest logit (the
  JAX test's own bound is 1e-4), at the default and at wide heads
  (head_dim 32 x 4 heads > dim 64);
* W8A8 ('nearest') with the JAX converted state carried over: the logit
  codes of a 16-token forward and a 10-token prompt's 20 greedy tokens equal
  to the JAX package's (no tanh boundary shows at these seeds), and the
  carry round trip keeps the unit-offset gains as deltas (the norms carry
  random deltas from N(0, 0.1), where the twin starts them at 0);
* the port's own cached decode equal to its full recompute; a tight
  attention softcap moves the tokens; ``build("gemma_tiny")``; the engine
  equal to ``generate()``.

* the checkpoint round trip (``test_checkpoint_roundtrip``): the port's
  artifact (.safetensors) gives the saved model's 8 greedy tokens; the JAX
  package's artifact of its converted state equals the port's of the
  carried state (the unit-offset deltas carried as deltas), and the port
  loads it with the carried model's codes.
"""

import numpy as np
import pytest
import torch

import int8inferenceengine_tpu as qj
from int8inferenceengine_tpu.models import zoo as jzoo
from int8inferenceengine_tpu.models.gemma import torch_gemma as j_torch_gemma
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch.carry import export_state, load_jax_state
from int8inferenceengine_tpu_torch.models import zoo as tzoo
from int8inferenceengine_tpu_torch.models.gemma import (GemmaDecoder,
                                                        torch_gemma)
from int8inferenceengine_tpu_torch.serve import GenerationEngine
from test_torch_text_decoder import (assert_own_gate, jax_state,
                                     own_calibration_gap)
from test_torch_threads import one_torch_thread  # noqa: F401

GEO = dict(vocab_size=211, max_len=48, dim=64, depth=2, heads=4, kv_heads=2,
           sliding_window=8)
NEAREST = dict(rounding="nearest")


def _ids(b, t, seed):
    return np.random.default_rng(seed).integers(
        0, GEO["vocab_size"], (b, t)).astype(np.int32)


def _state(geo=GEO, **kw):
    """The twin's weights with the norms' unit-offset deltas drawn from
    N(0, 0.1) (the twin starts them at 0)."""
    state = torch_gemma(**geo, **kw).state_dict()
    rng = np.random.default_rng(3)
    for key, v in state.items():
        if key.startswith(("ln", "postn")):
            state[key] = torch.tensor(
                0.1 * rng.standard_normal(v.shape).astype(np.float32))
    return state


def _calibrated(geo=GEO, **kw):
    m = GemmaDecoder(**geo, config=qt.QuantConfig(**NEAREST), device="cpu",
                     **kw)
    m.load(_state(geo, **kw))
    m.prepare()
    m(qt.tensor(_ids(2, 16, 0), device="cpu"))
    m.convert()
    return m


@pytest.mark.parametrize("head_dim", [None, 32])
def test_fp32_parity_vs_twin(head_dim):
    tw = torch_gemma(**GEO, head_dim=head_dim)
    jtw = j_torch_gemma(**GEO, head_dim=head_dim)
    for key, v in jtw.state_dict().items():
        assert torch.equal(tw.state_dict()[key], v), key
    state = _state(head_dim=head_dim)
    tw.load_state_dict(state)
    jtw.load_state_dict(state)
    ids = torch.tensor(_ids(2, 16, 0), dtype=torch.long)
    ref = tw(ids).detach().numpy()
    np.testing.assert_allclose(jtw(ids).detach().numpy(), ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())
    m = GemmaDecoder(**GEO, head_dim=head_dim, device="cpu")
    m.load(state)
    got = m(qt.tensor(ids.numpy(), device="cpu")).numpy()
    assert m.wq1.out_channels == 4 * (head_dim or 16)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.fixture(scope="module")
def ref():
    """The JAX gemma's converted state ('nearest'), its forward codes and
    its greedy tokens."""
    jm = jzoo.build("gemma_tiny", config=qj.QuantConfig(**NEAREST), **GEO)
    jm.load(_state())
    jm.prepare()
    jm(qj.tensor(_ids(2, 16, 0)))
    jm.convert()
    x, prompt = _ids(3, 16, 1), _ids(2, 10, 2)
    return dict(state=jax_state(jm), x=x, prompt=prompt,
                codes=np.asarray(jm(qj.tensor(x)).data),
                tokens=np.asarray(jm.generate(prompt, 20)))


def _carried(ref):
    m = tzoo.build("gemma_tiny", config=qt.QuantConfig(**NEAREST),
                   device="cpu", **GEO)
    load_jax_state(m, ref["state"])
    return m


def test_int8_codes_equal_jax(ref):
    got = _carried(ref)(qt.tensor(ref["x"], device="cpu")).data.numpy()
    assert got.shape == ref["codes"].shape
    assert len(np.unique(ref["codes"])) > 32
    np.testing.assert_array_equal(got, ref["codes"])


def test_own_calibration_gate(ref):
    """The port's own lifecycle (``_calibrated``, the JAX one's weights and
    ids): every zero point equal, the output scales within 12 float32 ULPs
    of the JAX package's (the head; the first max to depart is ln1_1's, 1
    ULP: the RMSNorm's float32 mean of squares and XLA's approximate rsqrt
    against the port's float64 ones, rounded once; the first scale is
    wk1's, 3 ULPs), the 3 x 16 forward's codes and the 20 greedy tokens
    equal."""
    m = _calibrated()
    gap = own_calibration_gap(
        m, ref["state"], m(qt.tensor(ref["x"], device="cpu")).data.numpy(),
        ref["codes"], m.generate(ref["prompt"], 20), ref["tokens"])
    assert_own_gate(gap, scale_ulps=12, equal=1.0, max_dist=0,
                    token_steps=20)


def test_generate_tokens_equal_jax(ref):
    got = _carried(ref).generate(ref["prompt"], 20)
    np.testing.assert_array_equal(got, ref["tokens"])


def test_carry_round_trip_keeps_unit_offset_deltas(ref):
    m = _carried(ref)
    back = export_state(m)
    assert set(back) == set(ref["state"])
    for name in ("postn1_1", "postn2_2", "ln1_1", "ln_f"):
        want = ref["state"][name]["params"]["weight"]
        np.testing.assert_array_equal(back[name]["params"]["weight"], want)
        assert getattr(m, name).unit_offset
    # the deltas are carried as they are: the gain 1 + w is never folded in
    np.testing.assert_array_equal(back["postn1_1"]["params"]["weight"],
                                  _state()["postn1_1.weight"].numpy())


def test_checkpoint_roundtrip(tmp_path):
    from int8inferenceengine_tpu_torch import utils
    m, ids = _calibrated(), _ids(2, 16, 0)
    want = m.generate(ids, 8)
    path = str(tmp_path / "gemma.safetensors")
    utils.save(m, path)
    fresh = GemmaDecoder(**GEO, config=qt.QuantConfig(**NEAREST),
                         device="cpu")
    utils.load(fresh, path)
    np.testing.assert_array_equal(fresh.generate(ids, 8), want)


def test_artifact_equals_jax(ref, tmp_path):
    from int8inferenceengine_tpu_torch import utils
    from test_torch_checkpoint import assert_same_artifact, install_state
    m = _carried(ref)
    jm = install_state(jzoo.build("gemma_tiny",
                                  config=qj.QuantConfig(**NEAREST), **GEO),
                       ref["state"])
    jp, _ = assert_same_artifact(jm, m, tmp_path)
    x = qt.tensor(ref["x"], device="cpu")
    got = utils.load(_carried(ref), jp)
    np.testing.assert_array_equal(got(x).numpy(), m(x).numpy())


def test_cached_decode_equals_recompute():
    m = _calibrated()
    ids = _ids(2, 16, 0)
    toks = m.generate(ids, 16)
    longer = np.concatenate([ids, toks[:, :8]], 1)
    np.testing.assert_array_equal(m.generate(longer, 8), toks[:, 8:16])
    seq = ids
    for _ in range(4):
        codes = m(qt.tensor(seq, device="cpu")).data.numpy()
        seq = np.concatenate([seq, codes[:, -1].argmax(-1)[:, None]], 1)
    np.testing.assert_array_equal(seq[:, 16:], toks[:, :4])


def test_softcap_changes_scores():
    """A tight attention softcap moves the logit codes (with random norm
    deltas the greedy tokens happen to stay)."""
    x = qt.tensor(_ids(2, 16, 0), device="cpu")
    a = _calibrated()(x).data
    b = _calibrated(attn_softcap=0.05)(x).data
    assert (a != b).float().mean() > 0.1


def test_registry_and_engine():
    geo = dict(vocab_size=128, max_len=48, dim=64, depth=2, heads=4)
    m = tzoo.build("gemma_tiny", config=qt.QuantConfig(**NEAREST),
                   device="cpu", **geo)
    assert isinstance(m, GemmaDecoder) and m.kv_heads == 2
    assert m.smax1.window == 32 and m.smax2.window is None
    assert m.smax1.softcap == 50.0 and m.final_softcap == 30.0
    m.load(torch_gemma(**geo, kv_heads=2).state_dict())
    ids = _ids(2, 8, 2) % 128
    m.prepare()
    m(qt.tensor(ids, device="cpu"))
    m.convert()
    eng = GenerationEngine(m, slots=2, chunk_steps=4)
    try:
        got = [eng.submit(ids[i], 8).result(timeout=120) for i in range(2)]
    finally:
        eng.shutdown()
    np.testing.assert_array_equal(np.stack(got), m.generate(ids, 8))


def test_torch_twin_by_name():
    tw = tzoo.torch_twin("gemma_tiny")
    jtw = jzoo.torch_twin("gemma_tiny")
    assert set(tw.state_dict()) == set(jtw.state_dict())
    for key, v in jtw.state_dict().items():
        assert torch.equal(tw.state_dict()[key], v), key
