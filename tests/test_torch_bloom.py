"""PyTorch port vs JAX package: the BLOOM family with ALiBi
(``models/bloom.py``, ``QuantSoftmax(alibi_heads=)``, the ALiBi decode
attention) and OPT (``opt_tiny``, ``TextDecoder(act="relu")``), mirroring
``tests/test_bloom.py`` and ``tests/test_hf_checkpoint.py``'s
``test_opt_tiny_registry_and_decode`` at a tiny size (vocab 97, max_len 48,
dim 64, depth 2, 4 heads; OPT 2 heads).

* the slope ladder is the code's formula, 2^(-8(h+1)/H) with the
  non-power-of-two interpolation, equal to the JAX package's
  ``alibi_slopes`` (not its docstring's 2^(-8h/H));
* the FP32 forward against the port's twins, whose weights equal the JAX
  package's twins': 1e-5 of the largest logit; the bias moves the logits
  of a permuted prompt;
* W8A8 ('nearest', the JAX tests' configuration) with the JAX converted
  state carried over: the logit codes of a 16-token forward equal the JAX
  package's, and 16 greedy tokens equal its ``generate()``;
* the ALiBi decode attention (``decode_attention_flat(alibi=)``) equal to
  the JAX package's composed route on the same codes, at one query row and
  at 3 extend rows with a per-sequence length vector, GQA included;
  ``backend='pallas'`` with ALiBi and a slope count other than the heads
  raise ``ValueError``, as in JAX;
* the port's own gates: cached decode equal to its full recompute (BLOOM
  over the u8 cache and, in W8-float, over the float cache, whose composed
  attention picks up the bias through ``QuantSoftmax``), the engine,
  chunked prefill, the prefix cache and speculative decoding equal to
  ``generate()``; the registry names.

Left out: the HF key naming (``test_hf_bloom_naming_loads``, ROADMAP item
9a) and head-local tensor parallelism (``test_tp_no_head_local``, item
10).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import int8inferenceengine_tpu as qj
from int8inferenceengine_tpu import layers as JL
from int8inferenceengine_tpu.models import zoo as jzoo
from int8inferenceengine_tpu.models.bloom import torch_bloom as j_torch_bloom
from int8inferenceengine_tpu.models.text_decoder import \
    torch_text_decoder as j_torch_text_decoder
from int8inferenceengine_tpu.ops import attention as JA
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch.carry import load_jax_state
from int8inferenceengine_tpu_torch.layers import QuantSoftmax, alibi_slopes
from int8inferenceengine_tpu_torch.models import zoo as tzoo
from int8inferenceengine_tpu_torch.models.bloom import (BloomDecoder,
                                                        torch_bloom)
from int8inferenceengine_tpu_torch.models.text_decoder import (
    TextDecoder, torch_text_decoder)
from int8inferenceengine_tpu_torch.ops import attention as TA
from int8inferenceengine_tpu_torch.serve import GenerationEngine
from test_torch_cnn_zoo import exact_jit
from test_torch_text_decoder import jax_state
from test_torch_threads import one_torch_thread  # noqa: F401

GEO = dict(vocab_size=97, max_len=48, dim=64, depth=2, heads=4)
OPT_GEO = dict(GEO, heads=2)
NEAREST = dict(rounding="nearest")
KW = dict(scale_q=0.02, zp_q=120, scale_k=0.03, zp_k=130, scale_v=0.025,
          zp_v=125, scale_s=0.5, zp_s=100, scale_p=1 / 255, zp_p=0,
          scale_c=0.02, zp_c=128, alpha=0.125, rounding="trunc")


def _ids(b, t, seed):
    return np.random.default_rng(seed).integers(
        0, GEO["vocab_size"], (b, t)).astype(np.int32)


def _cpu(x):
    return qt.tensor(x, device="cpu")


def test_alibi_slope_ladder():
    for h in (1, 2, 4, 6, 8, 12, 16, 24):
        assert alibi_slopes(h) == JL.alibi_slopes(h), h
    np.testing.assert_allclose(alibi_slopes(8),
                               [2.0 ** -(i + 1) for i in range(8)])
    np.testing.assert_allclose(alibi_slopes(4),
                               [2.0 ** (-2 * (i + 1)) for i in range(4)])
    s6 = alibi_slopes(6)        # the interpolation: 4's ladder, then 8's odd
    np.testing.assert_allclose(s6, list(alibi_slopes(4)) + [2.0 ** -1,
                                                           2.0 ** -3])
    sm = QuantSoftmax(alibi_heads=6, device="cpu")
    assert sm.alibi.dtype == torch.float32
    np.testing.assert_array_equal(sm.alibi.numpy(),
                                  np.float32(np.array(s6)))


@pytest.mark.parametrize("name", ["bloom_tiny", "opt_tiny"])
def test_fp32_parity_vs_twin(name):
    if name == "bloom_tiny":
        geo, tw, jtw = GEO, torch_bloom(**GEO), j_torch_bloom(**GEO)
    else:
        geo = OPT_GEO
        tw = torch_text_decoder(act="relu", **geo)
        jtw = j_torch_text_decoder(act="relu", **geo)
    for key, v in jtw.state_dict().items():
        assert torch.equal(tw.state_dict()[key], v), key
    ids = torch.tensor(_ids(2, 16, 0), dtype=torch.long)
    with torch.no_grad():
        ref = tw(ids).numpy()
        np.testing.assert_allclose(jtw(ids).numpy(), ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max())
    m = tzoo.build(name, device="cpu", **geo)
    m.load(tw.state_dict())
    np.testing.assert_allclose(m(_cpu(ids.numpy())).numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_alibi_positions_the_scores():
    tw = torch_bloom(**GEO)
    ids = torch.tensor(_ids(1, 12, 1), dtype=torch.long)
    with torch.no_grad():
        a, b = tw(ids), tw(ids[:, torch.randperm(12)])
    assert float((a[:, -1] - b[:, -1]).abs().max()) > 1e-3


@pytest.fixture(scope="module")
def ref():
    """BLOOM and OPT ('nearest') converted in the JAX package:
    state, forward codes, greedy tokens."""
    out = {}
    x, prompt = _ids(3, 16, 1), _ids(2, 10, 2)
    for name, geo, cfg, tw in (
            ("bloom_tiny", GEO, NEAREST, torch_bloom(**GEO)),
            ("opt_tiny", OPT_GEO, NEAREST,
             torch_text_decoder(act="relu", **OPT_GEO))):
        jm = jzoo.build(name, config=qj.QuantConfig(**cfg), **geo)
        jm.load(tw.state_dict())
        jm.prepare()
        jm(qj.tensor(_ids(4, 16, 0)))
        jm.convert()
        out[name] = dict(state=jax_state(jm), cfg=cfg, geo=geo,
                         codes=np.asarray(jm(qj.tensor(x)).data),
                         tokens=np.asarray(jm.generate(prompt, 16)))
    return dict(out, x=x, prompt=prompt)


def _carried(ref, name):
    r = ref[name]
    m = tzoo.build(name, config=qt.QuantConfig(**r["cfg"]), device="cpu",
                   **r["geo"])
    load_jax_state(m, r["state"])
    return m


@pytest.mark.parametrize("name", ["bloom_tiny", "opt_tiny"])
def test_int8_codes_and_tokens_equal_jax(ref, name):
    m = _carried(ref, name)
    want = ref[name]["codes"]
    got = m(_cpu(ref["x"])).data.numpy()
    assert len(np.unique(want)) > 32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(m.generate(ref["prompt"], 16),
                                  ref[name]["tokens"])


@pytest.mark.parametrize("n_kv,mq", [(4, 1), (4, 3), (2, 3)])
def test_alibi_decode_attention_equals_jax(n_kv, mq):
    rng = np.random.default_rng(7 + mq + n_kv)
    b, t, h, d = 2, 32, 4, 16
    q = rng.integers(0, 256, (b, mq, h * d) if mq > 1 else (b, h * d))
    k = rng.integers(0, 256, (b, t, n_kv * d))
    v = rng.integers(0, 256, (b, t, n_kv * d))
    valid = np.array([5, 29 - mq], np.int32)
    slopes = alibi_slopes(h)
    want = np.asarray(exact_jit(
        lambda q_, k_, v_, n_: JA.decode_attention_flat(
            q_, k_, v_, n_, n_heads=h, n_kv_heads=n_kv, backend="xla",
            alibi=slopes, **KW),
        jnp.asarray(q, jnp.uint8), jnp.asarray(k, jnp.uint8),
        jnp.asarray(v, jnp.uint8), jnp.asarray(valid)))
    before = TA.decode_attention_alibi.calls
    got = TA.decode_attention_flat(
        torch.tensor(q, dtype=torch.uint8), torch.tensor(k, dtype=torch.uint8),
        torch.tensor(v, dtype=torch.uint8), torch.tensor(valid), n_heads=h,
        n_kv_heads=n_kv, alibi=torch.tensor(slopes, dtype=torch.float32),
        **KW)
    assert TA.decode_attention_alibi.calls == before + 1
    np.testing.assert_array_equal(got.numpy(), want)
    # without the bias the codes move
    plain = TA.decode_attention_flat(
        torch.tensor(q, dtype=torch.uint8), torch.tensor(k, dtype=torch.uint8),
        torch.tensor(v, dtype=torch.uint8), torch.tensor(valid), n_heads=h,
        n_kv_heads=n_kv, **KW)
    assert (plain != got).any()


def test_alibi_pallas_backend_and_slope_count_refused():
    q = torch.zeros((2, 128), dtype=torch.uint8)
    k = torch.zeros((2, 32, 128), dtype=torch.uint8)
    with pytest.raises(ValueError, match="ALiBi"):
        TA.decode_attention_flat(q, k, k, 5, n_heads=4, backend="pallas",
                                 alibi=alibi_slopes(4), **KW)
    with pytest.raises(ValueError, match="slopes"):
        TA.decode_attention_flat(q, k, k, 5, n_heads=4, backend="xla",
                                 alibi=alibi_slopes(8), **KW)
    m = BloomDecoder(**GEO, config=qt.QuantConfig(decode_attention="pallas"),
                     device="cpu")
    m.load(torch_bloom(**GEO).state_dict())
    m.prepare()
    m(_cpu(_ids(2, 8, 0)))
    m.convert()
    with pytest.raises(ValueError, match="ALiBi"):
        m.generate(_ids(1, 4, 1), 2)


def _calibrated(config=NEAREST):
    m = BloomDecoder(**GEO, config=qt.QuantConfig(**config), device="cpu")
    m.load(torch_bloom(**GEO).state_dict())
    if not config.get("weight_only"):
        m.prepare()
        m(_cpu(_ids(4, 16, 0)))
    m.convert()
    return m


@pytest.mark.parametrize("config", [NEAREST, dict(weight_only=True)],
                         ids=["int8", "w8f"])
def test_cached_decode_equals_recompute(config):
    m = _calibrated(config)
    ids = _ids(2, 6, 3)
    toks = m.generate(ids, 8)
    seq = ids
    for _ in range(8):
        out = m(_cpu(seq)).data.numpy()
        seq = np.concatenate([seq, out[:, -1].argmax(-1)[:, None]], 1)
    np.testing.assert_array_equal(seq[:, 6:], toks)


def test_engine_chunked_prefix_and_speculative_equal_generate():
    m = _calibrated()
    ids, long = _ids(2, 7, 4), _ids(1, 20, 5)[0]
    want = m.generate(ids, 10)
    want_long = m.generate(long[None], 8)[0]
    eng = GenerationEngine(m, slots=2, chunk_steps=4, prefill_chunk=8)
    try:
        got = [eng.submit(ids[i], 10).result(timeout=120) for i in range(2)]
        chunked = eng.submit(long, 8).result(timeout=120)
        pid = eng.register_prefix(long[:12])
        prefixed = eng.submit(long, 8, prefix_id=pid).result(timeout=120)
        sampled = eng.submit(ids[0], 10, temperature=1.0, seed=1, top_k=20,
                             top_p=0.9).result(timeout=120)
    finally:
        eng.shutdown()
    np.testing.assert_array_equal(np.stack(got), want)
    np.testing.assert_array_equal(chunked, want_long)
    np.testing.assert_array_equal(prefixed, want_long)
    np.testing.assert_array_equal(
        sampled, m.generate(ids[:1], 10, temperature=1.0, seed=1, top_k=20,
                            top_p=0.9)[0])
    np.testing.assert_array_equal(m.generate_speculative(m, ids, 10, k=3),
                                  want)


def test_registry_names():
    m = tzoo.build("bloom_tiny", device="cpu")
    assert isinstance(m, BloomDecoder) and not hasattr(m, "pe")
    np.testing.assert_array_equal(m.smax1.alibi.numpy(),
                                  np.float32(JL.alibi_slopes(4)))
    o = tzoo.build("opt_tiny", device="cpu")
    assert type(o) is TextDecoder and o.act == "relu"
    assert o.gelu1.fn_name == "relu"
    for name in ("bloom_tiny", "opt_tiny"):
        tw, jtw = tzoo.torch_twin(name), jzoo.torch_twin(name)
        assert set(tw.state_dict()) == set(jtw.state_dict())
        for key, v in jtw.state_dict().items():
            assert torch.equal(tw.state_dict()[key], v), key
