"""PyTorch port vs JAX package: the GPT-NeoX / Pythia family
(``models/neox.py``), mirroring ``tests/test_neox.py`` at a tiny size
(vocab 97, max_len 48, dim 64, depth 2, 4 heads of 16).

* the FP32 forward against the port's ``torch_neox`` twin, whose weights
  equal the JAX package's twin's: 1e-5 of the largest logit (the JAX
  test's own bound is 5e-5), parallel and sequential residual, rotary on
  25%, 50% and 100% of each head, and a non-default eps;
* W8A8 ('nearest') with the JAX converted state carried over, under the
  gpt decoder's contract (``test_torch_text_decoder``): the logit codes of
  a 16-token forward equal the JAX forward's (jitted and eager) on at
  least 99% of entries and within 2 codes everywhere, since the glue's
  float reductions and transcendentals (the norms, gelu's erfc, RoPE's
  cos/sin) differ by an ULP between the frameworks and move codes on
  rounding boundaries.  Measured: 19 of 4,656 codes one step apart with
  the parallel residual, none with the sequential one; 20 greedy tokens
  equal to JAX's ``generate()`` in both;
* the port's own gates: cached decode equal to its full recompute, the
  cache rows of the partially rotated k equal to a recompute's, the
  engine, chunked prefill, the prefix cache and speculative decoding equal
  to ``generate()``; the registry names; the ``_residual`` hook changes
  nothing for llama (``test_torch_llama``, ``test_torch_gemma``).

The HF ``gpt_neox.*`` key naming (``test_hf_neox_naming_loads``) waits
for the port's HF I/O (ROADMAP item 9a).
"""

import jax
import numpy as np
import pytest
import torch

import int8inferenceengine_tpu as qj
from int8inferenceengine_tpu.models import zoo as jzoo
from int8inferenceengine_tpu.models.neox import torch_neox as j_torch_neox
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch.carry import load_jax_state
from int8inferenceengine_tpu_torch.models import zoo as tzoo
from int8inferenceengine_tpu_torch.models.neox import NeoXDecoder, torch_neox
from int8inferenceengine_tpu_torch.serve import GenerationEngine
from int8inferenceengine_tpu_torch.tensor import Tensor
from test_torch_text_decoder import jax_state
from test_torch_threads import one_torch_thread  # noqa: F401

GEO = dict(vocab_size=97, max_len=48, dim=64, depth=2, heads=4)
NEAREST = dict(rounding="nearest")


def _ids(b, t, seed):
    return np.random.default_rng(seed).integers(
        0, GEO["vocab_size"], (b, t)).astype(np.int32)


def _cpu(x):
    return qt.tensor(x, device="cpu")


@pytest.mark.parametrize("parallel,rotary_pct,eps", [
    (True, 0.25, 1e-5), (False, 0.25, 1e-5), (True, 0.5, 1e-5),
    (True, 1.0, 1e-5), (True, 0.25, 1e-1)])
def test_fp32_parity_vs_twin(parallel, rotary_pct, eps):
    kw = dict(use_parallel_residual=parallel, rotary_pct=rotary_pct,
              eps=eps)
    tw, jtw = torch_neox(**GEO, **kw), j_torch_neox(**GEO, **kw)
    for key, v in jtw.state_dict().items():
        assert torch.equal(tw.state_dict()[key], v), key
    ids = torch.tensor(_ids(2, 16, 0), dtype=torch.long)
    ref = tw(ids).detach().numpy()
    np.testing.assert_allclose(jtw(ids).detach().numpy(), ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())
    m = NeoXDecoder(**GEO, device="cpu", **kw)
    m.load(tw.state_dict())
    assert m.rq1.rotary_dim == (None if rotary_pct == 1.0
                                else int(16 * rotary_pct))
    np.testing.assert_allclose(m(_cpu(ids.numpy())).numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_parallel_and_sequential_residual_differ():
    ids = torch.tensor(_ids(2, 16, 1), dtype=torch.long)
    with torch.no_grad():
        a = torch_neox(**GEO, use_parallel_residual=True)(ids)
        b = torch_neox(**GEO, use_parallel_residual=False)(ids)
    assert float((a - b).abs().max()) > 1e-3


@pytest.fixture(scope="module")
def ref():
    """The JAX NeoX in both residual forms ('nearest'): converted state,
    eager forward codes, greedy tokens."""
    out = {}
    x, prompt = _ids(3, 16, 1), _ids(2, 10, 2)
    for parallel in (True, False):
        jm = jzoo.build("neox_tiny", config=qj.QuantConfig(**NEAREST),
                        use_parallel_residual=parallel, **GEO)
        jm.load(torch_neox(**GEO, use_parallel_residual=parallel)
                .state_dict())
        jm.prepare()
        jm(qj.tensor(_ids(4, 16, 0)))
        jm.convert()
        with jax.disable_jit():
            eager = np.asarray(jm(qj.tensor(x)).data)
        out[parallel] = dict(state=jax_state(jm), eager=eager,
                             jit=np.asarray(jm(qj.tensor(x)).data),
                             tokens=np.asarray(jm.generate(prompt, 20)))
    return dict(out, x=x, prompt=prompt)


def _carried(ref, parallel):
    m = tzoo.build("neox_tiny", config=qt.QuantConfig(**NEAREST),
                   device="cpu", use_parallel_residual=parallel, **GEO)
    load_jax_state(m, ref[parallel]["state"])
    return m


@pytest.mark.parametrize("parallel", [True, False])
def test_int8_codes_within_contract_of_jax(ref, parallel):
    m = _carried(ref, parallel)
    got = m(_cpu(ref["x"])).data.numpy()
    for what in ("jit", "eager"):
        want = ref[parallel][what]
        assert got.shape == want.shape and len(np.unique(want)) > 32
        steps = np.abs(np.round((got - want) / m.head.scale))
        assert steps.max() <= 2, what
        assert (steps == 0).mean() >= 0.99, what


@pytest.mark.parametrize("parallel", [True, False])
def test_generate_tokens_equal_jax(ref, parallel):
    got = _carried(ref, parallel).generate(ref["prompt"], 20)
    np.testing.assert_array_equal(got, ref[parallel]["tokens"])


def _calibrated(parallel=True):
    m = NeoXDecoder(**GEO, use_parallel_residual=parallel,
                    config=qt.QuantConfig(**NEAREST), device="cpu")
    m.load(torch_neox(**GEO, use_parallel_residual=parallel).state_dict())
    m.prepare()
    m(_cpu(_ids(4, 16, 0)))
    m.convert()
    return m


@pytest.mark.parametrize("parallel", [True, False])
def test_cached_decode_equals_recompute(parallel):
    m = _calibrated(parallel)
    ids = _ids(2, 6, 3)
    toks = m.generate(ids, 8)
    seq = ids
    for _ in range(8):
        codes = m(_cpu(seq)).data.numpy()
        seq = np.concatenate([seq, codes[:, -1].argmax(-1)[:, None]], 1)
    np.testing.assert_array_equal(seq[:, 6:], toks)
    # the cache: decode steps leave the rows a prefill of the longer
    # sequence writes (post-rotation k on rk's grid, 4 of 16 channels
    # rotated)
    with torch.no_grad():
        _, cache = m._prefill(Tensor(torch.tensor(ids, dtype=torch.int64)))
        for j in range(8):
            m._decode_step(cache, 6 + j,
                           torch.tensor(toks[:, j], dtype=torch.int64))
        _, full = m._prefill(Tensor(torch.tensor(seq[:, :14],
                                                 dtype=torch.int64)))
    for i in (1, 2):
        for a, b in zip(cache[i], full[i]):
            assert torch.equal(a[:, :14], b[:, :14])


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
        sampled = eng.submit(ids[0], 10, temperature=1.0, seed=1,
                             top_p=0.8).result(timeout=120)
    finally:
        eng.shutdown()
    np.testing.assert_array_equal(np.stack(got), want)
    np.testing.assert_array_equal(chunked, want_long)
    np.testing.assert_array_equal(prefixed, want_long)
    np.testing.assert_array_equal(
        sampled, m.generate(ids[:1], 10, temperature=1.0, seed=1,
                            top_p=0.8)[0])
    np.testing.assert_array_equal(m.generate_speculative(m, ids, 10, k=3),
                                  want)


def test_registry_names():
    m = tzoo.build("neox_tiny", device="cpu")
    assert isinstance(m, NeoXDecoder) and m.parallel_residual
    assert m.kv_heads == m.heads == 4 and m.rotary_dim == 8
    assert m.gelu1.fn_name == "gelu" and m.ln1_1.eps == 1e-5
    tw, jtw = tzoo.torch_twin("neox_tiny"), jzoo.torch_twin("neox_tiny")
    assert set(tw.state_dict()) == set(jtw.state_dict())
    for key, v in jtw.state_dict().items():
        assert torch.equal(tw.state_dict()[key], v), key
