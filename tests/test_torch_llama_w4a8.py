"""PyTorch port vs JAX package: the llama family with W4A8 weights
(``QuantConfig(weight_bits=4)``, 4-bit grouped weights on the static u8
activation path).

The JAX side runs at ``w4_kernel='pallas'`` in interpret mode, so both
packages dispatch alike: B6's function where M % 8 == 0 (and M * groups <=
1024), B7's elsewhere.  With the JAX package's converted state carried over:

* a W4A8 ``Linear``: exact where B6's function runs, within the repo's
  contract (at most one code off on at most 0.2%) where B7's does;
* the llama (``test_torch_llama``'s geometry, rounding 'nearest') at batch 2
  (the decode's M = 2 runs B7's function) and batch 8 (M = 8, B6's): logit
  codes within the contract (the glue's rsqrt, cos/sin and float sums are
  not bitwise equal across the frameworks), greedy tokens equal, and the
  port's cached decode equal to its own full recompute;
* the carry round trip of the W4A8 Linears (``w4_wsum`` carried as it is)
  and ``QuantRMSNorm``;
* the serving engine (``GenerationEngine``, two slots) on the batch-2
  prompts: its greedy tokens equal the JAX package's ``generate()``
  exactly (the prefill and the decode dispatch as JAX's batch-2 generate
  does: B6's function at M = 16, B7's at M = 2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import int8inferenceengine_tpu as qj
from int8inferenceengine_tpu import layers as JL
from int8inferenceengine_tpu.tensor import Tensor as JT
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch.carry import load_jax_state
from int8inferenceengine_tpu_torch.serve import GenerationEngine
from int8inferenceengine_tpu_torch.tensor import Tensor as TT
# ``weights`` is the shared module-scoped fixture of the same weights
from test_torch_llama import (assert_contract, assert_round_trip,  # noqa: F401
                              carried, jax_reference, jax_state, recompute,
                              weights)
from test_torch_threads import one_torch_thread  # noqa: F401

W4A8 = dict(weight_bits=4, rounding="nearest", w4_kernel="pallas")


@pytest.mark.parametrize("m", [8, 5])
def test_w4a8_linear_matches_jax(m):
    rng = np.random.default_rng(2)
    cfg = dict(weight_bits=4, w4_kernel="pallas")
    jm = qj.Module(qj.QuantConfig(**cfg))
    jm.fc = JL.Linear(256, 96, config=jm.config)
    jm.fc.load_weight(rng.normal(0, 0.1, (96, 256)).astype(np.float32))
    jm.fc.load_bias(rng.normal(0, 0.1, 96).astype(np.float32))
    jm.fc.prepare()
    jm.fc(qj.tensor(rng.normal(0, 0.8, (16, 256)).astype(np.float32)))
    jm.fc.convert()
    tm = qt.Module(qt.QuantConfig(**cfg), device="cpu")
    tm.fc = qt.Linear(256, 96, config=tm.config, device="cpu")
    load_jax_state(tm, jax_state(jm))
    codes = rng.integers(0, 256, (m, 256)).astype(np.uint8)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jm.fc(JT(jnp.asarray(codes), 0.02, 120)).data)
    got = tm.fc(TT(torch.tensor(codes), 0.02, 120)).data.numpy()
    assert len(np.unique(want)) > 32
    if m % 8 == 0:
        np.testing.assert_array_equal(got, want)
    else:
        assert_contract(got, want)


@pytest.fixture(scope="module")
def ref(weights):
    """The JAX package's W4A8 llama lifecycle, run once."""
    return jax_reference(weights, W4A8)


@pytest.mark.parametrize("b", [2, 8])
def test_carried_codes_match_jax(ref, b):
    got = carried(ref)(qt.tensor(ref["x"][b], device="cpu")).data.numpy()
    want = ref["codes"][b]
    assert got.shape == want.shape == ref["x"][b].shape + (128,)
    assert len(np.unique(want)) > 64
    assert_contract(got, want)


@pytest.mark.parametrize("b", [2, 8])
def test_generate_tokens_match_jax(ref, b):
    got = carried(ref).generate(ref["prompt"][b], 6)
    assert got.dtype == np.int32 and got.shape == (b, 6)
    np.testing.assert_array_equal(got, ref["tokens"][b])


@pytest.mark.parametrize("b", [2, 8])
def test_cached_decode_equals_full_recompute(ref, b):
    m = carried(ref)
    prompt = ref["prompt"][b]
    np.testing.assert_array_equal(m.generate(prompt, 6),
                                  recompute(m, prompt, 6))


def test_carry_round_trip_w4a8(ref):
    state = ref["state"]
    assert set(state["wq1"]["params"]) == {"w4_packed", "w4_scales", "bias",
                                           "w4_wsum"}
    assert set(state["ln1_1"]["params"]) == {"weight"}
    m = carried(ref)
    np.testing.assert_array_equal(m.wq1.w4_wsum.numpy(),
                                  state["wq1"]["params"]["w4_wsum"])
    assert_round_trip(m, state)


def test_engine_tokens_match_jax_generate(ref):
    eng = GenerationEngine(carried(ref), slots=2, chunk_steps=4)
    try:
        futs = [eng.submit(p, 6) for p in ref["prompt"][2]]
        for fut, want in zip(futs, ref["tokens"][2]):
            np.testing.assert_array_equal(fut.result(timeout=120), want)
    finally:
        eng.shutdown()
