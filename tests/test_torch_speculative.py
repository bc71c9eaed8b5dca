"""PyTorch port vs JAX package: speculative decoding
(``TextDecoder.generate_speculative``), mirroring
``tests/test_speculative.py``.

The targets carry the JAX package's converted state (gpt: vocab 128, dim
64, depth 2, 4 heads; llama W8A8: the same with 2 kv heads; max_len 64), and
the port's speculative output must equal the JAX package's greedy
``generate()`` tokens exactly: gpt with a 1-layer gpt draft at k = 1, 3 and
5, a llama target with that gpt draft, and llama self-speculation (full
acceptance).  The JAX package's own test holds its speculative loop to its
``generate()``, so the comparisons are transitive without compiling the
JAX loop here.  Also the guards, and on the card (``cuda``-marked) the
captured macro-step: tokens equal ``generate()``'s and the kernels' counts
follow the replays.
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import int8inferenceengine_tpu as qj
from int8inferenceengine_tpu.models import zoo as jzoo
from int8inferenceengine_tpu.models.llama import torch_llama as j_torch_llama
from int8inferenceengine_tpu.models.text_decoder import \
    torch_text_decoder as j_torch_text_decoder
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch.carry import load_jax_state
from int8inferenceengine_tpu_torch.models import zoo as tzoo
from int8inferenceengine_tpu_torch.models.text_decoder import \
    torch_text_decoder
from int8inferenceengine_tpu_torch.ops import attention as TA
from test_torch_text_decoder import jax_state
from test_torch_threads import one_torch_thread  # noqa: F401

VOCAB = 128
GPT = dict(vocab_size=VOCAB, max_len=64, dim=64, depth=2, heads=4)
LLAMA = dict(GPT, kv_heads=2)
DRAFT = dict(vocab_size=VOCAB, max_len=64, dim=64, depth=1, heads=2)
# (batch, prompt length, seed, steps) of each case
GPT_CASE = (4, 12, 7, 14)
LLAMA_CASES = {"gpt_draft": (3, 10, 9, 12), "self": (2, 8, 11, 10)}


def _ids(b, t, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, t)).astype(
        np.int32)


def _jax_reference(name, geo, twin, cases):
    """The JAX decoder's converted state and its generate() tokens of each
    case."""
    m = jzoo.build(name, **geo)
    m.load(twin(**geo).state_dict())
    m.prepare()
    m(qj.tensor(_ids(8, geo["max_len"], 1)))
    m.convert()
    with pltpu.force_tpu_interpret_mode():
        tokens = {key: np.asarray(m.generate(_ids(b, t, seed), steps))
                  for key, (b, t, seed, steps) in cases.items()}
    return dict(state=jax_state(m), tokens=tokens)


@pytest.fixture(scope="module")
def gpt_ref():
    return _jax_reference("gpt_tiny", GPT, j_torch_text_decoder,
                          {"gpt": GPT_CASE})


@pytest.fixture(scope="module")
def llama_ref():
    return _jax_reference("llama_tiny", LLAMA, j_torch_llama, LLAMA_CASES)


def _carried(name, geo, ref, device="cpu"):
    m = tzoo.build(name, device=device, **geo)
    load_jax_state(m, ref["state"])
    return m


def _draft(device="cpu"):
    """A 1-layer gpt over the same vocabulary, calibrated by the port."""
    m = tzoo.build("gpt_tiny", device=device, **DRAFT)
    m.load(torch_text_decoder(**DRAFT).state_dict())
    m.prepare()
    m(qt.tensor(_ids(8, DRAFT["max_len"], 3), device=device))
    m.convert()
    return m


@pytest.fixture(scope="module")
def draft():
    return _draft()


@pytest.mark.parametrize("k", [1, 3, 5])
def test_gpt_spec_equals_jax_generate(gpt_ref, draft, k):
    target = _carried("gpt_tiny", GPT, gpt_ref)
    b, t, seed, steps = GPT_CASE
    got = target.generate_speculative(draft, _ids(b, t, seed), steps, k=k)
    assert got.dtype == np.int32 and got.shape == (b, steps)
    np.testing.assert_array_equal(got, gpt_ref["tokens"]["gpt"])


def test_llama_target_gpt_draft(llama_ref, draft):
    """Cross-family speculation: a tiny gpt drafts for a llama target."""
    target = _carried("llama_tiny", LLAMA, llama_ref)
    b, t, seed, steps = LLAMA_CASES["gpt_draft"]
    got = target.generate_speculative(draft, _ids(b, t, seed), steps, k=3)
    np.testing.assert_array_equal(got, llama_ref["tokens"]["gpt_draft"])


def test_llama_self_speculation_full_acceptance(llama_ref):
    """draft == target accepts every drafted token: the output still equals
    generate()'s, in ceil((steps - 1) / (k + 1)) macro-steps."""
    m = _carried("llama_tiny", LLAMA, llama_ref)
    b, t, seed, steps = LLAMA_CASES["self"]
    before = TA.decode_attention_flat.launches
    k = 4
    got = m.generate_speculative(m, _ids(b, t, seed), steps, k=k)
    np.testing.assert_array_equal(got, llama_ref["tokens"]["self"])
    # B3 runs only on the card: on the CPU the counter stays
    assert TA.decode_attention_flat.launches == before
    n = -(-(steps - 1) // (k + 1))
    assert m.speculative_stats == dict(macro_steps=n, row_steps=b * n,
                                       emitted=b * n * (k + 1))


def test_guards(gpt_ref, draft):
    target = _carried("gpt_tiny", GPT, gpt_ref)
    prompt = _ids(2, 8, 0)
    with pytest.raises(ValueError, match="headroom"):
        target.generate_speculative(draft, prompt, 60, k=4)
    with pytest.raises(ValueError, match="steps"):
        target.generate_speculative(draft, prompt, 0, k=4)
    with pytest.raises(ValueError, match="k must"):
        target.generate_speculative(draft, prompt, 4, k=0)
    with pytest.raises(RuntimeError, match="converted"):
        tzoo.build("gpt_tiny", device="cpu", **GPT).generate_speculative(
            draft, prompt, 4)
    other = tzoo.build("gpt_tiny", device="cpu",
                       **dict(DRAFT, vocab_size=VOCAB + 1))
    other.convert()
    with pytest.raises(ValueError, match="vocab"):
        target.generate_speculative(other, prompt, 4)
    # weight-only targets decode over the float cache
    # (tests/test_torch_float_cache.py)
    wo = tzoo.build("gpt_tiny", device="cpu", config=qt.QuantConfig(
        weight_only=True, weight_bits=4), **GPT)
    wo.convert()
    np.testing.assert_array_equal(wo.generate_speculative(wo, prompt, 4),
                                  wo.generate(prompt, 4))
    # steps == 1: the prefill's token alone, no macro-step
    np.testing.assert_array_equal(
        target.generate_speculative(draft, prompt, 1),
        target.generate(prompt, 1))


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_captured_spec_equals_generate_on_card(cuda_device, gpt_ref):
    """The captured macro-step gives generate()'s tokens, and B3's count
    grows by whole macro-steps: per step (k + 1) draft decodes and one
    target extend, each one launch per layer."""
    target = _carried("gpt_tiny", GPT, gpt_ref, device=cuda_device)
    d = _draft(cuda_device)
    b, t, seed, steps = GPT_CASE
    prompt = _ids(b, t, seed)
    want = target.generate(prompt, steps)
    k = 3
    before = TA.decode_attention_flat.launches
    got = target.generate_speculative(d, prompt, steps, k=k)
    ran = TA.decode_attention_flat.launches - before
    np.testing.assert_array_equal(got, want)
    per_step = (k + 1) * DRAFT["depth"] + GPT["depth"]
    assert ran > 0 and ran % per_step == 0
    assert ran // per_step >= -(-(steps - 1) // (k + 1))
