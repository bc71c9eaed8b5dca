"""PyTorch port vs JAX package: ``QuantEmbed`` and the BERT-style text
encoder (``text_tiny``), mirroring ``tests/test_text_transformer.py``.

Both packages load the same ``torch_text_transformer`` weights (vocab 200,
16 tokens, dim 64, 2 blocks of 2 heads, MLP 2 x dim) and see the same numpy
token ids:

* the embedding's FP32 rows equal the twin's; its INT8 path is the
  quantized table's row gather, equal to the JAX package's codes; the
  calibrated range covers rows calibration never saw; out-of-vocabulary
  ids clamp to the table's edges, as in the JAX package;
* FP32 logits agree with the JAX package's and the twin's to rtol 1e-5 of
  the largest logit;
* with the JAX package's converted state carried over, the INT8 logit
  codes are equal on at least 99% of entries and within 2 codes everywhere
  (the contract of ``tests/test_torch_text_decoder.py``), ids out of the
  vocabulary included;
* the state carries both ways unchanged; the registry's names and
  ``_consumes_ids`` match.
"""

import numpy as np
import pytest
import torch

import int8inferenceengine_tpu as qj
from int8inferenceengine_tpu.layers import QuantEmbed as JQuantEmbed
from int8inferenceengine_tpu.models import text_transformer as jtt
from int8inferenceengine_tpu.models import zoo as jzoo
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch.carry import export_state, load_jax_state
from int8inferenceengine_tpu_torch.layers import QuantEmbed
from int8inferenceengine_tpu_torch.models import zoo as tzoo
from int8inferenceengine_tpu_torch.ops import functional as F
from test_torch_cnn_zoo import jax_forward
from test_torch_text_decoder import jax_state
from test_torch_threads import one_torch_thread  # noqa: F401

KW = dict(vocab_size=200, max_len=16, dim=64, depth=2, heads=2, mlp_ratio=2)


def _ids(shape, vocab=200, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.float32)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's text encoder lifecycle, run once."""
    twin = jtt.torch_text_transformer(**KW)
    sd = twin.state_dict()
    x_fp = _ids((2, 16), seed=0)
    # the test ids hold out-of-vocabulary entries (clamped to the edges)
    x_test = _ids((2, 16), seed=2)
    x_test[0, :3] = (-3, 200, 999)
    with torch.no_grad():
        twin_out = twin(torch.from_numpy(x_fp)).numpy()
    m = jzoo.build("text_tiny", **KW)
    m.load(sd)
    fp32 = m(qj.tensor(x_fp)).numpy()
    m.prepare()
    m(qj.tensor(_ids((8, 16), seed=1)))
    m.convert()
    return dict(sd=sd, x_fp=x_fp, twin=twin_out, fp32=fp32, x_test=x_test,
                int8=jax_forward(m, x_test), state=jax_state(m))


def _run(m, ids):
    return m(qt.tensor(ids, device="cpu")).numpy()


def _carried(ref):
    m = tzoo.build("text_tiny", device="cpu", **KW)
    load_jax_state(m, ref["state"])
    return m


def _embeds(table):
    """A port and a JAX QuantEmbed holding ``table``."""
    e = QuantEmbed(*table.shape, device="cpu")
    je = JQuantEmbed(*table.shape)
    e.load_weight(table)
    je.load_weight(table)
    return e, je


def test_embed_fp32_matches_torch():
    torch.manual_seed(0)
    te = torch.nn.Embedding(50, 16)
    e, _ = _embeds(te.weight.detach().numpy())
    ids = _ids((4, 7), vocab=50)
    want = te(torch.tensor(ids).long()).detach().numpy()
    np.testing.assert_allclose(e(qt.tensor(ids, device="cpu")).numpy(),
                               want, atol=1e-6)
    with pytest.raises(ValueError, match="no bias"):
        e.load_bias(np.zeros(16, np.float32))


def test_embed_int8_is_the_jax_table_gather():
    """After convert both packages hold the same u8 table and gather it."""
    table = np.random.default_rng(1).normal(0, 0.5, (50, 16)).astype(
        np.float32)
    e, je = _embeds(table)
    ids = _ids((8, 5), vocab=50, seed=2)
    for layer, tensor in ((e, lambda a: qt.tensor(a, device="cpu")),
                          (je, qj.tensor)):
        layer.prepare()
        layer(tensor(ids))
        layer.convert()
    assert (e.scale, e.zero_point) == (je.scale, je.zero_point)
    out = e(qt.tensor(ids, device="cpu"))
    assert out.quantized and (out.scale, out.zero_point) == (
        e.scale, e.zero_point)
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(je(qj.tensor(ids)).data))
    with pytest.raises(ValueError, match="raw token ids"):
        e(F.quantize(qt.tensor(ids, device="cpu"), 1.0, 0))


def test_embed_range_covers_unseen_tokens():
    table = np.zeros((10, 4), np.float32)
    table[:5] = 0.1          # the only rows seen while calibrating
    table[7] = 3.0           # unseen, far outside the observed range
    e, _ = _embeds(table)
    e.prepare()
    e(qt.tensor(np.zeros((2, 3), np.float32), device="cpu"))
    e.convert()
    out = F.dequantize(e(qt.tensor(np.full((1, 1), 7, np.float32),
                                   device="cpu"))).numpy()
    np.testing.assert_allclose(out, 3.0, atol=2 * e.scale)


def test_embed_out_of_vocab_ids_clamped():
    table = np.random.default_rng(0).normal(0, 1, (10, 4)).astype(np.float32)
    e, je = _embeds(table)
    bad = np.array([[-3, 99, 5]], np.float32)
    out = e(qt.tensor(bad, device="cpu")).numpy()
    np.testing.assert_allclose(out[0, 0], table[0], atol=1e-6)
    np.testing.assert_allclose(out[0, 1], table[9], atol=1e-6)
    np.testing.assert_array_equal(out, je(qj.tensor(bad)).numpy())


@pytest.mark.parametrize("against", ["fp32", "twin"])
def test_fp32_matches_jax_and_twin(ref, against):
    m = tzoo.build("text_tiny", device="cpu", **KW)
    m.load(ref["sd"])
    want = ref[against]
    np.testing.assert_allclose(_run(m, ref["x_fp"]), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_carried_int8_codes_match_jax(ref):
    m = _carried(ref)
    got = _run(m, ref["x_test"])
    assert got.shape == (2, 10) and np.isfinite(got).all()
    steps = np.abs(got - ref["int8"]) / m.head.scale
    assert steps.max() <= 2 + 1e-3, steps.max()
    assert (steps < 0.5).mean() >= 0.99, (steps < 0.5).mean()


def test_carry_round_trip(ref):
    m = _carried(ref)
    back = export_state(m)
    assert set(back) == set(ref["state"])
    for name, st in ref["state"].items():
        assert sorted(back[name]["params"]) == sorted(st["params"]), name
        for key, arr in st["params"].items():
            np.testing.assert_array_equal(back[name]["params"][key], arr)
    again = tzoo.build("text_tiny", device="cpu", **KW)
    load_jax_state(again, back)
    np.testing.assert_array_equal(_run(again, ref["x_test"]),
                                  _run(m, ref["x_test"]))


def test_text_registry():
    m = tzoo.build("text_tiny", vocab_size=100, max_len=8, dim=32, depth=1,
                   heads=2, device="cpu")
    assert m.INPUT_SHAPE == (8,)
    assert m._consumes_ids()
    want = [n for n, _ in jzoo.build("text_tiny", vocab_size=100, max_len=8,
                                     dim=32, depth=1,
                                     heads=2).named_layers()]
    assert [n for n, _ in m.named_layers()] == want
    with pytest.raises(ValueError, match="divisible"):
        tzoo.build("text_tiny", dim=30, heads=4, device="cpu")
