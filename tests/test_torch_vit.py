"""PyTorch port vs JAX package: the Vision Transformer (``vit_tiny``).

Both packages load the same ``torch_vit`` weights (32 x 32 images, patch
8, dim 64, 2 blocks of 2 heads, MLP 2 x dim) and see the same numpy
inputs (batch 2):

* FP32 logits agree with the JAX package's and the twin's to rtol 1e-5 of
  the largest logit;
* with the JAX package's converted state carried over, the INT8 logit
  codes are equal on at least 99% of entries and within 2 codes everywhere
  (the glue's float reductions and transcendentals differ by an ULP
  between the frameworks), against the JAX forward compiled without XLA's
  algebraic simplifier (``test_torch_cnn_zoo.jax_forward``);
* ``fused_attention`` 'auto' and 'xla' give 'off''s codes bit for bit;
  'pallas' raises, as in the JAX package;
* the token layout ops equal the JAX package's, the state carries both
  ways unchanged, and the JAX tests' guards hold.
"""

import numpy as np
import pytest
import torch

import int8inferenceengine_tpu as qj
from int8inferenceengine_tpu.models import vit as jvit
from int8inferenceengine_tpu.models import zoo as jzoo
from int8inferenceengine_tpu.ops import functional as JF
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch.carry import export_state, load_jax_state
from int8inferenceengine_tpu_torch.layers import fused_attention
from int8inferenceengine_tpu_torch.models import zoo as tzoo
from int8inferenceengine_tpu_torch.ops import attention as attn_ops
from int8inferenceengine_tpu_torch.ops import functional as F
from test_torch_cnn_zoo import install_jax_state, jax_forward
from test_torch_text_decoder import jax_state
from test_torch_threads import one_torch_thread  # noqa: F401

KW = dict(img_size=32, patch=8, dim=64, depth=2, heads=2, mlp_ratio=2)


def _rand(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's ViT lifecycle, run once."""
    twin = jvit.torch_vit(**KW)
    sd = twin.state_dict()
    x_fp, x_test = _rand((2, 3, 32, 32), 0), _rand((2, 3, 32, 32), 2)
    with torch.no_grad():
        twin_out = twin(torch.from_numpy(x_fp)).numpy()
    m = jzoo.build("vit_tiny", **KW)
    m.load(sd)
    fp32 = m(qj.tensor(x_fp)).numpy()
    m.prepare()
    m(qj.tensor(_rand((8, 3, 32, 32), 1)))
    m.convert()
    return dict(sd=sd, x_fp=x_fp, twin=twin_out, fp32=fp32, x_test=x_test,
                int8=jax_forward(m, x_test), state=jax_state(m))


def _run(m, x):
    return m(qt.tensor(x, device="cpu")).numpy()


def _carried(ref, **cfg):
    m = tzoo.build("vit_tiny", config=qt.QuantConfig(**cfg), device="cpu",
                   **KW)
    load_jax_state(m, ref["state"])
    return m


@pytest.mark.parametrize("against", ["fp32", "twin"])
def test_fp32_matches_jax_and_twin(ref, against):
    m = tzoo.build("vit_tiny", device="cpu", **KW)
    m.load(ref["sd"])
    want = ref[against]
    np.testing.assert_allclose(_run(m, ref["x_fp"]), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_carried_int8_codes_match_jax(ref):
    m = _carried(ref)
    assert m.is_quant
    got = _run(m, ref["x_test"])
    steps = np.abs(got - ref["int8"]) / m.head.scale
    assert steps.max() <= 2 + 1e-3, steps.max()
    assert (steps < 0.5).mean() >= 0.99, (steps < 0.5).mean()


def test_fused_attention_equals_composed(ref):
    """'auto' and 'xla' run the chain through ``ops/attention.attention``
    (one call a block); 'off' runs the three layers: the same codes."""
    outs = {}
    for mode in ("auto", "xla", "off"):
        before = attn_ops.attention.calls
        outs[mode] = _run(_carried(ref, fused_attention=mode), ref["x_test"])
        calls = attn_ops.attention.calls - before
        assert calls == (0 if mode == "off" else KW["depth"]), (mode, calls)
    np.testing.assert_array_equal(outs["auto"], outs["off"])
    np.testing.assert_array_equal(outs["xla"], outs["off"])


def test_pallas_attention_raises(ref):
    m = _carried(ref, fused_attention="pallas")
    with pytest.raises(ValueError, match="Pallas kernel was removed"):
        _run(m, ref["x_test"])
    u8 = torch.zeros((1, 1, 4, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="Pallas kernel was removed"):
        attn_ops.attention(u8, u8, u8, backend="pallas")


def test_fused_attention_guards(ref):
    m = tzoo.build("vit_tiny", device="cpu", **KW)
    h = qt.Tensor(torch.zeros((1, 2, 4, 32), dtype=torch.uint8), 0.1, 3)
    with pytest.raises(RuntimeError, match="converted"):
        fused_attention(m.attn1, m.smax1, m.av1, h, h, h)
    c = _carried(ref)
    with pytest.raises(ValueError, match="transpose_b"):
        fused_attention(c.av1, c.smax1, c.av1, h, h, h)
    c.smax1.causal = True
    with pytest.raises(ValueError, match="non-causal"):
        fused_attention(c.attn1, c.smax1, c.av1, h, h, h)


def test_carry_round_trip(ref):
    m = _carried(ref)
    back = export_state(m)
    assert set(back) == set(ref["state"])
    for name, st in ref["state"].items():
        got = back[name]
        assert (got["scale"], got["zero_point"]) == (
            st["scale"], st["zero_point"]), name
        assert sorted(got["params"]) == sorted(st["params"]), name
        for key, arr in st["params"].items():
            np.testing.assert_array_equal(got["params"][key], arr)
    jm = jzoo.build("vit_tiny", **KW)
    install_jax_state(jm, back)
    np.testing.assert_array_equal(jax_forward(jm, ref["x_test"]),
                                  ref["int8"])


def test_artifact_equals_jax(ref, tmp_path):
    """The JAX package's artifact of its converted ViT (the encoders'
    ``pe`` with its class token) equals the port's of the carried state;
    the port loads it with the carried model's logits."""
    from int8inferenceengine_tpu_torch import utils
    from test_torch_checkpoint import assert_same_artifact, install_state
    m = _carried(ref)
    jp, _ = assert_same_artifact(
        install_state(jzoo.build("vit_tiny", **KW), ref["state"]), m,
        tmp_path)
    got = utils.load(tzoo.build("vit_tiny", device="cpu", **KW), jp)
    np.testing.assert_array_equal(_run(got, ref["x_test"]),
                                  _run(m, ref["x_test"]))


def test_token_ops_match_jax():
    """``to_tokens`` on a logical NCHW tensor and on a converted conv's
    NHWC codes, and ``select_token``, equal the JAX package's."""
    x = _rand((2, 6, 4, 4), 3)
    q = F.quantize(qt.tensor(x, device="cpu"), 0.05, 128)
    jq = JF.quantize(qj.tensor(x), 0.05, 128)
    toks = F.to_tokens(q)
    np.testing.assert_array_equal(toks.numpy(),
                                  np.asarray(JF.to_tokens(jq).data))
    nhwc = qt.Tensor(q.data.permute(0, 2, 3, 1).contiguous(), q.scale,
                     q.zero_point, _nhwc=True)
    np.testing.assert_array_equal(F.to_tokens(nhwc).numpy(), toks.numpy())
    t0 = F.select_token(toks, 0)
    assert t0.shape == (2, 6) and (t0.scale, t0.zero_point) == (0.05, 128)
    np.testing.assert_array_equal(
        t0.numpy(), np.asarray(JF.select_token(JF.to_tokens(jq), 0).data))


def test_vit_registry_and_guards():
    m = tzoo.build("vit_tiny", img_size=32, patch=16, dim=32, depth=1,
                   heads=2, device="cpu")
    assert m.INPUT_SHAPE == (3, 32, 32)
    want = [n for n, _ in jzoo.build("vit_tiny", img_size=32, patch=16,
                                     dim=32, depth=1, heads=2).named_layers()]
    assert [n for n, _ in m.named_layers()] == want
    with pytest.raises(ValueError, match="divisible"):
        tzoo.build("vit_tiny", img_size=30, patch=16, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        tzoo.build("vit_tiny", dim=30, heads=4, device="cpu")
