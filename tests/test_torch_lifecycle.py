"""PyTorch port vs JAX package: the lifecycle levers, mirroring
``tests/test_bias_correction.py``, ``tests/test_mixed_precision.py`` and
``tests/test_quant_act.py``.

* **Bias correction** (``QuantConfig(bias_correction=True)``): on a Linear
  and a Conv2d with an outlier row, and on LeNet, the corrected s8 bias of
  every layer equals the JAX package's on the same weights and
  calibration inputs, and the per-channel mean error shrinks as the JAX
  test asks; under W4A8 the corrected float32 bias is JAX's within float32
  rounding; a depthwise conv observes nothing and converts.
* **FP32 islands** (``Module.convert(skip=...)``): LeNet with conv1 and
  fc2 kept float gives the JAX package's logits (its converted state
  carried over; the float products differ by ULPs between the
  frameworks, so within 2 output codes, equal on 99%) and a smaller error
  than full INT8; the islands keep their float weights, also under
  ``weight_only``; an unknown name raises ``KeyError`` and a QuantSoftmax
  ``TypeError``, the JAX package's errors.
* **QuantAct's LUT** (``backend='lut'``): bit for bit the elementwise
  codes for every activation and every input code, and within one code of
  the JAX package's LUT (the port takes exp and erfc in float64, rounded
  once, where JAX takes them in float32).
"""

import numpy as np
import pytest
import torch

import int8inferenceengine_tpu as qj
from int8inferenceengine_tpu import QuantConfig as JConfig
from int8inferenceengine_tpu.layers import Conv2d as JConv2d
from int8inferenceengine_tpu.layers import Linear as JLinear
from int8inferenceengine_tpu.layers import QuantAct as JQuantAct
from int8inferenceengine_tpu.models import zoo as jzoo
from int8inferenceengine_tpu.tensor import Tensor as JTensor
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch.carry import export_state, load_jax_state
from int8inferenceengine_tpu_torch.layers import QuantAct, fp32_island
from int8inferenceengine_tpu_torch.models import zoo as tzoo
from int8inferenceengine_tpu_torch.ops import functional as F
from int8inferenceengine_tpu_torch.ops.functional import ACTIVATIONS
from test_torch_text_decoder import jax_state
from test_torch_threads import one_torch_thread  # noqa: F401


def _cpu(x):
    return qt.tensor(x, device="cpu")


def _outlier_linear():
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.05, (16, 64)).astype(np.float32)
    w[0] += 2.0
    b = rng.normal(0, 0.1, 16).astype(np.float32)
    # non-zero-mean inputs on the 1/32 grid (exact u8 codes at scale 1/32)
    x = (np.random.default_rng(1).integers(0, 32, (256, 64)) / 32.0
         ).astype(np.float32)
    return (lambda c: qt.Linear(64, 16, config=c, device="cpu"),
            lambda c: JLinear(64, 16, config=c), w, b, x)


def _outlier_conv():
    rng = np.random.default_rng(2)
    w = rng.normal(0, 0.05, (8, 4, 3, 3)).astype(np.float32)
    w[0] += 1.5
    b = rng.normal(0, 0.1, 8).astype(np.float32)
    x = (np.random.default_rng(3).integers(0, 32, (16, 4, 8, 8)) / 32.0
         ).astype(np.float32)
    return (lambda c: qt.Conv2d(4, 8, 3, padding=1, config=c, device="cpu"),
            lambda c: JConv2d(4, 8, 3, padding=1, config=c), w, b, x)


def _calibrated(layer, w, b, x, tensor):
    layer.load_weight(w)
    layer.load_bias(b)
    layer.prepare()
    ref = layer(tensor(x)).numpy()
    layer.convert()
    return layer, ref


@pytest.mark.parametrize("case,ratio", [(_outlier_linear, 0.5),
                                        (_outlier_conv, 0.7)])
def test_bias_correction_matches_jax_and_reduces_error(case, ratio):
    make, make_jax, w, b, x = case()
    errs = {}
    for corrected in (False, True):
        layer, want = _calibrated(make(qt.QuantConfig(
            bias_correction=corrected)), w, b, x, _cpu)
        jl, _ = _calibrated(make_jax(JConfig(bias_correction=corrected)),
                            w, b, x, qj.tensor)
        np.testing.assert_array_equal(layer.q_bias.numpy(),
                                      np.asarray(jl.params["q_bias"]))
        got = F.dequantize(layer(F.quantize(_cpu(x), 1 / 32.0, 0))).numpy()
        diff = got - want
        shift = diff.mean(axis=tuple(i for i in range(diff.ndim) if i != 1))
        # the common-mode output-truncation bias is the rounding lever's
        errs[corrected] = np.abs(shift - np.median(shift)).mean()
    assert errs[True] < errs[False] * ratio, errs


def test_w4a8_bias_correction_matches_jax():
    """Under W4A8 the correction ``(W - dequant_w4(W)) @ E[x]`` stays a
    float32 bias, as in the JAX package: equal packed codes, the bias
    within float32 rounding of JAX's (the port reduces in float64)."""
    make, make_jax, w, b, x = _outlier_linear()
    cfg = dict(bias_correction=True, weight_bits=4, w4_group=32)
    layer, _ = _calibrated(make(qt.QuantConfig(**cfg)), w, b, x, _cpu)
    jl, _ = _calibrated(make_jax(JConfig(**cfg)), w, b, x, qj.tensor)
    np.testing.assert_array_equal(layer.w4_packed.numpy(),
                                  np.asarray(jl.params["w4_packed"]))
    want = np.asarray(jl.params["bias"])
    assert not np.allclose(want, b, atol=1e-3)     # the correction moved it
    np.testing.assert_allclose(layer.bias.numpy(), want, rtol=1e-5,
                               atol=1e-6)


def _lenet(config=qt.DEFAULT_CONFIG, jconfig=None):
    sd = tzoo.torch_twin("lenet").state_dict()
    m = tzoo.build("lenet", config=config, device="cpu")
    m.load(sd)
    jm = None
    if jconfig is not None:
        jm = jzoo.build("lenet", config=jconfig)
        jm.load(sd)
    return m, jm


def _lenet_x(batch=8, seed=4):
    return np.random.default_rng(seed).uniform(
        -1, 1, (batch, 1, 28, 28)).astype(np.float32)


def test_lenet_bias_correction_matches_jax():
    """Every corrected s8 bias of a LeNet calibrated on one batch equals
    the JAX package's; the input means cover the whole batch."""
    m, jm = _lenet(qt.QuantConfig(bias_correction=True),
                   JConfig(bias_correction=True))
    x = _lenet_x()
    for model, tensor in ((m, _cpu), (jm, qj.tensor)):
        model.prepare()
        model(tensor(x))
    assert m.fc1._in_count == 8 and m.conv1._in_mean is not None
    m.convert()
    jm.convert()
    jlayers = dict(jm.named_layers())
    for name, layer in m.named_layers():
        np.testing.assert_array_equal(
            layer.q_bias.numpy(), np.asarray(jlayers[name].params["q_bias"]),
            err_msg=name)
    ref = tzoo.torch_twin("lenet")(torch.from_numpy(x)).detach().numpy()
    out = m(_cpu(x)).numpy()
    assert (out.argmax(1) == ref.argmax(1)).mean() >= 0.8


def test_depthwise_conv_skipped():
    """A grouped conv observes no input means and converts as usual."""
    conv = qt.Conv2d(8, 8, 3, groups=8, padding=1, device="cpu",
                     config=qt.QuantConfig(bias_correction=True))
    rng = np.random.default_rng(0)
    conv.load_weight(rng.normal(0, 0.3, (8, 1, 3, 3)).astype(np.float32))
    conv.load_bias(rng.normal(0, 0.1, 8).astype(np.float32))
    conv.prepare()
    conv(_cpu(rng.uniform(-1, 1, (2, 8, 6, 6)).astype(np.float32)))
    assert conv._in_mean is None
    conv.convert()
    assert conv.is_quantized and conv.qw is not None


def test_skip_islands_match_jax_and_improve():
    x = _lenet_x(64, seed=0)
    want = tzoo.torch_twin("lenet")(torch.from_numpy(x)).detach().numpy()
    outs = {}
    for skip in ((), ("conv1", "fc2")):
        m, jm = _lenet(jconfig=JConfig())
        jm.prepare()
        jm(qj.tensor(x))
        jm.convert(skip=skip)
        jout = jm(qj.tensor(x)).numpy()
        load_jax_state(m, jax_state(jm))
        before = fp32_island.calls
        outs[skip] = m(_cpu(x)).numpy()
        assert fp32_island.calls - before == len(skip)
        steps = np.abs(outs[skip] - jout) / m.fc2.scale
        assert steps.max() <= 2 + 1e-3, steps.max()
        assert (steps < 0.5).mean() >= 0.99
    mse = {k: np.mean((v - want) ** 2) for k, v in outs.items()}
    assert mse[("conv1", "fc2")] < mse[()], mse
    # the islands keep float weights and export them as JAX holds them
    st = export_state(m)
    assert sorted(st["conv1"]["params"]) == ["bias", "w_hwio"]
    assert sorted(st["fc2"]["params"]) == ["bias", "weight"]
    assert "qw_hwio" in st["conv2"]["params"]


def test_skip_own_calibration_serves_u8():
    """The port's own lifecycle with islands: u8 in and out, floats kept."""
    m, _ = _lenet()
    x = _lenet_x()
    m.prepare()
    m(_cpu(x))
    m.convert(skip=("conv1", "fc2"))
    assert m.conv1.quant_fallback and m.conv1.qw is None
    assert m.conv1.weight is not None and m.conv2.qw is not None
    out = m.conv1(F.quantize(_cpu(x), 0.025, 127))
    assert out.quantized and (out.scale, out.zero_point) == (
        m.conv1.scale, m.conv1.zero_point)
    assert np.isfinite(m(_cpu(x)).numpy()).all()


def test_skip_with_weight_only():
    m, _ = _lenet(qt.QuantConfig(weight_only=True))
    m.convert(skip=("fc2",))
    assert m.fc2.weight is not None and m.fc2.q_weight is None
    assert m.fc1.q_weight is not None
    assert np.isfinite(m(_cpu(_lenet_x(2))).numpy()).all()


@pytest.mark.parametrize("skip,error", [(("nope",), KeyError),
                                        (("smax1",), TypeError)])
def test_skip_errors_match_jax(skip, error):
    ids = np.random.default_rng(0).integers(0, 1000, (2, 8)).astype(np.int32)
    sd = tzoo.torch_twin("gpt_tiny").state_dict()
    for build, tensor in ((lambda: tzoo.build("gpt_tiny", device="cpu"),
                           _cpu), (lambda: jzoo.build("gpt_tiny"),
                                   qj.tensor)):
        m = build()
        m.load(sd)
        m.prepare()
        m(tensor(ids))
        with pytest.raises(error):
            m.convert(skip=skip)


def _act_pair(name, x):
    """Calibrated elementwise and LUT QuantActs of the port and the JAX
    package's LUT one, on the same calibration data."""
    acts = [QuantAct(name, device="cpu"),
            QuantAct(name, backend="lut", device="cpu")]
    for a in acts:
        a.prepare()
        a(_cpu(x))
        a.convert()
    ja = JQuantAct(name, backend="lut")
    ja.prepare()
    ja(qj.tensor(x))
    ja.convert()
    return acts, ja


@pytest.mark.parametrize("name", sorted(ACTIVATIONS))
def test_lut_bit_identical_to_elementwise(name):
    x = np.random.default_rng(0).uniform(-4, 4, (2, 300)).astype(np.float32)
    (e, lut), ja = _act_pair(name, x)
    assert (e.scale, e.zero_point) == (lut.scale, lut.zero_point)
    # the JAX layer's calibrated range may differ by an ULP: carry the grid
    assert abs(ja.scale - e.scale) <= 1e-6 * e.scale
    ja.scale, ja.zero_point = e.scale, e.zero_point
    codes = np.arange(256, dtype=np.uint8).reshape(4, 64)[:, ::-1].copy()
    for scale, zp in ((0.03, 128), (0.011, 7)):
        u8 = qt.Tensor(torch.from_numpy(codes), scale, zp)
        got = lut(u8)
        np.testing.assert_array_equal(got.numpy(), e(u8).numpy())
        assert (got.scale, got.zero_point) == (e.scale, e.zero_point)
        want = np.asarray(ja(JTensor(codes, scale, zp)).data)
        d = np.abs(got.numpy().astype(int) - want.astype(int))
        assert d.max() <= 1, (name, scale, d.max())
    assert len(lut._luts) == 2
