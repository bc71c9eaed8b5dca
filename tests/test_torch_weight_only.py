"""PyTorch port vs JAX package: the 8-bit weight-only modes, mirroring
``tests/test_weight_only.py`` case for case.

``QuantConfig(weight_only=True)`` (W8-float: s8 weights dequantized at each
call, float activations) and ``weight_only=True, dynamic_act=True`` (each
row, or each image of a conv, quantized to s8 at its own scale, an exact
s32 product, ``acc * (s_a * s_w) + bias``):

* lenet and simple_conv track their FP32 twins in both modes without a
  calibration pass (rtol 5% / 10% of the largest logit, argmax agreement
  95% / 90%; the JAX test's bounds), closer than full INT8 in W8-float;
  the converted params are int8 with a float32 bias;
* gpt_tiny's weight-only forward tracks its twin (argmax agreement 95%),
  its cached ``generate()`` equals a full recompute token for token and
  its engine equals ``generate()``; dynamic rows are isolated per token;
* against eager JAX on the same numpy arrays (weights carried by
  ``carry.py``): ``Linear`` and ``Conv2d`` (grouped and depthwise included)
  in the dynamic mode give the same s8 codes and s32 accumulators exactly
  and outputs within 1 ulp; in W8-float, whose float32 product sums in
  another order, within 1e-6 of the largest |output|;
* the JAX package's raises: ``dynamic_act`` with ``weight_bits=4`` raises
  ``ValueError`` at ``convert()`` in both packages, and ``dynamic_act``
  without ``weight_only`` runs the static INT8 path (codes equal to the
  same model without it); ``convert()`` without ``prepare()`` warns
  nothing under ``weight_only``;
* every converted ``Quant*`` glue layer passes float input through as its
  FP32 forward does, and ``QuantEmbed`` keeps its float table.

The ``cuda``-marked tests hold DA (``ops/weight_only.s8_matmul``) and DAC
(``ops/conv.conv2d_s8``) on the card bit for bit against their plain
versions, and B5 at the decode shapes (M = 8 and 40) within its 2e-5
contract.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import int8inferenceengine_tpu as qj
from int8inferenceengine_tpu.models import zoo as jzoo
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch.carry import (_load_layer, export_state,
                                                 load_jax_state)
from int8inferenceengine_tpu_torch.models import zoo as tzoo
from int8inferenceengine_tpu_torch.ops import conv as tconv
from int8inferenceengine_tpu_torch.ops import weight_only as two
from int8inferenceengine_tpu_torch.ops.quant import quantize_dynamic
from int8inferenceengine_tpu_torch.serve import GenerationEngine
from test_torch_text_decoder import jax_state
from test_torch_threads import one_torch_thread  # noqa: F401

W8F = dict(weight_only=True)
DYN = dict(weight_only=True, dynamic_act=True)
# per-channel 'nearest' is the JAX test's classifier configuration
CNN_KW = dict(weight_per_channel=True, rounding="nearest")


def _cpu(x):
    return qt.tensor(x, device="cpu")


def _convert_cnn(name, mode):
    m = tzoo.build(name, config=qt.QuantConfig(**mode, **CNN_KW),
                   device="cpu")
    m.load(tzoo.torch_twin(name).state_dict())
    m.convert()                                   # no prepare: W8 only
    return m


@pytest.mark.parametrize("mode,rtol,agree", [(W8F, 0.05, 0.95),
                                             (DYN, 0.1, 0.9)],
                         ids=["w8f", "dynamic"])
@pytest.mark.parametrize("name,shape", [("lenet", (16, 1, 28, 28)),
                                        ("simple_conv", (8, 3, 32, 32))])
def test_weight_only_tracks_fp32(name, shape, mode, rtol, agree):
    tw = tzoo.torch_twin(name)
    x = np.random.default_rng(0).uniform(-1, 1, shape).astype(np.float32)
    want = tw(torch.tensor(x)).detach().numpy()
    got = _convert_cnn(name, mode)(_cpu(x)).numpy()
    assert np.isfinite(got).all()
    rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
    assert rel < rtol, rel
    assert (got.argmax(1) == want.argmax(1)).mean() >= agree
    if mode is DYN:
        return
    # full INT8 for comparison: weight-only must be closer to FP32
    m8 = tzoo.build(name, device="cpu")
    m8.load(tw.state_dict())
    m8.prepare()
    m8(_cpu(x))
    m8.convert()
    full = m8(_cpu(x)).numpy()
    assert np.mean((got - want) ** 2) < np.mean((full - want) ** 2) + 1e-12


def test_weight_only_params_are_int8():
    m = _convert_cnn("lenet", W8F)
    layers = dict(m.named_layers())
    assert layers["conv1"].q_weight.dtype == torch.int8
    assert layers["fc1"].q_weight.dtype == torch.int8
    assert layers["fc1"].bias.dtype == torch.float32
    assert layers["fc1"].weight is None and layers["conv1"].weight is None
    state = export_state(m)
    assert state["conv1"]["params"]["q_w_hwio"].dtype == np.int8
    assert set(state["fc1"]["params"]) == {"q_weight", "bias", "w_scale"}


def _gpt(mode):
    m = tzoo.build("gpt_tiny", config=qt.QuantConfig(**mode), device="cpu")
    m.load(tzoo.torch_twin("gpt_tiny").state_dict())
    m.convert()
    return m


@pytest.mark.parametrize("mode", [W8F, DYN], ids=["w8f", "dynamic"])
def test_weight_only_decoder_generate(mode):
    m = _gpt(mode)
    ids = np.random.default_rng(1).integers(0, 1000, (4, 16)).astype(
        np.int32)
    out = m(_cpu(ids)).numpy()
    assert np.isfinite(out).all() and out.shape == (4, 16, 1000)
    want = tzoo.torch_twin("gpt_tiny")(
        torch.tensor(ids, dtype=torch.long)).detach().numpy()
    assert (out[:, -1].argmax(-1) == want[:, -1].argmax(-1)).mean() >= 0.95


@pytest.mark.parametrize("mode", [W8F, DYN], ids=["w8f", "dynamic"])
def test_weight_only_cached_decode_bit_identical(mode):
    """The float KV cache's greedy tokens equal a full recompute's at
    every step, and the engine's equal ``generate()``'s."""
    m = _gpt(mode)
    prompt = np.random.default_rng(4).integers(0, 1000, (2, 9)).astype(
        np.int32)
    got = m.generate(prompt, 7)
    seq = prompt.copy()
    for s in range(7):
        nxt = m(_cpu(seq)).numpy()[:, -1].argmax(-1).astype(np.int32)
        np.testing.assert_array_equal(got[:, s], nxt, f"step {s}")
        seq = np.concatenate([seq, nxt[:, None]], axis=1)
    eng = GenerationEngine(m, slots=2, chunk_steps=3)
    try:
        np.testing.assert_array_equal(
            eng.submit(prompt[0], 7).result(timeout=120), got[0])
    finally:
        eng.shutdown()


def test_dynamic_act_per_token_isolation():
    """One hot row leaves every other row's output bit for bit."""
    rng = np.random.default_rng(7)
    w = rng.normal(0, 0.1, (32, 64)).astype(np.float32)
    lin = qt.Linear(64, 32, config=qt.QuantConfig(**DYN), device="cpu")
    lin.load_weight(w)
    lin.load_bias(np.zeros(32, np.float32))
    lin.convert()
    x = rng.normal(0, 1, (16, 64)).astype(np.float32)
    cold = lin(_cpu(x)).numpy()
    x_hot = x.copy()
    x_hot[0] *= 1000.0
    hot = lin(_cpu(x_hot)).numpy()
    np.testing.assert_array_equal(cold[1:], hot[1:])
    assert np.abs(cold - x @ w.T).max() < 0.15


# -- the layers against eager JAX ---------------------------------------------

def _pair(make_j, make_t, w, b, config):
    """The same float weights converted by both packages, the JAX layer's
    state carried into the port's."""
    jl = make_j(qj.QuantConfig(**config))
    jl.load_weight(w)
    jl.load_bias(b)
    jl.convert()
    tl = make_t(qt.QuantConfig(**config))
    st = {"params": {k: np.asarray(v) for k, v in jl.params.items()},
          "scale": jl.scale, "zero_point": jl.zero_point,
          "weight_scale": (jl.weight_scale if isinstance(jl.weight_scale,
                                                         float)
                           else np.asarray(jl.weight_scale)),
          "is_quantized": True}
    _load_layer("layer", tl, st)
    return jl, tl


def _jax_dynamic_codes(x, axes):
    """The JAX layers' per-row (per-image) codes, as they compute them."""
    xj = jnp.asarray(x)
    s_a = jnp.maximum(jnp.max(jnp.abs(xj), axis=axes, keepdims=True),
                      1e-8) / 127.0
    return (np.asarray(jnp.clip(jnp.round(xj / s_a), -127, 127).astype(
        jnp.int8)), np.asarray(s_a))


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("mode", [W8F, DYN], ids=["w8f", "dynamic"])
def test_linear_matches_eager_jax(mode, per_channel):
    rng = np.random.default_rng(11)
    k, n = 72, 40
    w = rng.normal(0, 0.1, (n, k)).astype(np.float32)
    b = rng.normal(0, 0.1, (n,)).astype(np.float32)
    # rows of very different magnitudes, a row of zeros (the 1e-8 floor)
    x = (rng.normal(0, 1, (9, k)) * np.float32(10.0) ** rng.integers(
        -3, 3, (9, 1))).astype(np.float32)
    x[4] = 0.0
    cfg = dict(mode, weight_per_channel=per_channel, rounding="nearest")
    jl, tl = _pair(lambda c: qj.Linear(k, n, config=c),
                   lambda c: qt.Linear(k, n, config=c, device="cpu"),
                   w, b, cfg)
    np.testing.assert_array_equal(tl.q_weight.numpy(),
                                  np.asarray(jl.params["q_weight"]))
    want = jl(qj.tensor(x)).numpy()
    got = tl(_cpu(x)).numpy()
    if mode is W8F:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
        return
    codes, s_a = _jax_dynamic_codes(x, 1)
    a, s_t = quantize_dynamic(torch.tensor(x), (1,))
    np.testing.assert_array_equal(a.numpy(), codes)
    np.testing.assert_array_equal(s_t.numpy(), s_a)
    acc = np.asarray(lax.dot_general(
        jnp.asarray(codes), jl.params["q_weight"].T, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))
    np.testing.assert_array_equal(two.s8_matmul(a, tl.q_weight).numpy(),
                                  acc)
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


@pytest.mark.parametrize("c,o,groups,k,stride,pad", [
    (6, 8, 1, 3, 2, 1), (8, 12, 2, 3, 1, 1), (8, 8, 8, 3, 1, 1),
    (16, 32, 16, 5, 2, 2)], ids=["dense", "grouped", "depthwise",
                                 "depthwise_x2"])
@pytest.mark.parametrize("mode", [W8F, DYN], ids=["w8f", "dynamic"])
def test_conv2d_matches_eager_jax(mode, c, o, groups, k, stride, pad):
    rng = np.random.default_rng(12)
    w = rng.normal(0, 0.2, (o, c // groups, k, k)).astype(np.float32)
    b = rng.normal(0, 0.1, (o,)).astype(np.float32)
    x = (rng.normal(0, 1, (3, c, 9, 11))
         * np.float32([1e-2, 1.0, 30.0])[:, None, None, None]).astype(
             np.float32)
    cfg = dict(mode, weight_per_channel=True, rounding="nearest")
    jl, tl = _pair(
        lambda cf: qj.Conv2d(c, o, k, stride, pad, groups, config=cf),
        lambda cf: qt.Conv2d(c, o, k, stride, pad, groups, config=cf,
                             device="cpu"), w, b, cfg)
    np.testing.assert_array_equal(
        tl.q_weight.numpy(),
        np.transpose(np.asarray(jl.params["q_w_hwio"]), (3, 2, 0, 1)))
    want = jl(qj.tensor(x)).numpy()
    got = tl(_cpu(x)).numpy()
    assert got.shape == want.shape
    if mode is W8F:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
        return
    x_nhwc = np.transpose(x, (0, 2, 3, 1))
    codes, _ = _jax_dynamic_codes(x_nhwc, (1, 2, 3))
    a, _ = quantize_dynamic(torch.tensor(x), (1, 2, 3))
    np.testing.assert_array_equal(a.numpy(), np.transpose(codes, (0, 3, 1, 2)))
    acc = np.asarray(lax.conv_general_dilated(
        jnp.asarray(codes), jl.params["q_w_hwio"],
        window_strides=(stride, stride), padding=[(pad, pad)] * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups, preferred_element_type=jnp.int32))
    for fn in (tconv.conv2d_s8, tconv.conv2d_s8_plain):
        np.testing.assert_array_equal(
            fn(a, tl.q_weight, stride, pad, groups).numpy(),
            np.transpose(acc, (0, 3, 1, 2)))
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_s8_matmul_plain_and_padding_shapes():
    """DA's CPU route is exact at the gate's row counts and odd K and N,
    and ``int_mm_shape`` pads to what ``torch._int_mm`` takes."""
    rng = np.random.default_rng(13)
    for m, k, n in ((1, 7, 5), (8, 33, 17), (17, 64, 24), (100, 2304, 9)):
        a = rng.integers(-127, 128, (m, k)).astype(np.int8)
        w = rng.integers(-127, 128, (n, k)).astype(np.int8)
        got = two.s8_matmul(torch.tensor(a), torch.tensor(w)).numpy()
        np.testing.assert_array_equal(
            got, a.astype(np.int64) @ w.astype(np.int64).T)
        mp, kp, np_ = two.int_mm_shape(m, k, n)
        assert mp > 16 and mp >= m and kp % 8 == 0 and np_ % 8 == 0
    with pytest.raises(TypeError):
        two.s8_matmul(torch.zeros(2, 3), torch.zeros(4, 3, dtype=torch.int8))


def test_carry_round_trip_weight_only():
    """A converted JAX W8-float / dynamic gpt_tiny carried into the port
    gives the JAX forward's argmax, and carries back unchanged."""
    ids = np.random.default_rng(3).integers(0, 1000, (2, 12)).astype(
        np.int32)
    for mode in (W8F, DYN):
        jm = jzoo.build("gpt_tiny", config=qj.QuantConfig(**mode))
        jm.load(jzoo.torch_twin("gpt_tiny").state_dict())
        jm.convert()
        state = jax_state(jm)
        m = tzoo.build("gpt_tiny", config=qt.QuantConfig(**mode),
                       device="cpu")
        load_jax_state(m, state)
        want = jm(qj.tensor(ids)).numpy()
        got = m(_cpu(ids)).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        back = export_state(m)
        for name, st in state.items():
            assert set(back[name]["params"]) == set(st["params"]), name
            for key, v in st["params"].items():
                np.testing.assert_array_equal(back[name]["params"][key], v)


def test_dynamic_act_raises_and_static_fallthrough():
    """The JAX package's rules: 4-bit dynamic raises at convert; dynamic
    without weight_only runs the static INT8 path."""
    for pkg, cfg, lin in ((qj, qj.QuantConfig, lambda c: qj.Linear(
            8, 4, config=c)), (qt, qt.QuantConfig, lambda c: qt.Linear(
                8, 4, config=c, device="cpu"))):
        for wo in (True, False):
            layer = lin(cfg(weight_only=wo, weight_bits=4, dynamic_act=True))
            with pytest.raises(ValueError, match="dynamic_act"):
                layer.convert()
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (8, 1, 28, 28)).astype(np.float32)
    outs = []
    for dyn in (False, True):
        m = tzoo.build("lenet", config=qt.QuantConfig(dynamic_act=dyn),
                       device="cpu")
        m.load(tzoo.torch_twin("lenet").state_dict())
        m.prepare()
        m(_cpu(x))
        m.convert()
        assert m.fc1.q_weight is None and m.fc1.qw is not None
        outs.append(m(_cpu(x)).numpy())
    np.testing.assert_array_equal(outs[0], outs[1])


def test_convert_without_prepare_warns_nothing():
    m = tzoo.build("gpt_tiny", config=qt.QuantConfig(**DYN), device="cpu")
    m.load(tzoo.torch_twin("gpt_tiny").state_dict())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        m.convert()
    assert m.is_quant
    with pytest.raises(RuntimeError, match="float input"):
        m.head(qt.Tensor(torch.zeros((1, 128), dtype=torch.uint8)))


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 17, 100])
@pytest.mark.parametrize("k,n", [(2304, 2048), (33, 17), (9216, 2304)])
def test_s8_matmul_exact_on_card(cuda_device, m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = torch.tensor(rng.integers(-127, 128, (m, k)).astype(np.int8))
    w = torch.tensor(rng.integers(-127, 128, (n, k)).astype(np.int8))
    got = two.s8_matmul(a.to(cuda_device), w.to(cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), two.s8_matmul_plain(a, w))


@pytest.mark.cuda
@pytest.mark.parametrize("c,o,groups,k,stride,pad", [
    (64, 128, 1, 3, 1, 1), (96, 96, 96, 3, 2, 1), (58, 58, 58, 5, 1, 2),
    (512, 512, 1, 3, 1, 1), (48, 96, 2, 1, 1, 0)])
def test_conv2d_s8_exact_on_card(cuda_device, c, o, groups, k, stride, pad):
    rng = np.random.default_rng(c + o + k)
    x = torch.tensor(rng.integers(-127, 128, (2, c, 14, 14)).astype(np.int8))
    w = torch.tensor(rng.integers(-127, 128, (o, c // groups, k, k)).astype(
        np.int8))
    got = tconv.conv2d_s8(x.to(cuda_device), w.to(cuda_device), stride, pad,
                          groups)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(),
                       tconv.conv2d_s8_plain(x, w, stride, pad, groups))


@pytest.mark.parametrize("mode", [W8F, DYN], ids=["w8f", "dynamic"])
def test_glue_layers_pass_float_through(mode):
    """Every converted ``Quant*`` glue layer of a weight-only model (no
    calibration) computes its FP32 function on float input."""
    cfg = qt.QuantConfig(**mode)
    rng = np.random.default_rng(14)

    def f(*shape):
        return qt.Tensor(torch.tensor(rng.normal(0, 1, shape).astype(
            np.float32)))

    x, y = f(2, 4, 8, 16), f(2, 4, 8, 16)
    cases = [
        (lambda c: qt.QuantAct("gelu", config=c, device="cpu"), (x,), {}),
        (lambda c: qt.QuantAdd(config=c, device="cpu"), (x, y), {}),
        (lambda c: qt.QuantMul(config=c, device="cpu"), (x, y), {}),
        (lambda c: qt.QuantConcat(config=c, device="cpu"), (x, y), {}),
        (lambda c: qt.QuantMatmul(alpha=0.5, transpose_b=True, config=c,
                                  device="cpu"), (x, y), {}),
        (lambda c: qt.QuantSoftmax(causal=True, window=3, softcap=5.0,
                                   config=c, device="cpu"),
         (f(2, 4, 8, 8),), {}),
        (lambda c: qt.QuantLayerNorm(16, config=c, device="cpu"), (x,), {}),
        (lambda c: qt.QuantRMSNorm(16, unit_offset=True, config=c,
                                   device="cpu"), (x,), {}),
        (lambda c: qt.QuantRoPE(16, config=c, device="cpu"), (x,),
         dict(start=5)),
        (lambda c: qt.QuantPosEmbed(8, 16, cls=False, config=c,
                                    device="cpu"), (f(2, 8, 16),), {}),
    ]
    for make, args, kw in cases:
        fp, conv = make(qt.DEFAULT_CONFIG), make(cfg)
        conv.convert()
        assert conv.is_quantized
        want = fp(*args, **kw).data
        got = conv(*args, **kw)
        assert not got.quantized
        np.testing.assert_array_equal(got.data.numpy(), want.numpy())
    emb = qt.QuantEmbed(11, 16, config=cfg, device="cpu")
    emb.load_weight(rng.normal(0, 1, (11, 16)).astype(np.float32))
    emb.convert()
    ids = qt.Tensor(torch.tensor([[3, 7, 10]]))
    np.testing.assert_array_equal(emb(ids).data.numpy(),
                                  emb.weight[[3, 7, 10]][None].numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 40])
@pytest.mark.parametrize("k,n", [(2304, 2048), (9216, 2304), (768, 32000)])
def test_b5_decode_shapes_on_card(cuda_device, m, k, n):
    """B5 inside a W4 decode step (M = 8) and a speculative verify (M =
    40) within its contract: 2e-5 of the largest |output| of its plain
    version."""
    from int8inferenceengine_tpu_torch.ops import w4 as tw4
    rng = np.random.default_rng(m + k + n)
    w = torch.tensor(rng.normal(0, 0.02, (n, k)).astype(np.float32))
    packed, scales = tw4.pack_w4(w, 128, optimize=True)
    x = torch.tensor(rng.normal(0, 1, (m, k)).astype(np.float32))
    bias = torch.tensor(rng.normal(0, 0.01, (n,)).astype(np.float32))
    args = [t.to(cuda_device) for t in (x, packed, scales, bias)]
    got = tw4.w4_gemm(*args, k, 128)
    torch.cuda.synchronize()
    want = tw4.w4_gemm_plain(x, packed, scales, bias, k, 128)
    assert float((got.cpu() - want).abs().max()) <= 2e-5 * float(
        want.abs().max())
