"""PyTorch port vs JAX package: the CNN zoo's layers and glue.

On the same numpy inputs from a seed:

* the pools and the channel layout ops on u8 codes: equal codes
  (``avg_pool2d``, ``adaptive_avg_pool2d_1x1``, ``channel_shuffle``,
  ``split_channels``, in either layout), the float pools within 1e-6;
* ``QuantConcat`` and the squeeze-excite ``QuantMul`` broadcast: the same
  calibrated grid (scale to rtol 1e-6, equal zero point) and equal codes;
* grouped ``Conv2d`` (depthwise, a channel multiplier, C = 58, k = 5,
  stride 2, per-channel and per-tensor weight scales, both roundings): FP32
  within 1e-5 of the largest |output|, the same quantized weights, and with
  the JAX layer's converted state carried over equal INT8 codes; the
  converted state carries back out unchanged;
* on a card (``cuda`` marker), kernel G1 against its plain version, bit for
  bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import int8inferenceengine_tpu as qj
from int8inferenceengine_tpu.layers import Conv2d as JConv2d
from int8inferenceengine_tpu.layers import QuantConcat as JQuantConcat
from int8inferenceengine_tpu.layers import QuantMul as JQuantMul
from int8inferenceengine_tpu.ops import functional as JF
from int8inferenceengine_tpu.tensor import Tensor as JTensor
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch.carry import export_state, load_jax_state
from int8inferenceengine_tpu_torch.ops import conv as C
from int8inferenceengine_tpu_torch.ops import functional as TF
from int8inferenceengine_tpu_torch.ops.gemm_int8 import compute_offset
from test_torch_models import jax_state
from test_torch_threads import one_torch_thread  # noqa: F401


def _codes(rng, shape):
    return rng.integers(0, 256, shape).astype(np.uint8)


def _pair(arr, nhwc, scale=0.02, zp=117):
    """The same codes (or floats) as a JAX and a port Tensor; ``nhwc``: the
    array is the physical NHWC layout of a logical NCHW tensor."""
    q = arr.dtype == np.uint8
    s, z = (scale, zp) if q else (1.0, 0)
    return (JTensor(jnp.asarray(arr), s, z, _nhwc=nhwc),
            qt.Tensor(torch.from_numpy(arr.copy()), s, z, _nhwc=nhwc))


def _same(jt, pt):
    assert (jt.scale, jt.zero_point) == (pt.scale, pt.zero_point)
    assert tuple(jt.shape) == tuple(pt.shape)
    np.testing.assert_array_equal(pt.numpy(), jt.numpy())


@pytest.mark.parametrize("nhwc", [True, False])
@pytest.mark.parametrize("k,s,hw", [(2, 2, 8), (3, 1, 7), (2, 2, 9)])
def test_avg_pool2d_codes(nhwc, k, s, hw):
    rng = np.random.default_rng(k * 10 + hw)
    shape = (2, hw, hw, 6) if nhwc else (2, 6, hw, hw)
    arr = _codes(rng, shape)
    # windows of equal codes: sums that divide exactly
    if nhwc:
        arr[:, :4, :4, :] = 200
    else:
        arr[:, :, :4, :4] = 200
    jt, pt = _pair(arr, nhwc)
    _same(JF.avg_pool2d(jt, k, s), TF.avg_pool2d(pt, k, s))


@pytest.mark.parametrize("nhwc", [True, False])
@pytest.mark.parametrize("hw", [1, 2, 7])
def test_adaptive_avg_pool_codes(nhwc, hw):
    rng = np.random.default_rng(hw)
    arr = _codes(rng, (3, hw, hw, 10) if nhwc else (3, 10, hw, hw))
    arr[0] = 255                                   # an exact quotient
    jt, pt = _pair(arr, nhwc)
    _same(JF.adaptive_avg_pool2d_1x1(jt), TF.adaptive_avg_pool2d_1x1(pt))


@pytest.mark.parametrize("pool", ["avg", "adaptive"])
def test_pools_on_floats(pool):
    arr = np.random.default_rng(5).standard_normal((2, 6, 8, 8)).astype(
        np.float32)
    jt, pt = _pair(arr, False)
    if pool == "avg":
        want, got = JF.avg_pool2d(jt, 2, 2), TF.avg_pool2d(pt, 2, 2)
    else:
        want = JF.adaptive_avg_pool2d_1x1(jt)
        got = TF.adaptive_avg_pool2d_1x1(pt)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("nhwc", [True, False])
def test_channel_shuffle_and_split(nhwc):
    arr = _codes(np.random.default_rng(7), (2, 3, 5, 12) if nhwc
                 else (2, 12, 3, 5))
    jt, pt = _pair(arr, nhwc)
    for g in (2, 3, 4):
        _same(JF.channel_shuffle(jt, g), TF.channel_shuffle(pt, g))
    for parts in (2, 3):
        for a, b in zip(JF.split_channels(jt, parts),
                        TF.split_channels(pt, parts)):
            _same(a, b)
    with pytest.raises(ValueError, match="divisible"):
        TF.channel_shuffle(pt, 5)
    with pytest.raises(ValueError, match="divisible"):
        TF.split_channels(pt, 5)


def _floats(rng, shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


@pytest.mark.parametrize("fuse_relu", [False, True])
def test_quant_concat(fuse_relu):
    rng = np.random.default_rng(11)
    fl = [_floats(rng, (2, 5, 4, c), -1.0 * (i + 1), 1.0) for i, c in
          enumerate((3, 4, 5))]
    jl, pl = JQuantConcat(fuse_relu=fuse_relu), qt.QuantConcat(
        fuse_relu=fuse_relu, device="cpu")
    jl.prepare()
    pl.prepare()
    pairs = [_pair(a, True) for a in fl]
    np.testing.assert_array_equal(
        pl(*[p for _, p in pairs]).numpy(), jl(*[j for j, _ in pairs]).numpy())
    jl.convert()
    pl.convert()
    assert pl.zero_point == jl.zero_point
    assert pl.scale == pytest.approx(jl.scale, rel=1e-6)
    pl.scale = jl.scale
    codes = [(_codes(rng, a.shape), 0.01 * (i + 1), 100 + 10 * i)
             for i, a in enumerate(fl)]
    qp = [_pair(c, True, s, z) for c, s, z in codes]
    _same(jl(*[j for j, _ in qp]), pl(*[p for _, p in qp]))
    with pytest.raises(ValueError, match="at least two"):
        pl(qp[0][1])


@pytest.mark.parametrize("nhwc", [True, False])
def test_quant_mul_squeeze_excite_broadcast(nhwc):
    """An SE gate [N, 1, 1, C] (NCHW [N, C, 1, 1]) scales the trunk."""
    rng = np.random.default_rng(13)
    trunk = (2, 5, 6, 8) if nhwc else (2, 8, 5, 6)
    gate = (2, 1, 1, 8) if nhwc else (2, 8, 1, 1)
    jl, pl = JQuantMul(), qt.QuantMul(device="cpu")
    jl.prepare()
    pl.prepare()
    (ja, pa), (jb, pb) = _pair(_floats(rng, trunk, -3, 3), nhwc), _pair(
        _floats(rng, gate, 0, 1), nhwc)
    np.testing.assert_allclose(pl(pa, pb).numpy(), jl(ja, jb).numpy(),
                               rtol=1e-6)
    jl.convert()
    pl.convert()
    assert pl.zero_point == jl.zero_point
    assert pl.scale == pytest.approx(jl.scale, rel=1e-6)
    pl.scale = jl.scale
    (ja, pa) = _pair(_codes(rng, trunk), nhwc, 0.025, 120)
    (jb, pb) = _pair(_codes(rng, gate), nhwc, 0.004, 0)
    got = pl(pa, pb)
    assert tuple(got.shape) == tuple(pa.shape)
    _same(jl(ja, jb), got)


# -- grouped Conv2d ------------------------------------------------------------

# (in, out, groups, kernel, stride): depthwise, a channel multiplier of 2,
# ShuffleNetV2's 58 channels, depthwise k = 5 stride 2, three channels a group
GROUPED = [(8, 8, 8, 3, 1), (8, 16, 8, 3, 1), (58, 58, 58, 3, 1),
           (16, 16, 16, 5, 2), (12, 12, 4, 3, 2)]


class _JOne(qj.Module):
    def __init__(self, conv):
        super().__init__(conv.config)
        self.conv = conv


class _POne(qt.Module):
    def __init__(self, conv):
        super().__init__(conv.config, device="cpu")
        self.conv = conv


def _grouped_pair(case, per_channel, rounding, seed):
    cin, cout, groups, k, stride = case
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.3, (cout, cin // groups, k, k)).astype(np.float32)
    b = rng.normal(0, 0.1, cout).astype(np.float32)
    layers = []
    for conv, cfg in ((JConv2d, qj.QuantConfig), (qt.Conv2d, qt.QuantConfig)):
        extra = {} if conv is JConv2d else {"device": "cpu"}
        layer = conv(cin, cout, k, stride=stride, padding=k // 2,
                     groups=groups, config=cfg(
                         weight_per_channel=per_channel, rounding=rounding),
                     **extra)
        layer.load_weight(w)
        layer.load_bias(b)
        layers.append(layer)
    return layers, rng.uniform(-1, 1, (2, cin, 9, 9)).astype(np.float32)


@pytest.mark.parametrize("case", GROUPED)
def test_grouped_conv_fp32(case):
    (jl, pl), x = _grouped_pair(case, False, "trunc", 0)
    want = jl(qj.tensor(x)).numpy()
    got = pl(qt.tensor(x, device="cpu")).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("rounding", ["trunc", "nearest"])
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("case", GROUPED)
def test_grouped_conv_int8_lifecycle(case, per_channel, rounding):
    (jl, pl), x = _grouped_pair(case, per_channel, rounding,
                                GROUPED.index(case))
    for layer, tensor in ((jl, qj.tensor), (pl, qt.tensor)):
        layer.prepare()
        kw = {} if layer is jl else {"device": "cpu"}
        layer(tensor(x, **kw))
        layer.convert()
    assert pl.zero_point == jl.zero_point
    assert pl.scale == pytest.approx(jl.scale, rel=1e-5)
    # the port's own weight quantization equals the JAX package's
    k, cin, cout = case[3], case[0], case[1]
    want_qw = np.asarray(jl.params["qw_hwio"]).reshape(-1, cout).T
    np.testing.assert_array_equal(pl.qw.numpy(), want_qw)
    np.testing.assert_array_equal(pl.rowsum.numpy(),
                                  np.asarray(jl.params["rowsum"]))
    # with the JAX layer's state carried over, equal codes
    jm, pm = _JOne(jl), _POne(pl)
    load_jax_state(pm, jax_state(jm))
    q = np.random.default_rng(1).integers(0, 256, x.shape).astype(np.uint8)
    jq = JTensor(jnp.asarray(q), 0.013, 121)
    pq = qt.Tensor(torch.from_numpy(q), 0.013, 121)
    _same(jl(jq), pl(pq))
    assert pl.groups == case[2] and pl.weight is None
    back = export_state(pm)["conv"]
    for key, arr in jax_state(jm)["conv"]["params"].items():
        np.testing.assert_array_equal(back["params"][key], arr)
    assert k * k * cin // case[2] == pl.qw.shape[1]


def test_grouped_conv_validation():
    with pytest.raises(ValueError, match="groups"):
        qt.Conv2d(6, 8, 3, groups=4, device="cpu")
    with pytest.raises(ValueError, match="load_weight"):
        qt.Conv2d(8, 8, 3, groups=8, device="cpu").load_weight(
            np.zeros((8, 8, 3, 3), np.float32))
    x = torch.zeros((1, 5, 5, 8), dtype=torch.uint8)
    qw = torch.zeros((8, 9), dtype=torch.int8)
    oc = torch.zeros(8, dtype=torch.int32)
    ep = torch.ones(8)
    kw = dict(kh=3, kw=3, stride=1, padding=1, scale_a=0.1, zp_a=0,
              scale_c=0.1, zp_c=0)
    with pytest.raises(ValueError, match="weight"):
        C.conv2d_int8_grouped(x, qw, oc, ep, groups=4, **kw)
    with pytest.raises(TypeError, match="u8"):
        C.conv2d_int8_grouped(x.float(), qw, oc, ep, groups=8, **kw)


def test_grouped_carry_roundtrip():
    """Unconverted grouped convs and QuantConcat carry both ways."""
    (jl, pl), x = _grouped_pair(GROUPED[1], True, "trunc", 3)
    jm, pm = _JOne(jl), _POne(qt.Conv2d(8, 16, 3, padding=1, groups=8,
                                        device="cpu"))
    load_jax_state(pm, jax_state(jm))
    np.testing.assert_array_equal(pm.conv.weight.numpy(), pl.weight.numpy())
    np.testing.assert_array_equal(
        export_state(pm)["conv"]["params"]["w_hwio"],
        np.asarray(jl.params["w_hwio"]))

    class JCat(qj.Module):
        def __init__(self):
            super().__init__()
            self.cat = JQuantConcat()

    class PCat(qt.Module):
        def __init__(self):
            super().__init__(device="cpu")
            self.cat = qt.QuantConcat(device="cpu")

    jc = JCat()
    jc.cat.scale, jc.cat.zero_point, jc.cat.is_quantized = 0.031, 77, True
    pc = PCat()
    load_jax_state(pc, jax_state(jc))
    assert (pc.cat.scale, pc.cat.zero_point) == (0.031, 77)
    assert pc.cat.is_quantized and pc.is_quant
    back = export_state(pc)["cat"]
    assert (back["scale"], back["zero_point"], back["params"]) == (
        0.031, 77, {})


# -- kernel G1 on the card -----------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: kernel G1 runs only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 14, 14, 96, 96, 96, 3, 2), (2, 9, 9, 58, 58, 58, 3, 1),
    (2, 8, 8, 960, 960, 960, 5, 1), (2, 10, 11, 96, 96, 48, 5, 2),
    (2, 8, 8, 16, 32, 16, 3, 1), (2, 8, 8, 32, 32, 4, 3, 1)])
def test_g1_matches_plain_on_card(card, shape):
    b, h, w, c, o, groups, k, stride = shape
    gen = torch.Generator(device=card).manual_seed(0)
    x = torch.randint(0, 256, (b, h, w, c), generator=gen, dtype=torch.uint8,
                      device=card)
    qw = torch.randint(-127, 128, (o, k * k * c // groups), generator=gen,
                       dtype=torch.int8, device=card)
    q_bias = torch.randint(-127, 128, (o,), generator=gen, dtype=torch.int8,
                           device=card)
    oc = compute_offset(q_bias, qw.to(torch.int32).sum(1, dtype=torch.int32),
                        0.02, 117, recentered=True)
    for ep in (torch.full((o,), 0.01, device=card),
               torch.rand((o,), generator=gen, device=card) * 0.01 + 0.005):
        for rounding in ("trunc", "nearest"):
            for relu in (False, True):
                kw = dict(groups=groups, kh=k, kw=k, stride=stride,
                          padding=k // 2, scale_a=0.02, zp_a=117,
                          scale_c=0.25, zp_c=110, relu=relu,
                          rounding=rounding)
                before = C.conv2d_int8_grouped.launches
                got = C.conv2d_int8_grouped(x, qw, oc, ep, **kw)
                assert C.conv2d_int8_grouped.launches == before + 1
                want = C.conv2d_int8_grouped_plain(x, qw, oc, ep, **kw)
                assert torch.equal(got, want)
