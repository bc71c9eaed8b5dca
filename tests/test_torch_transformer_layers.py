"""PyTorch port vs JAX package: the transformer layers of the decoder slice.

The same numpy inputs go through the JAX function and its counterpart in
the port:

* the GEMM's fused act epilogue (``qgemm_plain(act=)`` against
  ``qgemm_xla(act=)``): exact for the piecewise-linear activations; for the
  transcendental ones (sigmoid, silu, gelu) the repo's contract, at most one
  code off on at most 0.2% of the outputs, since ``exp``/``erfc`` differ by
  an ULP between libms;
* the merged QKV GEMM (``qgemm_multi_plain`` against ``qgemm_multi(backend=
  'xla')``) and ``qmatmul_act``: exact, integer sums and one ordered
  multiply-add;
* ``QuantEmbed``: exact (a u8 gather of the table quantized at convert);
* ``QuantAct``, ``QuantAdd``, ``QuantLayerNorm``, ``QuantSoftmax`` (causal
  and ``valid_len``) and ``QuantPosEmbed``, run through prepare ->
  calibrate -> convert on both sides with the JAX layer's output grid
  carried over: within the contract (float reductions and transcendentals
  run in other orders).

The ``cuda``-marked tests hold the kernels (B1 with each act, B2) against
their plain versions on the card; they skip without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from int8inferenceengine_tpu import layers as JL
from int8inferenceengine_tpu.ops import gemm_int8 as JG
from int8inferenceengine_tpu.ops.qmatmul import qmatmul_act as j_qmatmul
from int8inferenceengine_tpu.tensor import Tensor as JT
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch.ops import gemm_int8 as TG
from int8inferenceengine_tpu_torch.ops.qmatmul import qmatmul_act
from int8inferenceengine_tpu_torch.tensor import Tensor as TT
from test_torch_threads import one_torch_thread  # noqa: F401

PIECEWISE = ("relu", "relu6", "hardsigmoid", "hardswish")


def assert_contract(got, want, what=""):
    """At most one code off, on at most 0.2% of the elements."""
    d = np.abs(np.asarray(got).astype(np.int32)
               - np.asarray(want).astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 0.002, (
        what, int(d.max()), float((d > 0).mean()))


def _gemm_case(m=64, k=192, n=96, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (m, k)).astype(np.uint8)
    w_nk = rng.integers(-127, 128, (n, k)).astype(np.int8)
    qb = rng.integers(-127, 128, (n,)).astype(np.int8)
    return a, w_nk, qb


# -- B1's act epilogue --------------------------------------------------------

@pytest.mark.parametrize("fn", sorted(TG.KERNEL_ACTS))
@pytest.mark.parametrize("rounding", ["trunc", "nearest"])
def test_act_epilogue_matches_qgemm_xla(fn, rounding):
    a, w_nk, qb = _gemm_case()
    kw = dict(scale_a=0.025, zp_a=127, scale_w=0.01, scale_c=0.05, zp_c=99)
    act = (fn, 0.02, 7)
    oc_j = JG.compute_offset(jnp.asarray(qb), jnp.asarray(
        w_nk.astype(np.int32).sum(1)), scale_a=0.025, zp_a=127,
        recentered=True)
    want = np.asarray(JG.qgemm_xla(jnp.asarray(a), jnp.asarray(w_nk.T), oc_j,
                                   act=act, rounding=rounding, **kw))
    ep = TG.epilogue_vector(0.025, 0.01, 0.05, w_nk.shape[0], "cpu")
    got = TG.qgemm(torch.tensor(a), torch.tensor(w_nk),
                   torch.tensor(np.asarray(oc_j)), ep, scale_a=0.025,
                   scale_c=0.05, zp_c=99, rounding=rounding, act=act).numpy()
    assert len(np.unique(want)) > 8
    if fn in PIECEWISE:
        np.testing.assert_array_equal(got, want)
    else:
        assert_contract(got, want, fn)


def test_act_epilogue_refuses_relu_and_conv_order():
    a, w_nk, qb = (torch.tensor(x) for x in _gemm_case(8, 32, 16))
    oc = torch.zeros(16, dtype=torch.int32)
    ep = TG.epilogue_vector(0.025, 0.01, 0.05, 16, "cpu")
    kw = dict(scale_a=0.025, scale_c=0.05, zp_c=99, act=("gelu", 0.02, 7))
    with pytest.raises(ValueError, match="exclusive"):
        TG.qgemm(a, w_nk, oc, ep, relu=True, **kw)
    with pytest.raises(ValueError, match="gemm order"):
        TG.qgemm(a, w_nk, oc, ep, order="conv", **kw)
    with pytest.raises(ValueError, match="no kernel epilogue"):
        TG.qgemm(a, w_nk, oc, ep, **dict(kw, act=("gelu_tanh", 0.02, 7)))


# -- B2: the merged QKV GEMM --------------------------------------------------

def _multi_parts(seed=0, k=192, ns=(192, 64, 64)):
    rng = np.random.default_rng(seed)
    parts = []
    for i, n in enumerate(ns):
        parts.append(dict(
            w=rng.integers(-127, 128, (n, k)).astype(np.int8),
            qb=rng.integers(-127, 128, (n,)).astype(np.int8),
            scale_w=(rng.uniform(0.005, 0.02, n).astype(np.float32) if i == 1
                     else 0.01 + 0.003 * i),
            scale_c=0.05 + 0.01 * i, zp_c=90 + 17 * i))
    return parts


@pytest.mark.parametrize("m", [1, 8, 64])
@pytest.mark.parametrize("rounding", ["trunc", "nearest"])
def test_qgemm_multi_matches_jax(m, rounding):
    parts = _multi_parts(seed=m)
    a = np.random.default_rng(1).integers(0, 256, (m, 192)).astype(np.uint8)
    jparts, tparts = [], []
    for p in parts:
        rowsum = p["w"].astype(np.int32).sum(1)
        oc = JG.compute_offset(jnp.asarray(p["qb"]), jnp.asarray(rowsum),
                               scale_a=0.025, zp_a=127, recentered=True)
        jparts.append(dict(w_s8_kn=jnp.asarray(p["w"].T), oc=oc,
                           scale_w=jnp.asarray(p["scale_w"]),
                           scale_c=p["scale_c"], zp_c=p["zp_c"]))
        tparts.append(dict(w_s8_nk=torch.tensor(p["w"]),
                           q_bias=torch.tensor(p["qb"]),
                           rowsum=torch.tensor(rowsum),
                           scale_w=torch.tensor(p["scale_w"]),
                           scale_c=p["scale_c"], zp_c=p["zp_c"]))
    want = JG.qgemm_multi(jnp.asarray(a), jparts, scale_a=0.025, zp_a=127,
                          rounding=rounding, backend="xla")
    merged = TG.merge_parts(tparts, scale_a=0.025, zp_a=127)
    before = TG.qgemm_multi.launches
    got = TG.qgemm_multi(torch.tensor(a), merged, rounding=rounding)
    assert TG.qgemm_multi.launches == before         # CPU: the plain version
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- qmatmul_act --------------------------------------------------------------

@pytest.mark.parametrize("transpose_b", [False, True])
@pytest.mark.parametrize("rounding", ["trunc", "nearest"])
def test_qmatmul_act_matches_jax(transpose_b, rounding):
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, (2, 3, 17, 64)).astype(np.uint8)
    b = rng.integers(0, 256, (2, 3, 40, 64) if transpose_b
                     else (2, 3, 64, 40)).astype(np.uint8)
    kw = dict(scale_a=0.021, zp_a=117, scale_b=0.034, zp_b=131,
              scale_c=0.19, zp_c=140, alpha=64 ** -0.5,
              transpose_b=transpose_b, rounding=rounding)
    want = np.asarray(j_qmatmul(jnp.asarray(a), jnp.asarray(b), **kw))
    got = qmatmul_act(torch.tensor(a), torch.tensor(b), **kw).numpy()
    assert len(np.unique(want)) > 32
    np.testing.assert_array_equal(got, want)


# -- the layers, through their lifecycle -------------------------------------

def _calibrate(pair, calib_args, test_args):
    """prepare -> FP32 calibration call -> convert on both layers; the port
    layer takes the JAX layer's output grid; returns (jax, port) outputs of
    ``test_args`` (a tuple of (jax Tensor, port Tensor) pairs)."""
    jl, tl = pair
    for layer in pair:
        layer.prepare()
    jl(*(j for j, _ in calib_args))
    tl(*(t for _, t in calib_args))
    for layer in pair:
        layer.convert()
    assert tl.zero_point == jl.zero_point
    assert tl.scale == pytest.approx(jl.scale, rel=1e-5)
    tl.scale, tl.zero_point = jl.scale, jl.zero_point
    return (np.asarray(jl(*(j for j, _ in test_args)).data),
            tl(*(t for _, t in test_args)).data.numpy())


def _float(x):
    return JT(jnp.asarray(x)), TT(torch.tensor(x))


def _codes(x, scale, zp):
    return (JT(jnp.asarray(x), scale, zp), TT(torch.tensor(x), scale, zp))


def _rng(seed):
    return np.random.default_rng(seed)


def test_quant_embed_is_exact():
    table = _rng(0).standard_normal((256, 32)).astype(np.float32)
    ids = _rng(1).integers(-3, 260, (4, 9)).astype(np.float32)  # clamped
    pair = (JL.QuantEmbed(256, 32), qt.QuantEmbed(256, 32, device="cpu"))
    for layer in pair:
        layer.load_weight(table)
    want, got = _calibrate(pair, [_float(ids[:2])], [_float(ids)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pair[1].q_weight.numpy(),
                                  np.asarray(pair[0].params["q_weight"]))


@pytest.mark.parametrize("fn", ["gelu", "relu", "silu", "hardswish"])
def test_quant_act_within_contract(fn):
    x = _rng(2).standard_normal((64, 96)).astype(np.float32) * 2
    codes = _rng(3).integers(0, 256, (64, 96)).astype(np.uint8)
    want, got = _calibrate((JL.QuantAct(fn), qt.QuantAct(fn, device="cpu")),
                           [_float(x)], [_codes(codes, 0.021, 131)])
    assert_contract(got, want, fn)


def test_quant_add_within_contract():
    rng = _rng(4)
    x, y = (rng.standard_normal((32, 128)).astype(np.float32)
            for _ in range(2))
    ca, cb = (rng.integers(0, 256, (32, 128)).astype(np.uint8)
              for _ in range(2))
    want, got = _calibrate((JL.QuantAdd(), qt.QuantAdd(device="cpu")),
                           [_float(x), _float(y)],
                           [_codes(ca, 0.017, 120), _codes(cb, 0.031, 99)])
    assert_contract(got, want)


def test_quant_layernorm_within_contract():
    rng = _rng(5)
    gamma = (1 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(128)).astype(np.float32)
    x = rng.standard_normal((64, 128)).astype(np.float32) * 3
    codes = rng.integers(0, 256, (64, 128)).astype(np.uint8)
    pair = (JL.QuantLayerNorm(128), qt.QuantLayerNorm(128, device="cpu"))
    for layer in pair:
        layer.load_weight(gamma)
        layer.load_bias(beta)
    fp = [np.asarray(pair[0](JT(jnp.asarray(x))).data),
          pair[1](TT(torch.tensor(x))).data.numpy()]
    np.testing.assert_allclose(fp[1], fp[0], rtol=1e-5, atol=1e-5)
    want, got = _calibrate(pair, [_float(x)], [_codes(codes, 0.02, 128)])
    assert_contract(got, want)


@pytest.mark.parametrize("mode", ["causal", "valid_scalar", "valid_rows",
                                  "valid_window_softcap"])
def test_quant_softmax_within_contract(mode):
    rng = _rng(6)
    t = 48
    x = rng.standard_normal((2, 4, t, t)).astype(np.float32) * 2
    codes = rng.integers(0, 256, (2, 4, t, t)).astype(np.uint8)
    kw, valid_j, valid_t = {}, None, None
    if mode == "causal":
        kw = dict(causal=True)
    elif mode == "valid_scalar":
        valid_j, valid_t = jnp.int32(29), torch.tensor(29, dtype=torch.int32)
    else:
        v = np.array([5, 40], np.int32).reshape(2, 1, 1, 1)
        valid_j, valid_t = jnp.asarray(v), torch.tensor(v)
        if mode == "valid_window_softcap":
            kw = dict(window=16, softcap=3.0)
    pair = (JL.QuantSoftmax(**kw), qt.QuantSoftmax(device="cpu", **kw))
    calib = [_float(x)]
    test = [_codes(codes, 0.05, 140)]
    if valid_j is not None:
        for layer in pair:
            layer.prepare()
        pair[0](calib[0][0], valid_len=valid_j)
        pair[1](calib[0][1], valid_len=valid_t)
        for layer in pair:
            layer.convert()
        pair[1].scale, pair[1].zero_point = pair[0].scale, pair[0].zero_point
        want = np.asarray(pair[0](test[0][0], valid_len=valid_j).data)
        got = pair[1](test[0][1], valid_len=valid_t).data.numpy()
    else:
        want, got = _calibrate(pair, calib, test)
    assert_contract(got, want, mode)


def test_quant_pos_embed_within_contract():
    rng = _rng(7)
    table = (0.5 * rng.standard_normal((64, 32))).astype(np.float32)
    x = rng.standard_normal((3, 20, 32)).astype(np.float32)
    codes = rng.integers(0, 256, (3, 20, 32)).astype(np.uint8)
    pair = (JL.QuantPosEmbed(64, 32, cls=False),
            qt.QuantPosEmbed(64, 32, cls=False, device="cpu"))
    for layer in pair:
        layer.load_weight(table)
    want, got = _calibrate(pair, [_float(x)], [_codes(codes, 0.02, 130)])
    assert_contract(got, want)
    # a decode position: a scalar start (device tensor) and per-row starts
    one = codes[:, :1]
    want = np.asarray(pair[0](JT(jnp.asarray(one), 0.02, 130),
                              start=jnp.int32(37)).data)
    got = pair[1](TT(torch.tensor(one), 0.02, 130),
                  start=torch.tensor(37)).data.numpy()
    assert_contract(got, want, "start")
    starts = np.array([0, 11, 63], np.int32)
    want = np.asarray(pair[0](JT(jnp.asarray(one), 0.02, 130),
                              start=jnp.asarray(starts)).data)
    got = pair[1](TT(torch.tensor(one), 0.02, 130),
                  start=torch.tensor(starts)).data.numpy()
    assert_contract(got, want, "per-row start")


# -- the kernels on the card --------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fn", sorted(TG.KERNEL_ACTS))
def test_act_kernel_matches_plain_on_card(cuda_device, fn):
    for m, k, n in [(8, 768, 3072), (64, 192, 96), (33, 100, 7)]:
        a, w_nk, qb = (torch.tensor(x).to(cuda_device)
                       for x in _gemm_case(m, k, n))
        oc = TG.compute_offset(qb, w_nk.to(torch.int32).sum(1), 0.025, 127,
                               recentered=True)
        ep = TG.epilogue_vector(0.025, 0.01, 0.05 * np.sqrt(k / 192), n,
                                cuda_device)
        for rounding in ("trunc", "nearest"):
            kw = dict(scale_a=0.025, scale_c=0.05 * np.sqrt(k / 192),
                      zp_c=99, rounding=rounding, act=(fn, 0.02, 7))
            before = TG.qgemm.launches
            got = TG.qgemm(a, w_nk, oc, ep, **kw)
            want = TG.qgemm_plain(a, w_nk, oc, ep, **kw)
            torch.cuda.synchronize()
            assert TG.qgemm.launches == before + 1
            if fn in PIECEWISE:
                assert torch.equal(got, want), (m, k, n, rounding)
            else:
                assert_contract(got.cpu(), want.cpu(), (fn, m, k, n))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 512, 37])
def test_multi_kernel_matches_plain_on_card(cuda_device, m):
    parts = _multi_parts(seed=m, k=768, ns=(768, 768, 768))
    tparts = [dict(w_s8_nk=torch.tensor(p["w"]).to(cuda_device),
                   q_bias=torch.tensor(p["qb"]).to(cuda_device),
                   rowsum=torch.tensor(p["w"].astype(np.int32).sum(1)).to(
                       cuda_device),
                   scale_w=torch.tensor(p["scale_w"]).to(cuda_device),
                   scale_c=p["scale_c"] * 2, zp_c=p["zp_c"]) for p in parts]
    merged = TG.merge_parts(tparts, scale_a=0.025, zp_a=127)
    a = torch.tensor(_rng(m).integers(0, 256, (m, 768)).astype(np.uint8)).to(
        cuda_device)
    for rounding in ("trunc", "nearest"):
        before = TG.qgemm_multi.launches
        got = TG.qgemm_multi(a, merged, rounding=rounding)
        want = TG.qgemm_multi_plain(a, merged, rounding=rounding)
        torch.cuda.synchronize()
        assert TG.qgemm_multi.launches == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w), (m, rounding)
