"""PyTorch port vs JAX package: INT8 convolution and the functional ops.

On the CPU the port runs every INT8 conv as im2col + its quantized GEMM's
plain version.  With the 'conv' epilogue order it must equal the JAX
package's native integer conv (``conv2d_int8_xla``, its default) bit for
bit, and with the 'gemm' order the JAX package's own im2col path
(``conv2d_int8_gemm``).  Geometries are AlexNet's three (k11 s4 p2 on 3
channels, k5 p2, k3 p1) at reduced spatial size and narrow widths.

On the card a conv runs the gathered conv (``qgemm_conv``: kernel B1
reading its patches straight from the NHWC input); the planner's route and
the wrapper's CPU path are checked here, and the ``cuda``-marked test holds
the kernel against im2col + ``qgemm_plain`` bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import int8inferenceengine_tpu as qj
from int8inferenceengine_tpu.ops import conv as JC
from int8inferenceengine_tpu.ops import gemm_int8 as JG
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch.ops import conv as TC
from int8inferenceengine_tpu_torch.ops import gemm_int8 as TG
from test_torch_threads import one_torch_thread  # noqa: F401

GEOMETRIES = [  # (h, c_in, c_out, k, stride, padding)
    (35, 3, 16, 11, 4, 2),     # AlexNet conv1
    (13, 12, 24, 5, 1, 2),     # AlexNet conv2
    (9, 24, 20, 3, 1, 1),      # AlexNet conv3-5
]
S_A, ZP_A, ZP_C = 0.02, 127, 120


def _case(h, ci, co, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (2, h, h, ci)).astype(np.uint8)
    w = rng.integers(-127, 128, (k, k, ci, co)).astype(np.int8)      # HWIO
    qb = rng.integers(-127, 128, (co,)).astype(np.int8)
    s_w_pc = rng.uniform(0.005, 0.02, co).astype(np.float32)
    s_c = float(np.float32(S_A * 0.01 * 74 * 74 * np.sqrt(k * k * ci) / 60))
    return x, w, qb, s_w_pc, s_c


@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("rounding,relu", [("trunc", False), ("trunc", True),
                                           ("nearest", False),
                                           ("nearest", True)])
def test_int8_conv_matches_jax(geom, per_channel, rounding, relu):
    h, ci, co, k, s, p = geom
    x, w, qb, s_w_pc, s_c = _case(h, ci, co, k, seed=h + ci + k)
    s_w = s_w_pc if per_channel else 0.0113
    rowsum = w.astype(np.int32).sum(axis=(0, 1, 2))
    oc_j = JG.compute_offset(jnp.asarray(qb), jnp.asarray(rowsum),
                             scale_a=S_A, zp_a=ZP_A, recentered=True)
    kw = dict(scale_a=S_A, zp_a=ZP_A, scale_c=s_c, zp_c=ZP_C, relu=relu,
              rounding=rounding)
    jsw = jnp.asarray(s_w) if per_channel else s_w
    want_conv = np.asarray(JC.conv2d_int8_xla(
        jnp.asarray(x), jnp.asarray(w), oc_j, stride=s, padding=p,
        scale_w=jsw, **kw))
    want_gemm = np.asarray(JC.conv2d_int8_gemm(
        jnp.asarray(x), jnp.asarray(w.reshape(k * k * ci, co)), oc_j, kh=k,
        kw=k, stride=s, padding=p, backend="xla", scale_w=jsw, **kw))

    oc_t = TG.compute_offset(torch.tensor(qb), torch.tensor(rowsum), S_A,
                             ZP_A, recentered=True)
    qw_nk = torch.tensor(w.reshape(k * k * ci, co).T.copy())
    tsw = torch.tensor(s_w) if per_channel else s_w
    for order, want in (("conv", want_conv), ("gemm", want_gemm)):
        ep = TG.epilogue_vector(S_A, tsw, s_c, co, "cpu", order)
        got = TC.conv2d_int8_gemm(torch.tensor(x), qw_nk, oc_t, ep, kh=k,
                                  kw=k, stride=s, padding=p, order=order,
                                  **kw).numpy()
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=order)


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_im2col_matches_jax(geom):
    h, ci, _, k, s, p = geom
    x = _case(h, ci, 4, k, seed=1)[0]
    want = np.asarray(JC.im2col_nhwc(jnp.asarray(x), k, k, s, p,
                                     pad_value=ZP_A))
    got = TC.im2col_nhwc(torch.tensor(x), k, k, s, p, pad_value=ZP_A)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("nhwc", [False, True])
@pytest.mark.parametrize("k,s,p,ceil", [(3, 2, 0, False), (2, 2, 0, False),
                                        (3, 2, 1, False), (3, 2, 0, True),
                                        (2, 2, 1, True)])
def test_relu_and_max_pool_match_jax(quantized, nhwc, k, s, p, ceil):
    rng = np.random.default_rng(k + s + p)
    if quantized:
        d = rng.integers(0, 256, (2, 13, 11, 5)).astype(np.uint8)
    else:
        d = rng.standard_normal((2, 13, 11, 5)).astype(np.float32)
    if not nhwc:
        d = np.ascontiguousarray(d.transpose(0, 3, 1, 2))
    kw = dict(scale=0.05, zero_point=77, _nhwc=nhwc)
    xj = qj.Tensor(jnp.asarray(d), **kw)
    xt = qt.Tensor(torch.tensor(d), **kw)
    for fj, ft in ((lambda t: qj.max_pool2d(t, k, s, p, ceil),
                    lambda t: qt.max_pool2d(t, k, s, p, ceil)),
                   (qj.relu, qt.relu)):
        oj, ot = fj(xj), ft(xt)
        assert (ot.scale, ot.zero_point, ot.shape) == (
            oj.scale, oj.zero_point, oj.shape)
        np.testing.assert_array_equal(ot.numpy(), oj.numpy())


@pytest.mark.parametrize("nhwc", [False, True])
def test_tensor_api_matches_jax(nhwc):
    """Logical NCHW order through reshape (AlexNet's flatten before fc1),
    elementwise ==, sum, argmax and the module-level quantize/dequantize."""
    d = np.random.default_rng(2).standard_normal((2, 4, 3, 5)).astype(
        np.float32)
    if nhwc:
        d = np.ascontiguousarray(d.transpose(0, 2, 3, 1))
    xj = qj.Tensor(jnp.asarray(d), _nhwc=nhwc)
    xt = qt.Tensor(torch.tensor(d), _nhwc=nhwc)
    assert xt.shape == xj.shape
    np.testing.assert_array_equal(xt.reshape(2, -1).numpy(),
                                  xj.reshape(2, -1).numpy())
    assert xt.sum() == xj.sum()
    np.testing.assert_array_equal((xt == xt.numpy()).numpy(),
                                  (xj == xj.numpy()).numpy())
    for axis in (None, 1):
        np.testing.assert_array_equal(qt.argmax(xt, axis=axis).numpy(),
                                      qj.argmax(xj, axis=axis).numpy())
    for rounding in ("trunc", "nearest"):
        qxj = qj.quantize(xj, 0.0173, 101, rounding)
        qxt = qt.quantize(xt, 0.0173, 101, rounding)
        np.testing.assert_array_equal(qxt.numpy(), qxj.numpy())
        np.testing.assert_array_equal(qt.dequantize(qxt).numpy(),
                                      qj.dequantize(qxj).numpy())


# -- the gathered conv (kernel B1's conv variant) ---------------------------

# (batch, h, w, c, k, stride, padding, c_out): AlexNet's five convs at batch
# 100, then ragged geometries
ALEXNET_CONVS = [(100, 224, 224, 3, 11, 4, 2, 96),
                 (100, 27, 27, 96, 5, 1, 2, 256),
                 (100, 13, 13, 256, 3, 1, 1, 384),
                 (100, 13, 13, 384, 3, 1, 1, 384),
                 (100, 13, 13, 384, 3, 1, 1, 256)]
RAGGED_CONVS = [(1, 9, 7, 16, 3, 2, 1, 20), (2, 11, 13, 3, 5, 2, 2, 33),
                (3, 10, 9, 48, 1, 1, 0, 40), (1, 35, 33, 3, 11, 4, 2, 16),
                (2, 15, 15, 96, 5, 1, 2, 64)]


@pytest.mark.parametrize("geom", ALEXNET_CONVS + RAGGED_CONVS)
def test_conv_route_is_gathered(geom):
    b, h, w, c, k, s, p, co = geom
    g = TG.ConvGeom(b, h, w, c, k, k, s, p)
    m, kk = g.gemm_shape
    if b < 100:
        patches = TC.im2col_nhwc(torch.zeros((b, h, w, c), dtype=torch.uint8),
                                 k, k, s, p)
        assert patches.shape == (b, *g.out_hw, kk)
    assert m == b * g.out_hw[0] * g.out_hw[1] and kk == k * k * c
    assert TG.conv_gathered(g)
    plan = TG.plan_qgemm(m, co, kk, conv=g)
    assert plan.variant == "conv"
    # 16-byte copies where a chunk of k lies inside one tap, else 4-byte
    # words (C padded to a multiple of 4 first)
    assert plan.loader == ("cp.async" if c % 16 == 0 else "word")
    if b == 100:
        # AlexNet's convs fill the card with 128 x 128 tiles and never split
        assert plan.tile == (128, 128) and plan.slices == 1


@pytest.mark.parametrize("geom", RAGGED_CONVS)
@pytest.mark.parametrize("order", ["conv", "gemm"])
def test_gathered_conv_on_cpu_is_im2col_plain(geom, order):
    b, h, w, c, k, s, p, co = geom
    rng = np.random.default_rng(k + c)
    x = torch.tensor(rng.integers(0, 256, (b, h, w, c)).astype(np.uint8))
    qw = torch.tensor(rng.integers(-127, 128, (co, k * k * c)).astype(np.int8))
    oc = torch.tensor(rng.integers(-5000, 5000, co).astype(np.int32))
    ep = TG.epilogue_vector(S_A, torch.tensor(rng.uniform(
        0.005, 0.02, co).astype(np.float32)), 0.05, co, "cpu", order)
    kw = dict(kh=k, kw=k, stride=s, padding=p, scale_a=S_A, zp_a=ZP_A,
              scale_c=0.05 * np.sqrt(k * k * c), zp_c=ZP_C, relu=True,
              rounding="nearest", order=order)
    before = TG.qgemm.launches
    got = TC.qgemm_conv(x, qw, oc, ep, **kw)
    want = TC.conv2d_int8_gemm(x, qw, oc, ep, gemm=TG.qgemm_plain, **kw)
    assert TG.qgemm.launches == before
    assert got.shape == (b, *TG.ConvGeom(b, h, w, c, k, k, s, p).out_hw, co)
    assert torch.equal(got, want)


@pytest.mark.parametrize("rounding,relu", [("trunc", True),
                                           ("nearest", False)])
def test_conv2d_layer_on_cpu_matches_conv2d_int8_xla(rounding, relu):
    """The ``Conv2d`` layer (its CPU route: im2col + the plain GEMM) against
    the JAX package's native integer conv, at a ragged geometry (batch 3,
    odd H and W, stride 2)."""
    h, ci, co, k, s, p = 11, 16, 20, 3, 2, 1
    rng = np.random.default_rng(5)
    x = rng.integers(0, 256, (3, h, h + 2, ci)).astype(np.uint8)
    w = rng.integers(-127, 128, (k, k, ci, co)).astype(np.int8)     # HWIO
    qb = rng.integers(-127, 128, (co,)).astype(np.int8)
    s_w = rng.uniform(0.005, 0.02, co).astype(np.float32)
    s_c = float(np.float32(S_A * 0.01 * 74 * 74 * np.sqrt(k * k * ci) / 60))
    rowsum = w.astype(np.int32).sum(axis=(0, 1, 2))
    oc_j = JG.compute_offset(jnp.asarray(qb), jnp.asarray(rowsum),
                             scale_a=S_A, zp_a=ZP_A, recentered=True)
    want = np.asarray(JC.conv2d_int8_xla(
        jnp.asarray(x), jnp.asarray(w), oc_j, stride=s, padding=p,
        scale_w=jnp.asarray(s_w), scale_a=S_A, zp_a=ZP_A, scale_c=s_c,
        zp_c=ZP_C, relu=relu, rounding=rounding))
    layer = qt.Conv2d(ci, co, k, stride=s, padding=p, fuse_relu=relu,
                      config=qt.QuantConfig(rounding=rounding), device="cpu")
    layer.is_quantized = True
    layer.set_quantized(torch.tensor(w.transpose(3, 0, 1, 2).reshape(co, -1)),
                        torch.tensor(qb), torch.tensor(s_w))
    layer.scale, layer.zero_point = s_c, ZP_C
    out = layer(qt.Tensor(torch.tensor(x), S_A, ZP_A, _nhwc=True))
    np.testing.assert_array_equal(out.data.numpy(), want)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("geom", [RAGGED_CONVS[0], RAGGED_CONVS[1],
                                  RAGGED_CONVS[4]])
def test_gathered_conv_matches_plain_on_card(cuda_device, geom):
    b, h, w, c, k, s, p, co = geom
    rng = np.random.default_rng(k + c)
    x = torch.tensor(rng.integers(0, 256, (b, h, w, c)).astype(np.uint8),
                     device=cuda_device)
    qw = torch.tensor(rng.integers(-127, 128, (co, k * k * c)).astype(np.int8),
                      device=cuda_device)
    oc = torch.tensor(rng.integers(-5000, 5000, co).astype(np.int32),
                      device=cuda_device)
    for order in ("conv", "gemm"):
        ep = TG.epilogue_vector(S_A, 0.01, 0.05, co, cuda_device, order)
        for rounding, relu in (("trunc", True), ("nearest", False)):
            kw = dict(kh=k, kw=k, stride=s, padding=p, scale_a=S_A, zp_a=ZP_A,
                      scale_c=0.05 * np.sqrt(k * k * c), zp_c=ZP_C, relu=relu,
                      rounding=rounding, order=order)
            before = TG.qgemm.launches
            got = TC.conv2d_int8_gemm(x, qw, oc, ep, **kw)
            want = TC.conv2d_int8_gemm(x, qw, oc, ep, gemm=TG.qgemm_plain,
                                       **kw)
            torch.cuda.synchronize()
            assert TG.qgemm.launches == before + 1
            assert torch.equal(got, want), (order, rounding, relu)
