"""PyTorch port vs JAX package: INT8 convolution and the functional ops.

The port runs every INT8 conv as im2col + its quantized GEMM.  With the
'conv' epilogue order it must equal the JAX package's native integer conv
(``conv2d_int8_xla``, its default) bit for bit, and with the 'gemm' order the
JAX package's own im2col path (``conv2d_int8_gemm``).  Geometries are
AlexNet's three (k11 s4 p2 on 3 channels, k5 p2, k3 p1) at reduced spatial
size and narrow widths.
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
