"""PyTorch port vs JAX package: 4-bit grouped weights (``ops/w4.py``).

The same numpy inputs go through the JAX function and its counterpart in
the port:

* ``pack_w4`` (max/7 and MSE-searched scales, a short last group) gives the
  same packed bytes and scales; where an MSE group picks another candidate
  the two candidates' float32 errors tie.  ``dequant_w4`` is exact.
* B5's plain version (``w4_gemm_plain``) against ``w4_matmul_xla`` and the
  Pallas kernel in interpret mode: rtol 2e-5 of the largest |output|
  (float32 sums in other orders).
* ``split_bf16x3`` (B5's in-kernel split of x into three bf16 pieces)
  rebuilds every f32 input exactly.
* B6's plain version against the Pallas v2 kernel (``w4a8_matmul_pallas``,
  interpret mode) at v2 shapes: exact, since both sum exact integer group
  partials and fold them in group order.  Generalised to any M and group (the
  arithmetic of B7's CUDA kernel), it stays within the code contract of
  ``w4a8_matmul_xla``.
* B7's plain version against the Pallas v1 kernel and ``w4a8_matmul_xla``:
  the repo's contract, at most one code off on at most 0.2% of the outputs.
* ``w4a8_matmul_multi`` equals the per-layer calls, on both dispatch
  branches.

The ``cuda``-marked tests hold the three CUDA kernels against their plain
versions on the card (B7 also bit for bit against ``w4a8_v2_plain``); they
skip without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from int8inferenceengine_tpu.ops import w4 as JW
from int8inferenceengine_tpu_torch.ops import w4 as TW
from test_torch_cnn_zoo import exact_jit
from test_torch_threads import one_torch_thread  # noqa: F401


def assert_contract(got, want, what=""):
    """At most one code off, on at most 0.2% of the elements."""
    d = np.abs(np.asarray(got).astype(np.int32)
               - np.asarray(want).astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 0.002, (
        what, int(d.max()), float((d > 0).mean()))


def _weights(n, k, seed=0, scale=0.1):
    return np.random.default_rng(seed).normal(0, scale, (n, k)).astype(
        np.float32)


# -- pack / dequant ------------------------------------------------------------

def _packed(n, k, group, seed):
    """Packed weights and scales of ``_weights(n, k, seed)`` (max/7
    scales).  The port's ``pack_w4`` gives the JAX package's bytes and
    scales bit for bit (``test_pack_w4_matches_jax``), in a fraction of the
    time eager JAX takes to compile it for every new shape."""
    tp, ts = TW.pack_w4(torch.tensor(_weights(n, k, seed)), group)
    return tp.numpy(), ts.numpy()


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("n,k,group", [(48, 256, 64), (8, 96, 64),
                                       (16, 200, 128), (24, 64, 128)])
def test_pack_w4_matches_jax(optimize, n, k, group):
    w = _weights(n, k, seed=k)
    jp, js = (np.asarray(a) for a in JW.pack_w4(jnp.asarray(w), group,
                                                 optimize=optimize))
    tp, ts = TW.pack_w4(torch.tensor(w), group, optimize=optimize)
    tp, ts = tp.numpy(), ts.numpy()
    assert tp.dtype == np.uint8 and tp.shape == jp.shape == (n, k // 2)
    assert ts.shape == js.shape == (n, -(-k // min(group, k)))
    differ = np.argwhere(ts != js)
    assert optimize or len(differ) == 0
    g = min(group, k)
    wg = np.pad(w, ((0, 0), (0, ts.shape[1] * g - k))).reshape(n, -1, g)
    for r, c in differ:
        # an MSE tie: both scales reconstruct the group equally well in f32
        errs = []
        for s in (np.float32(ts[r, c]), np.float32(js[r, c])):
            q = np.clip(np.round(wg[r, c] / s), -7, 7)
            errs.append(np.sum(np.square(q * s - wg[r, c]),
                               dtype=np.float32))
        assert errs[0] == errs[1], (r, c, errs)
    if len(differ) == 0:
        np.testing.assert_array_equal(tp, jp)


def test_pack_w4_odd_k_raises():
    w = _weights(4, 95)
    with pytest.raises(ValueError, match="even K"):
        TW.pack_w4(torch.tensor(w), 64)
    with pytest.raises(ValueError, match="even K"):
        JW.pack_w4(jnp.asarray(w), 64)


@pytest.mark.parametrize("k,group", [(256, 64), (96, 64), (200, 128)])
def test_dequant_w4_matches_jax(k, group):
    packed, scales = _packed(32, k, group, seed=3)
    want = np.asarray(JW.dequant_w4(jnp.asarray(packed), jnp.asarray(scales),
                                    k, group))
    got = TW.dequant_w4(torch.tensor(packed), torch.tensor(scales), k,
                        group).numpy()
    np.testing.assert_array_equal(got, want)


# -- B5: W4 weight-only ----------------------------------------------------------

def _split_inputs(kind):
    """Random f32 at exponents -90 ... 100 with random signs, or edge values
    (signed zeros, powers of two down to 2^-120, the smallest normal,
    FLT_MAX)."""
    if kind == "random":
        rng = np.random.default_rng(11)
        n = 1 << 16
        return (rng.uniform(1, 2, n) * rng.choice([-1.0, 1.0], n)
                * np.exp2(rng.integers(-90, 101, n))).astype(np.float32)
    f = np.finfo(np.float32)
    edges = [0.0, -0.0, 2.0 ** -100, 2.0 ** -110, 2.0 ** -120, f.tiny, f.max,
             1.0 + 2.0 ** -23, -(1.0 + 2.0 ** -23), 3.1415927]
    return np.array(edges + [-e for e in edges], dtype=np.float32)


@pytest.mark.parametrize("kind", ["random", "edges"])
def test_split_bf16x3_rebuilds_f32(kind):
    x = _split_inputs(kind)
    pieces = TW.split_bf16x3(torch.tensor(x))
    assert all(p.dtype == torch.bfloat16 for p in pieces)
    hi, mid, lo = (p.to(torch.float64).numpy() for p in pieces)
    # exact in float64, and in the f32 order the pieces are added in
    np.testing.assert_array_equal(hi + mid + lo, x.astype(np.float64))
    f32 = (torch.tensor(hi, dtype=torch.float32) + torch.tensor(
        mid, dtype=torch.float32)) + torch.tensor(lo, dtype=torch.float32)
    np.testing.assert_array_equal(f32.numpy().view(np.uint32) & 0x7FFFFFFF,
                                  x.view(np.uint32) & 0x7FFFFFFF)

def _b5_case(m, k, n, group, seed=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    bias = rng.normal(0, 0.1, n).astype(np.float32)
    packed, scales = _packed(n, k, group, seed)
    return x, bias, packed, scales


def _b5_port(x, bias, packed, scales, k, group):
    return TW.w4_gemm(torch.tensor(x), torch.tensor(packed),
                      torch.tensor(scales), torch.tensor(bias), k,
                      group).numpy()


@pytest.mark.parametrize("m,k,n,group", [(8, 256, 96, 64), (37, 200, 61, 128),
                                         (64, 512, 128, 128)])
def test_b5_plain_matches_w4_matmul_xla(m, k, n, group):
    x, bias, packed, scales = _b5_case(m, k, n, group)
    want = np.asarray(JW.w4_matmul_xla(jnp.asarray(x), packed, scales,
                                       jnp.asarray(bias), k, group))
    got = _b5_port(x, bias, packed, scales, k, group)
    np.testing.assert_allclose(got, want, rtol=2e-5,
                               atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize("m,k,n,group", [(8, 256, 96, 64),
                                         (16, 256, 128, 128)])
def test_b5_plain_matches_pallas_kernel(m, k, n, group):
    x, bias, packed, scales = _b5_case(m, k, n, group)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JW.w4_matmul_pallas(
            jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scales),
            jnp.asarray(bias), k, group))
    got = _b5_port(x, bias, packed, scales, k, group)
    np.testing.assert_allclose(got, want, rtol=2e-5,
                               atol=2e-5 * np.abs(want).max())


# -- B6 and B7: W4A8 ---------------------------------------------------------------

def _w4a8_case(m, k, n, group, seed=0, vector_mult=False):
    """u8 codes, packed weights, zpb, mult (scalar or per column) and the
    weight's f32 row sums (JAX's ``w4_wsum``), the output mid-range."""
    rng = np.random.default_rng(seed)
    packed, scales = _packed(n, k, group, seed)
    x = rng.integers(0, 256, (m, k)).astype(np.uint8)
    bias = rng.normal(0, 0.1, n).astype(np.float32)
    s_x, zp_x = np.float32(0.05), 117
    s_out = np.float32(s_x * 74 * 0.1 * np.sqrt(k) / 40)
    zpb = np.float32(131) + bias / s_out
    mult = s_x / s_out
    if vector_mult:
        mult = (mult * rng.uniform(0.7, 1.3, n)).astype(np.float32)
    # JAX's row sums of the dequantized weight (the port's dequant_w4 is
    # exact against JAX's, test_dequant_w4_matches_jax)
    deq = TW.dequant_w4(torch.tensor(packed), torch.tensor(scales), k, group)
    wsum = np.asarray(jnp.sum(jnp.asarray(deq.numpy()), axis=1))
    return dict(x=x, packed=packed, scales=scales, zpb=zpb,
                mult=mult, zp_x=zp_x, wsum=wsum, k=k, group=group)


def _jax(fn, c, rounding, **kw):
    mult = jnp.asarray(c["mult"]) if np.ndim(c["mult"]) else \
        jnp.float32(c["mult"])
    return np.asarray(exact_jit(
        lambda x, packed, scales, zpb, mult_: fn(
            x, packed, scales, zpb, c["k"], c["group"], zp_x=c["zp_x"],
            mult=mult_, rounding=rounding, **kw),
        jnp.asarray(c["x"]), jnp.asarray(c["packed"]),
        jnp.asarray(c["scales"]), jnp.asarray(c["zpb"]), mult))


def _port(c, rounding, backend="auto"):
    mult = torch.tensor(c["mult"]) if np.ndim(c["mult"]) else \
        float(c["mult"])
    return TW.w4a8_matmul(torch.tensor(c["x"]), torch.tensor(c["packed"]),
                          torch.tensor(c["scales"]), torch.tensor(c["zpb"]),
                          c["k"], c["group"], backend, zp_x=c["zp_x"],
                          mult=mult, rounding=rounding,
                          wsum=torch.tensor(c["wsum"])).numpy()


V2_SHAPES = [(8, 256, 96, 128, False), (16, 512, 200, 128, True),
             (8, 768, 384, 256, True), (32, 256, 130, 64, False)]


@pytest.mark.parametrize("rounding", ["trunc", "nearest"])
@pytest.mark.parametrize("m,k,n,group,vec", V2_SHAPES)
def test_b6_plain_matches_pallas_v2(m, k, n, group, vec, rounding):
    c = _w4a8_case(m, k, n, group, seed=m + n, vector_mult=vec)
    assert TW.use_v2(m, k, group, k // group)
    want = _jax(JW.w4a8_matmul_pallas, c, rounding, wsum=c["wsum"],
                interpret=True)
    got = _port(c, rounding)
    assert len(np.unique(want)) > 16
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_v2_plain(c, rounding), want)


def _v2_plain(c, rounding):
    """The generalised ``w4a8_v2_plain`` on the case's operands."""
    mult = torch.tensor(c["mult"]) if np.ndim(c["mult"]) else \
        float(c["mult"])
    ops = TW.w4a8_operands(torch.tensor(c["packed"]),
                           torch.tensor(c["scales"]), torch.tensor(c["zpb"]),
                           c["k"], c["group"], zp_x=c["zp_x"], mult=mult,
                           wsum=torch.tensor(c["wsum"]))
    return TW.w4a8_v2_plain(torch.tensor(c["x"]), ops["packed"],
                            ops["scales_t"], ops["mult_v"], ops["zpb_eff"],
                            c["k"], c["group"], rounding).numpy()


# a short last group, a group off the 32-value k-step, M > 512 and not a
# multiple of 8: the shapes B6's envelope leaves to B7
V2_GENERAL_SHAPES = [(5, 200, 40, 64, False), (16, 96, 40, 48, True),
                     (520, 256, 24, 128, True)]


@pytest.mark.parametrize("rounding", ["trunc", "nearest"])
@pytest.mark.parametrize("m,k,n,group,vec", V2_GENERAL_SHAPES)
def test_v2_plain_generalised_within_contract_of_xla(m, k, n, group, vec,
                                                    rounding):
    c = _w4a8_case(m, k, n, group, seed=m + k, vector_mult=vec)
    assert not TW.use_v2(m, k, group, -(-k // min(group, k)))
    got = _v2_plain(c, rounding)
    assert len(np.unique(got)) > 16
    assert_contract(got, _jax(JW.w4a8_matmul_xla, c, rounding), "xla")


V1_SHAPES = [(5, 256, 96, 128), (37, 512, 70, 128), (8 * 65, 256, 40, 64)]


@pytest.mark.parametrize("rounding", ["trunc", "nearest"])
@pytest.mark.parametrize("m,k,n,group", V1_SHAPES)
def test_b7_plain_matches_pallas_v1_and_xla(m, k, n, group, rounding):
    c = _w4a8_case(m, k, n, group, seed=m)
    assert not TW.use_v2(m, k, group, k // group)
    got = _port(c, rounding)
    assert len(np.unique(got)) > 16
    assert_contract(got, _jax(JW.w4a8_matmul_xla, c, rounding), "xla")
    if m <= 512:               # the JAX dispatch's Pallas envelope
        want = _jax(JW.w4a8_matmul_pallas, c, rounding, interpret=True)
        assert_contract(got, want, "pallas v1")
    # 'xla' runs B7's function on every shape
    np.testing.assert_array_equal(_port(c, rounding, backend="xla"), got)


@pytest.mark.parametrize("m", [8, 5])
def test_w4a8_matmul_multi_equals_per_layer_calls(m):
    k, group = 256, 128
    cases = [_w4a8_case(m, k, n, group, seed=i)
             for i, n in enumerate((64, 32, 96))]
    parts = [dict(packed=torch.tensor(c["packed"]),
                  scales=torch.tensor(c["scales"]),
                  zpb=torch.tensor(c["zpb"]), mult=float(c["mult"]),
                  wsum=torch.tensor(c["wsum"])) for c in cases]
    x = cases[0]["x"]
    outs = TW.w4a8_matmul_multi(torch.tensor(x), parts, k, group,
                                zp_x=cases[0]["zp_x"], rounding="nearest")
    jparts = [dict(packed=jnp.asarray(c["packed"]),
                   scales=jnp.asarray(c["scales"]),
                   zpb=jnp.asarray(c["zpb"]), mult=jnp.float32(c["mult"]),
                   wsum=jnp.asarray(c["wsum"])) for c in cases]
    with pltpu.force_tpu_interpret_mode():
        jouts = JW.w4a8_matmul_multi(jnp.asarray(x), jparts, k, group,
                                     zp_x=cases[0]["zp_x"],
                                     rounding="nearest", backend="pallas")
    for c, got, jgot in zip(cases, outs, jouts):
        alone = _port(dict(c, x=x), "nearest")
        np.testing.assert_array_equal(got.numpy(), alone)
        if m % 8 == 0:         # B6's function on both sides: exact
            np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
        else:
            assert_contract(got.numpy(), np.asarray(jgot))


def test_w4_wrappers_check_operands():
    c = _w4a8_case(8, 256, 64, 128)
    ops = TW.w4a8_operands(torch.tensor(c["packed"]),
                           torch.tensor(c["scales"]), torch.tensor(c["zpb"]),
                           256, 128, zp_x=c["zp_x"], mult=float(c["mult"]))
    with pytest.raises(TypeError, match="u8"):
        TW.w4a8_v2(torch.zeros((8, 256)), ops)
    with pytest.raises(ValueError, match="shapes"):
        TW.w4a8_v1(torch.zeros((8, 128), dtype=torch.uint8), ops)
    with pytest.raises(ValueError, match="w4_kernel"):
        TW.w4a8_apply(torch.tensor(c["x"]), ops, backend="triton")


# -- the kernels on the card ---------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,group,vec", V2_SHAPES)
def test_b6_kernel_matches_plain_on_card(cuda_device, m, k, n, group, vec):
    c = _w4a8_case(m, k, n, group, seed=m + n, vector_mult=vec)
    mult = torch.tensor(c["mult"]) if vec else float(c["mult"])
    ops = TW.w4a8_operands(*(torch.tensor(c[key]).to(cuda_device)
                             for key in ("packed", "scales", "zpb")),
                           k, group, zp_x=c["zp_x"],
                           mult=mult.to(cuda_device) if vec else mult,
                           wsum=torch.tensor(c["wsum"]).to(cuda_device))
    x = torch.tensor(c["x"]).to(cuda_device)
    for rounding in ("trunc", "nearest"):
        before = TW.w4a8_v2.launches
        got = TW.w4a8_v2(x, ops, rounding)
        assert TW.w4a8_v2.launches == before + 1
        want = TW.w4a8_v2_plain(x, ops["packed"], ops["scales_t"],
                                ops["mult_v"], ops["zpb_eff"], k, group,
                                rounding)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


# B7's and B5's edge shapes on the card: a group off the k-step and smaller
# than K, several groups in one chunk, M = 1
EDGE_SHAPES = [(16, 96, 40, 48), (3, 40, 24, 10), (1, 768, 1024, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,group", V1_SHAPES + EDGE_SHAPES)
def test_b7_kernel_matches_plain_on_card(cuda_device, m, k, n, group):
    c = _w4a8_case(m, k, n, group, seed=m, vector_mult=True)
    ops = TW.w4a8_operands(*(torch.tensor(c[key]).to(cuda_device)
                             for key in ("packed", "scales", "zpb")),
                           k, group, zp_x=c["zp_x"],
                           mult=torch.tensor(c["mult"]).to(cuda_device))
    x = torch.tensor(c["x"]).to(cuda_device)
    for rounding in ("trunc", "nearest"):
        got = TW.w4a8_v1(x, ops, rounding)
        want = TW.w4a8_v1_plain(x, ops["packed"], ops["scales"], ops["zpb"],
                                k, group, zp_x=c["zp_x"], mult=ops["mult_v"],
                                rounding=rounding)
        exact = TW.w4a8_v2_plain(x, ops["packed"], ops["scales_t"],
                                 ops["mult_v"], ops["zpb_eff"], k, group,
                                 rounding)
        torch.cuda.synchronize()
        assert torch.equal(got, exact)
        assert_contract(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,group", [(8, 256, 96, 64), (37, 200, 61, 128),
                                         (512, 768, 2048, 128)]
                         + EDGE_SHAPES)
def test_b5_kernel_matches_plain_on_card(cuda_device, m, k, n, group):
    x, bias, packed, scales = _b5_case(m, k, n, group)
    args = [torch.tensor(a).to(cuda_device) for a in (x, packed, scales,
                                                      bias)]
    args = (args[0], args[1], args[2], args[3], k, group)
    got = TW.w4_gemm(*args)
    want = TW.w4_gemm_plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= 2e-5, err


# -- B6's plan and its K split --------------------------------------------------

# (M, K, N, group) -> (tile, slices): the five llama decode shapes, then B6's
# envelope edges (M = 8, 16, 128; K = 768 and 2,048; group 128 and 256)
PLANS = [((8, 768, 1024, 256), ((16, 64), 1)),
         ((8, 768, 768, 256), ((16, 64), 1)),
         ((8, 768, 4096, 256), ((16, 64), 1)),
         ((8, 2048, 768, 256), ((16, 64), 8)),
         ((8, 768, 32000, 256), ((16, 64), 1)),
         ((16, 768, 768, 128), ((16, 64), 1)),
         ((16, 2048, 4096, 256), ((16, 64), 4)),
         ((128, 768, 768, 256), ((16, 64), 1)),
         ((128, 2048, 768, 128), ((16, 64), 2)),
         ((8, 2048, 32000, 128), ((16, 64), 1))]


@pytest.mark.parametrize("shape,want", PLANS)
def test_plan_w4a8_v2_is_pinned_and_runnable(shape, want):
    m, k, n, group = shape
    plan = TW.plan_w4a8_v2(m, n, k, group)
    assert (plan.tile, plan.slices) == want
    assert plan.orientation == "swapped"
    assert plan.tile == (16, 64)
    # at most 8 slices of whole groups or of whole fractions of one
    assert 1 <= plan.slices <= 8 and plan.k_slice * plan.slices == k
    assert plan.k_slice % 32 == 0
    assert group % plan.k_slice == 0 or plan.k_slice % group == 0
    assert TW.v2_smem_bytes(plan, group) <= 227 * 1024
    TW.check_w4a8_plan(plan, m, n, k, group)
    for s in TW.v2_slice_counts(k, group):
        TW.check_w4a8_plan(plan._replace(slices=s, k_slice=k // s), m, n, k,
                           group)


def test_w4a8_plan_refusals():
    plan = TW.plan_w4a8_v2(8, 768, 768, 256)
    for bad in (plan._replace(slices=8, k_slice=96),      # 96 splits a group
                plan._replace(slices=2, k_slice=384),
                plan._replace(tile=(8, 64)),
                plan._replace(orientation="direct")):
        with pytest.raises(ValueError, match="cannot run"):
            TW.check_w4a8_plan(bad, 8, 768, 768, 256)
    with pytest.raises(ValueError, match="envelope"):
        TW.plan_w4a8_v2(8, 768, 700, 256)
    with pytest.raises(ValueError, match="no B6 split"):
        c = _w4a8_case(8, 256, 16, 128)
        TW.w4a8_v2_split_plain(torch.tensor(c["x"]), None, None, None, None,
                               256, 128, slices=3)


@pytest.mark.parametrize("m,k,n,group,vec", [(8, 768, 96, 256, True),
                                             (16, 2048, 40, 256, False),
                                             (24, 256, 70, 32, True),
                                             (8, 512, 33, 128, False)])
def test_b6_split_plain_equals_plain_at_every_split(m, k, n, group, vec):
    """The plain twin of B6's K split (per-slice s32 partials, added per
    group, folded in group order) equals ``w4a8_v2_plain`` bit for bit at
    every split the kernel runs."""
    c = _w4a8_case(m, k, n, group, seed=m + k, vector_mult=vec)
    mult = torch.tensor(c["mult"]) if vec else float(c["mult"])
    ops = TW.w4a8_operands(torch.tensor(c["packed"]),
                           torch.tensor(c["scales"]), torch.tensor(c["zpb"]),
                           k, group, zp_x=c["zp_x"], mult=mult,
                           wsum=torch.tensor(c["wsum"]))
    x = torch.tensor(c["x"])
    args = (x, ops["packed"], ops["scales_t"], ops["mult_v"], ops["zpb_eff"],
            k, group)
    for rounding in ("trunc", "nearest"):
        want = TW.w4a8_v2_plain(*args, rounding)
        assert len(torch.unique(want)) > 16
        for s in TW.v2_slice_counts(k, group):
            got = TW.w4a8_v2_split_plain(*args, rounding, slices=s)
            assert torch.equal(got, want), (s, rounding)


@pytest.mark.parametrize("m,k,n,group,slices", [(8, 768, 96, 256, 6),
                                                (16, 512, 64, 128, 8)])
def test_b6_split_plain_matches_pallas_v2(m, k, n, group, slices):
    """Through ``w4a8_v2_plain``, the split twin equals the JAX package's
    ``_w4a8_kernel_v2`` (interpret mode) bit for bit."""
    c = _w4a8_case(m, k, n, group, seed=k + slices, vector_mult=True)
    want = _jax(JW.w4a8_matmul_pallas, c, "nearest", wsum=c["wsum"],
                interpret=True)
    ops = TW.w4a8_operands(torch.tensor(c["packed"]),
                           torch.tensor(c["scales"]), torch.tensor(c["zpb"]),
                           k, group, zp_x=c["zp_x"],
                           mult=torch.tensor(c["mult"]),
                           wsum=torch.tensor(c["wsum"]))
    got = TW.w4a8_v2_split_plain(torch.tensor(c["x"]), ops["packed"],
                                 ops["scales_t"], ops["mult_v"],
                                 ops["zpb_eff"], k, group, "nearest",
                                 slices=slices)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,group", [(8, 768, 1024, 256),
                                         (8, 2048, 768, 256),
                                         (64, 768, 768, 128),
                                         (24, 256, 70, 32)])
def test_b6_kernel_equals_plain_at_every_split_on_card(cuda_device, m, k, n,
                                                       group):
    c = _w4a8_case(m, k, n, group, seed=m + k, vector_mult=True)
    ops = TW.w4a8_operands(*(torch.tensor(c[key]).to(cuda_device)
                             for key in ("packed", "scales", "zpb")),
                           k, group, zp_x=c["zp_x"],
                           mult=torch.tensor(c["mult"]).to(cuda_device))
    x = torch.tensor(c["x"]).to(cuda_device)
    chosen = TW.plan_w4a8_v2(m, n, k, group)
    for s in TW.v2_slice_counts(k, group):
        plan = chosen._replace(slices=s, k_slice=k // s)
        for rounding in ("trunc", "nearest"):
            got = TW.w4a8_v2(x, ops, rounding, plan=plan)
            want = TW.w4a8_v2_plain(x, ops["packed"], ops["scales_t"],
                                    ops["mult_v"], ops["zpb_eff"], k, group,
                                    rounding)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (plan, rounding)
