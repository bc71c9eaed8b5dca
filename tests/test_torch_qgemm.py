"""PyTorch port vs JAX package: the quantized GEMM.

``qgemm_plain`` (the plain version of the port's CUDA kernel) against the
JAX package's ``qgemm_xla`` and its Pallas kernel ``qgemm_pallas`` run in
TPU interpret mode on the CPU, bit-exact, over ragged M/N/K, relu, both
roundings and per-channel weight scales; the conv epilogue order against
``down_scale``.  The kernel itself is compared with ``qgemm_plain`` on the
card by the ``cuda``-marked test (and by chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from int8inferenceengine_tpu.ops import gemm_int8 as JG
from int8inferenceengine_tpu.ops.quant import down_scale
from int8inferenceengine_tpu_torch.ops import gemm_int8 as TG
from test_torch_threads import one_torch_thread  # noqa: F401

SHAPES = [(7, 33, 5), (16, 32, 8), (100, 363, 96), (129, 48, 130),
          (1, 16, 1)]
S_A, ZP_A, ZP_C = 0.02, 131, 101


def _case(m, k, n, seed=0):
    rng = np.random.default_rng(seed + m * 7 + k * 13 + n)
    a = rng.integers(0, 256, (m, k)).astype(np.uint8)
    w_nk = rng.integers(-127, 128, (n, k)).astype(np.int8)
    qb = rng.integers(-127, 128, (n,)).astype(np.int8)
    s_w_pc = rng.uniform(0.005, 0.02, n).astype(np.float32)
    # output scale that spreads the codes over the whole u8 range
    s_c = float(np.float32(S_A * 0.01 * 74 * 74 * np.sqrt(k) / 60))
    return a, w_nk, qb, s_w_pc, s_c


def _both(m, k, n, per_channel, order="gemm"):
    """Operands for both packages plus the shared epilogue arguments."""
    a, w_nk, qb, s_w_pc, s_c = _case(m, k, n)
    rowsum = w_nk.astype(np.int32).sum(axis=1)
    oc_j = JG.compute_offset(jnp.asarray(qb), jnp.asarray(rowsum),
                             scale_a=S_A, zp_a=ZP_A, recentered=True)
    oc_t = TG.compute_offset(torch.tensor(qb), torch.tensor(rowsum), S_A,
                             ZP_A, recentered=True)
    np.testing.assert_array_equal(oc_t.numpy(), np.asarray(oc_j))
    s_w = s_w_pc if per_channel else 0.0113
    ep = TG.epilogue_vector(S_A, torch.tensor(s_w) if per_channel else s_w,
                            s_c, n, "cpu", order)
    jax_args = (jnp.asarray(a), jnp.asarray(w_nk.T), oc_j)
    jax_kw = dict(scale_a=S_A, zp_a=ZP_A, scale_c=s_c, zp_c=ZP_C,
                  scale_w=jnp.asarray(s_w) if per_channel else s_w)
    torch_args = (torch.tensor(a), torch.tensor(w_nk), oc_t, ep)
    torch_kw = dict(scale_a=S_A, scale_c=s_c, zp_c=ZP_C, order=order)
    return jax_args, jax_kw, torch_args, torch_kw, s_w


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("rounding", ["trunc", "nearest"])
@pytest.mark.parametrize("relu", [False, True])
def test_plain_matches_qgemm_xla(m, k, n, per_channel, rounding, relu):
    ja, jkw, ta, tkw, _ = _both(m, k, n, per_channel)
    want = np.asarray(JG.qgemm_xla(*ja, relu=relu, rounding=rounding, **jkw))
    got = TG.qgemm_plain(*ta, relu=relu, rounding=rounding, **tkw).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > min(8, want.size // 2)   # not all clipped


@pytest.mark.parametrize("m,k,n", [(100, 363, 96), (129, 48, 130)])
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("relu,rounding", [(False, "trunc"),
                                           (True, "nearest")])
def test_plain_matches_pallas_interpret(m, k, n, per_channel, relu, rounding):
    ja, jkw, ta, tkw, _ = _both(m, k, n, per_channel)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JG.qgemm_pallas(*ja, relu=relu, rounding=rounding,
                                          **jkw))
    got = TG.qgemm_plain(*ta, relu=relu, rounding=rounding, **tkw).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m,k,n", [(7, 33, 5), (100, 363, 96)])
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("rounding", ["trunc", "nearest"])
@pytest.mark.parametrize("relu", [False, True])
def test_conv_order_matches_down_scale(m, k, n, per_channel, rounding, relu):
    ja, jkw, ta, tkw, s_w = _both(m, k, n, per_channel, order="conv")
    a, w_nk = ja[0], ja[1]
    acc = (np.asarray(a).astype(np.int64) - 128) @ np.asarray(w_nk).astype(
        np.int64) + np.asarray(ja[2])
    want = np.asarray(down_scale(jnp.asarray(acc.astype(np.int32)), S_A,
                                 jnp.asarray(s_w), jkw["scale_c"], ZP_C,
                                 rounding=rounding))
    if relu:
        want = np.maximum(want, np.uint8(ZP_C))
    got = TG.qgemm_plain(*ta, relu=relu, rounding=rounding, **tkw).numpy()
    np.testing.assert_array_equal(got, want)


def test_wrapper_takes_plain_version_on_cpu_without_counting():
    _, _, ta, tkw, _ = _both(100, 363, 96, per_channel=True)
    before = TG.qgemm.launches
    got = TG.qgemm(*ta, relu=True, **tkw)
    assert TG.qgemm.launches == before
    assert torch.equal(got, TG.qgemm_plain(*ta, relu=True, **tkw))


def test_wrapper_rejects_bad_operands():
    _, _, (a, w, oc, ep), tkw, _ = _both(16, 32, 8, per_channel=False)
    with pytest.raises(TypeError, match="uint8"):
        TG.qgemm(a.to(torch.int8), w, oc, ep, **tkw)
    with pytest.raises(ValueError, match="shapes"):
        TG.qgemm(a[:, :16], w, oc, ep, **tkw)
    with pytest.raises(ValueError, match="oc must be int32"):
        TG.qgemm(a, w, oc.to(torch.int64), ep, **tkw)
    with pytest.raises(ValueError, match="unknown epilogue order"):
        TG.qgemm(a, w, oc, ep, **dict(tkw, order="fma"))


# (M, N, K, split): the AlexNet batch-100 GEMMs (convs as their patch
# GEMMs), the gpt2-small-ish decode (M = 8) and prefill (M = 512) shapes,
# and ragged ones; ``split`` whether the plan cuts K on an H100
PLAN_SHAPES = [
    (302_500, 96, 363, False), (72_900, 256, 2_400, False),
    (16_900, 384, 2_304, False), (16_900, 384, 3_456, False),
    (16_900, 256, 3_456, False),
    (100, 4_096, 9_216, True), (100, 4_096, 4_096, True),
    (100, 10, 4_096, True),
    (8, 768, 768, True), (8, 3_072, 768, True), (8, 768, 3_072, True),
    (8, 50_257, 768, False), (8, 2_304, 768, True), (1, 10, 4_096, True),
    (16, 4_096, 9_216, True), (512, 2_304, 768, False), (512, 768, 768, True),
    (7, 5, 1_000, True), (7, 5, 33, False), (1, 1, 16, False),
    (1000, 1, 64, False)]


@pytest.mark.parametrize("m,n,k,split", PLAN_SHAPES)
def test_plan_slices_cover_k(m, n, k, split):
    plan = TG.plan_qgemm(m, n, k)
    bm, bn = plan.tile
    tiles = -(-m // bm) * -(-n // bn)
    assert plan.variant == "gemm" and plan.tile in TG.QGEMM_TILES
    narrow = m <= 16 or -(-m // 64) * -(-n // 64) * 8 < TG.H100_SMS
    assert (plan.tile == (16, 64)) == narrow
    assert (plan.tile == (128, 128)) == (not narrow and -(-m // 128) *
                                         -(-n // 128) >= TG.H100_SMS)
    assert plan.loader == ("cp.async" if k % 16 == 0 else
                           "word" if k % 4 == 0 else "byte")
    assert 1 <= plan.slices <= TG.QGEMM_MAX_SLICES
    assert (plan.slices > 1) == split
    if plan.slices == 1:
        assert plan.k_slice == k
    else:
        # every slice a whole number of k-steps, none empty or short, K
        # covered once
        assert plan.k_slice % TG.QGEMM_KSTEP == 0
        assert plan.k_slice >= TG.QGEMM_MIN_SLICE
        assert (plan.slices - 1) * plan.k_slice < k
        assert k <= plan.slices * plan.k_slice
        assert tiles < TG.H100_SMS and tiles * plan.slices <= 2 * TG.H100_SMS


@pytest.mark.parametrize("m,n,k", [(7, 5, 1000), (8, 24, 768),
                                   (100, 10, 4096)])
def test_split_partials_sum_to_the_whole(m, n, k):
    """The s32 partials of the plan's K slices add (wrapping) to the whole
    accumulator, so a split launch gives the unsplit codes."""
    _, _, (a, w, oc, ep), tkw, _ = _both(m, k, n, per_channel=True)
    plan = TG.plan_qgemm(m, n, k)
    assert plan.slices > 1
    step = plan.k_slice
    parts = [TG._accumulate(a[:, s:s + step], w[:, s:s + step])
             for s in range(0, k, step)]
    assert len(parts) == plan.slices
    whole = TG._accumulate(a, w)
    assert torch.equal(sum(p.to(torch.int64) for p in parts).to(torch.int32),
                       whole)
    assert torch.equal(
        TG._requant_epilogue(sum(parts) + oc.reshape(1, -1), ep, **tkw),
        TG.qgemm_plain(a, w, oc, ep, **tkw))


def test_plan_rejects_an_empty_gemm():
    with pytest.raises(ValueError, match="empty"):
        TG.plan_qgemm(0, 8, 16)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("order", TG.DENSE_ORDERS)
def test_kernel_matches_plain_on_card(cuda_device, order):
    for m, k, n in SHAPES + [(302, 2400, 256)]:
        _, _, ta, tkw, _ = _both(m, k, n, per_channel=True, order=order)
        ta = tuple(t.to(cuda_device) for t in ta)
        for rounding in ("trunc", "nearest"):
            for relu in (False, True):
                before = TG.qgemm.launches
                got = TG.qgemm(*ta, relu=relu, rounding=rounding, **tkw)
                want = TG.qgemm_plain(*ta, relu=relu, rounding=rounding,
                                      **tkw)
                torch.cuda.synchronize()
                assert TG.qgemm.launches == before + 1
                assert torch.equal(got, want), (m, k, n, rounding, relu)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 4096, 10), (8, 3072, 768),
                                   (16, 1000, 96), (100, 4096, 10)])
def test_split_kernel_matches_plain_on_card(cuda_device, m, k, n):
    """The narrow tiles and the K split (a thread block cluster), in every
    epilogue: requant with relu, the act epilogue and B2's per-column zero
    point."""
    assert TG.plan_qgemm(m, n, k).slices > 1
    _, _, ta, tkw, _ = _both(m, k, n, per_channel=True)
    a, w, oc, ep = (t.to(cuda_device) for t in ta)
    for kw in (dict(relu=True, rounding="nearest"),
               dict(act=("gelu", 5.17 / 255, 8))):
        got = TG.qgemm(a, w, oc, ep, **tkw, **kw)
        want = TG.qgemm_plain(a, w, oc, ep, **tkw, **kw)
        torch.cuda.synchronize()
        d = (got.to(torch.int32) - want.to(torch.int32)).abs()
        assert int(d.max()) <= (1 if "act" in kw else 0)
        assert float((d > 0).float().mean()) <= 0.002
    merged = TG.merge_parts(
        [dict(w_s8_nk=w, oc=oc, scale_w=0.01, scale_c=tkw["scale_c"],
              zp_c=100),
         dict(w_s8_nk=w, oc=oc, scale_w=0.013, scale_c=tkw["scale_c"],
              zp_c=120)], scale_a=S_A, zp_a=ZP_A)
    before = TG.qgemm_multi.launches
    got = torch.cat(TG.qgemm_multi(a, merged, rounding="nearest"), 1)
    want = torch.cat(TG.qgemm_multi_plain(a, merged, rounding="nearest"), 1)
    torch.cuda.synchronize()
    assert TG.qgemm_multi.launches == before + 1
    assert torch.equal(got, want)
