"""PyTorch port vs JAX package: cached-decode attention on the flat cache.

The port's ``decode_attention_flat`` on CPU tensors (its plain version,
``decode_attention_xla``) against the JAX package's
``decode_attention_flat`` on the same numpy inputs:

* ``backend='xla'`` (the composed oracle) over MHA, GQA, multi-position
  queries, a sliding window, a softcap, scalar and per-sequence ``valid``
  and both roundings;
* at one shape (T = 64) its Pallas kernel, merged and block-walk revisions,
  in TPU interpret mode.

Both within the repo's contract: at most one code off on at most 0.2% of
the outputs (the softmax sums in another order, and ``exp`` differs by an
ULP between libms).  The kernel's plan (``plan_decode_attn``) is pinned at
the decoders' shapes, and the plain twin of its split over T
(``decode_attention_split_plain``) equals the composed version bit for bit
at every split count.  The ``cuda``-marked tests hold the CUDA kernel
against the plain version on the card; they skip without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from int8inferenceengine_tpu.ops import attention as JA
from int8inferenceengine_tpu_torch.ops import attention as TA
from test_torch_threads import one_torch_thread  # noqa: F401

PARAMS = dict(scale_q=0.021, zp_q=117, scale_k=0.034, zp_k=131,
              scale_v=0.027, zp_v=125, scale_s=0.19, zp_s=140,
              scale_p=0.0039, zp_p=0, scale_c=0.05, zp_c=128)


def assert_contract(got, want, what=""):
    d = np.abs(np.asarray(got).astype(np.int32)
               - np.asarray(want).astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 0.002, (
        what, int(d.max()), float((d > 0).mean()))


def _case(b, t, h, kv, d, mq, seed):
    rng = np.random.default_rng(seed)
    qshape = (b, mq, h * d) if mq > 1 else (b, h * d)
    q = rng.integers(0, 256, qshape).astype(np.uint8)
    k = rng.integers(0, 256, (b, t, kv * d)).astype(np.uint8)
    v = rng.integers(0, 256, (b, t, kv * d)).astype(np.uint8)
    return q, k, v


CASES = [
    # (b, t, heads, kv heads, head dim, mq, window, softcap)
    (3, 64, 4, 4, 16, 1, None, None),
    (2, 96, 4, 2, 32, 1, None, None),
    (2, 64, 6, 2, 16, 3, None, None),
    (2, 128, 4, 4, 16, 1, 40, None),
    (2, 64, 2, 2, 64, 1, None, 2.5),
]


@pytest.mark.parametrize("b,t,h,kv,d,mq,window,softcap", CASES)
@pytest.mark.parametrize("rounding", ["trunc", "nearest"])
def test_plain_matches_jax_xla(b, t, h, kv, d, mq, window, softcap,
                               rounding):
    q, k, v = _case(b, t, h, kv, d, mq, seed=t + h + kv + mq)
    kw = dict(PARAMS, alpha=d ** -0.5, rounding=rounding, n_heads=h,
              n_kv_heads=kv, window=window, softcap=softcap)
    per_seq = np.random.default_rng(1).integers(1, t - mq + 2, (b,))
    for valid in (1, 7, t - mq + 1, per_seq.astype(np.int32)):
        want = np.asarray(JA.decode_attention_flat(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(valid, jnp.int32), backend="xla", **kw))
        got = TA.decode_attention_flat(
            torch.tensor(q), torch.tensor(k), torch.tensor(v),
            torch.tensor(np.asarray(valid, np.int32)), **kw)
        assert got.shape == q.shape
        assert len(np.unique(want)) > 16
        assert_contract(got.numpy(), want, valid)


@pytest.mark.parametrize("merged", [True, False])
def test_plain_matches_jax_pallas_interpret(merged):
    b, t, h, d = 2, 64, 4, 16
    q, k, v = _case(b, t, h, h, d, 1, seed=11)
    kw = dict(PARAMS, alpha=d ** -0.5, rounding="trunc", n_heads=h)
    valid = np.array([9, 64], np.int32)
    want = np.asarray(JA.decode_attention_flat(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid),
        backend="pallas", interpret=True, merged=merged, **kw))
    got = TA.decode_attention_flat(torch.tensor(q), torch.tensor(k),
                                   torch.tensor(v), torch.tensor(valid),
                                   merged=merged, **kw)
    assert_contract(got.numpy(), want)


def test_softmax_denominator_ignores_add_order():
    """The denominator is the correctly rounded float32 sum of the exps, so
    permuting the columns permutes the probabilities bit for bit (the
    decode kernel adds in its own order and must land on the same sum)."""
    rng = np.random.default_rng(8)
    # coarse score grids, as dequantized codes are: many equal exps
    f = torch.tensor((rng.integers(-40, 40, (64, 191)) * 0.0113)
                     .astype(np.float32))
    p = TA.softmax_last(f)
    perm = torch.tensor(rng.permutation(191))
    assert torch.equal(TA.softmax_last(f[:, perm]), p[:, perm])
    assert torch.equal(TA.softmax_last(f.flip(-1)), p.flip(-1))


def test_scalar_valid_forms_agree_and_cpu_launches_nothing():
    q, k, v = (torch.tensor(x) for x in _case(2, 64, 4, 4, 16, 1, seed=3))
    kw = dict(PARAMS, alpha=0.25, n_heads=4)
    before = TA.decode_attention_flat.launches
    outs = [TA.decode_attention_flat(q, k, v, valid, **kw)
            for valid in (30, torch.tensor(30), torch.tensor([30, 30]))]
    outs.append(TA.decode_attention_flat(q, k, v, 30, backend="xla", **kw))
    assert TA.decode_attention_flat.launches == before
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_rejects_what_it_does_not_take():
    q, k, v = (torch.tensor(x) for x in _case(2, 64, 4, 4, 16, 1, seed=3))
    kw = dict(PARAMS, alpha=0.25, n_heads=4)
    with pytest.raises(NotImplementedError, match="ALiBi"):
        TA.decode_attention_flat(q, k, v, 5, alibi=(0.5,) * 4, **kw)
    with pytest.raises(ValueError, match="backend"):
        TA.decode_attention_flat(q, k, v, 5, backend="triton", **kw)
    with pytest.raises(ValueError, match="kv heads"):
        TA.decode_attention_flat(q, k, v, 5, **dict(kw, n_kv_heads=3))
    with pytest.raises(ValueError, match="valid"):
        TA.decode_attention_flat(q, k, v, torch.tensor([1, 2, 3]), **kw)


# -- the kernel's plan and its split over T --------------------------------------

# (B, T, H, Hkv, D, mq) -> splits: gpt2's and llama's B3, then a shape the
# kernel refused before the split (24 query rows over T = 4096)
ATTN_PLANS = [((8, 512, 12, 12, 64, 1), 1), ((8, 512, 12, 2, 64, 1), 8),
              ((8, 4096, 12, 2, 64, 4), 8), ((8, 4096, 12, 12, 64, 1), 8),
              ((1, 4096, 32, 8, 128, 8), 8)]


@pytest.mark.parametrize("shape,splits", ATTN_PLANS)
def test_plan_decode_attn_is_pinned(shape, splits):
    b, t, h, kv, d, mq = shape
    plan = TA.plan_decode_attn(b, t, h, kv, d, mq)
    assert plan.splits == splits and 1 <= plan.splits <= TA.MAX_SPLITS
    assert plan.share == -(-t // plan.splits)
    # the scores of one share, not of all of T
    assert plan.smem <= 227 * 1024
    assert plan == TA.decode_attn_plan(plan.splits, mq * (h // kv), t, d)


def test_plan_decode_attn_refuses_what_no_split_fits():
    with pytest.raises(ValueError, match="shared memory"):
        TA.plan_decode_attn(1, 65536, 32, 1, 64, 8)


# (b, t, heads, kv heads, head dim, mq, window, softcap)
SPLIT_CASES = [(3, 64, 4, 4, 16, 1, None, None),
               (2, 96, 6, 2, 16, 4, None, None),
               (2, 128, 4, 2, 32, 1, 40, 2.5)]


@pytest.mark.parametrize("b,t,h,kv,d,mq,window,softcap", SPLIT_CASES)
@pytest.mark.parametrize("splits", range(1, 9))
def test_split_plain_equals_composed(b, t, h, kv, d, mq, window, softcap,
                                     splits):
    """The plain twin of the kernel's split over T (per-split max, float64
    partial sums added in split order, int32 P@V partials) equals the
    composed version bit for bit, splits whose share is empty included
    (live length 1, short per-sequence lengths)."""
    q, k, v = (torch.tensor(x) for x in _case(b, t, h, kv, d, mq, seed=t + h))
    per_seq = np.random.default_rng(2).integers(1, t - mq + 2, (b,))
    per_seq[0] = 1
    for rounding in ("trunc", "nearest"):
        kw = dict(PARAMS, alpha=d ** -0.5, rounding=rounding, n_heads=h,
                  n_kv_heads=kv, window=window, softcap=softcap)
        for valid in (1, 7, t - mq + 1,
                      torch.tensor(per_seq, dtype=torch.int32)):
            want = TA.decode_attention_flat(q, k, v, valid, **kw)
            got = TA.decode_attention_split_plain(q, k, v, valid,
                                                  splits=splits, **kw)
            assert torch.equal(got, want), (valid, rounding)


@pytest.mark.parametrize("b,t,h,kv,d,mq,window,softcap", SPLIT_CASES)
def test_split_plain_matches_jax_xla(b, t, h, kv, d, mq, window, softcap):
    q, k, v = _case(b, t, h, kv, d, mq, seed=t + kv)
    kw = dict(PARAMS, alpha=d ** -0.5, rounding="nearest", n_heads=h,
              n_kv_heads=kv, window=window, softcap=softcap)
    valid = np.random.default_rng(3).integers(1, t - mq + 2, (b,)).astype(
        np.int32)
    want = np.asarray(JA.decode_attention_flat(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid),
        backend="xla", **kw))
    got = TA.decode_attention_split_plain(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        torch.tensor(valid), splits=8, **kw)
    assert len(np.unique(want)) > 16
    np.testing.assert_array_equal(got.numpy(), want)


def test_split_bounds_cover_the_span_once():
    valid = torch.tensor([1, 50, 100], dtype=torch.int32)
    sid = TA.split_bounds(valid, 128, 3, None, 8)
    for row, v in zip(sid, (1, 50, 100)):
        live = row[row >= 0]
        assert live.numel() == v + 2                     # [0, valid + mq - 1)
        assert torch.equal(live, torch.sort(live).values)
        assert int(live.max()) < 8


# -- the kernel on the card ---------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,kv,d,mq,window,softcap", CASES + [
    (8, 512, 12, 12, 64, 1, None, None), (8, 512, 12, 2, 64, 4, 128, 30.0),
    (8, 4096, 12, 2, 64, 4, None, None)])
def test_kernel_matches_plain_on_card(cuda_device, b, t, h, kv, d, mq,
                                      window, softcap):
    q, k, v = (torch.tensor(x).to(cuda_device)
               for x in _case(b, t, h, kv, d, mq, seed=5))
    kw = dict(PARAMS, alpha=d ** -0.5, n_heads=h, n_kv_heads=kv,
              window=window, softcap=softcap)
    per_seq = torch.randint(1, t - mq + 2, (b,), dtype=torch.int32,
                            device=cuda_device)
    for valid in (1, 77 % (t - mq) + 1, t - mq + 1, per_seq):
        for rounding in ("trunc", "nearest"):
            before = TA.decode_attention_flat.launches
            got = TA.decode_attention_flat(q, k, v, valid, rounding=rounding,
                                           **kw)
            want = TA.decode_attention_flat(q, k, v, valid, backend="xla",
                                            rounding=rounding, **kw)
            torch.cuda.synchronize()
            assert TA.decode_attention_flat.launches == before + 1
            assert_contract(got.cpu(), want.cpu(), (valid, rounding))


@pytest.mark.cuda
@pytest.mark.parametrize("splits", range(1, 9))
def test_kernel_matches_plain_at_every_split_on_card(cuda_device, splits):
    b, t, h, kv, d, mq = 8, 512, 12, 2, 64, 4
    q, k, v = (torch.tensor(x).to(cuda_device)
               for x in _case(b, t, h, kv, d, mq, seed=7))
    kw = dict(PARAMS, alpha=d ** -0.5, n_heads=h, n_kv_heads=kv, window=200,
              softcap=30.0)
    plan = TA.decode_attn_plan(splits, mq * h // kv, t, d)
    per_seq = torch.randint(1, t - mq + 2, (b,), dtype=torch.int32,
                            device=cuda_device)
    for valid in (1, 77, t - mq + 1, per_seq):
        got = TA.decode_attention_flat(q, k, v, valid, plan=plan, **kw)
        want = TA.decode_attention_flat(q, k, v, valid, backend="xla", **kw)
        torch.cuda.synchronize()
        assert_contract(got.cpu(), want.cpu(), (splits, valid))
