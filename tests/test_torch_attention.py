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
ULP between libms).  The ``cuda``-marked test holds the CUDA kernel against
the plain version on the card; it skips without one.
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


# -- the kernel on the card ---------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,kv,d,mq,window,softcap", CASES + [
    (8, 512, 12, 12, 64, 1, None, None), (8, 512, 12, 2, 64, 4, 128, 30.0)])
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
