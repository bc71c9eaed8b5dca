"""PyTorch port vs JAX package: the cached multi-token extend.

* ``TextDecoder._extend_step`` (gpt) and ``LlamaDecoder._block_extend``
  (llama, W8A8) on the JAX package's converted state carried over, from
  the JAX package's own prefill cache: the logit codes and the written
  cache rows against JAX ``_extend_step``'s, at scalar and per-row
  positions and m = 1 and 4; exact for gpt, within the repo's contract for
  llama (at most one code off on at most 0.2%: RoPE's cos/sin and the
  norms' reductions differ by an ULP between the frameworks).
* The port's extend against m of its own decode steps: codes and caches
  equal, for both families, with the fused and the composed attention.
* A start past ``max_len - m`` is clamped: no raise, no write outside the
  cache.  A ring cache is refused.
* B3 over query-row tiles: ``plan_decode_attn`` covers every extend shape
  up to mq = 128 and T = 4,096 (GQA 12/2 included) within 227 KB, equals
  the one-tile plan of the split rule wherever that fits, and the plain
  twin of the row tiling (``decode_attention_split_plain(mq_tile=)``)
  equals the composed version bit for bit at every tiling.  The
  ``cuda``-marked tests hold the kernel to it on the card at every tiling;
  they skip without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import int8inferenceengine_tpu as qj
from int8inferenceengine_tpu.models import zoo as jzoo
from int8inferenceengine_tpu.models.llama import torch_llama as j_torch_llama
from int8inferenceengine_tpu.models.text_decoder import \
    torch_text_decoder as j_torch_text_decoder
from int8inferenceengine_tpu.tensor import Tensor as JT
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch.carry import load_jax_state
from int8inferenceengine_tpu_torch.models import zoo as tzoo
from int8inferenceengine_tpu_torch.ops import attention as TA
from test_torch_attention import PARAMS, _case
from test_torch_llama import assert_contract
from test_torch_text_decoder import jax_state
from test_torch_threads import one_torch_thread  # noqa: F401

VOCAB = 128
GPT = dict(vocab_size=VOCAB, max_len=48, dim=64, depth=2, heads=4)
LLAMA = dict(vocab_size=VOCAB, max_len=48, dim=64, depth=2, heads=4,
             kv_heads=2)
T0, M = 9, 4                       # prompt length, extend rows


def _ids(b, t, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, t)).astype(
        np.int32)


def _jax_decoder(family):
    """A converted JAX decoder of ``family`` and the geometry it has."""
    if family == "gpt":
        geo, twin = GPT, j_torch_text_decoder
        m = jzoo.build("gpt_tiny", **geo)
    else:
        geo, twin = LLAMA, j_torch_llama
        m = jzoo.build("llama_tiny", **geo)
    m.load(twin(**geo).state_dict())
    m.prepare()
    m(qj.tensor(_ids(8, geo["max_len"], 1)))
    m.convert()
    return m, geo


@pytest.fixture(scope="module", params=["gpt", "llama"])
def ref(request):
    """Per family: the JAX decoder's converted state, its prefill cache of
    a 3 x 9 prompt, and its extends of 4 and of 1 rows from that cache at
    a scalar and at a per-row position."""
    family = request.param
    jm, geo = _jax_decoder(family)
    prompt, toks = _ids(3, T0, 5), _ids(3, M, 6)

    # the llama's extends run eagerly: under jit XLA:CPU contracts a*b+c
    # into an FMA (RoPE's rotation), which moves ~10% of its codes by one
    # from the eager reference the contract is set against
    extend = jm._extend_step if family == "llama" else jax.jit(
        jm._extend_step)
    with pltpu.force_tpu_interpret_mode():
        cache = jax.jit(lambda p: jm._prefill(JT(p.astype(jnp.float32)))[1])(
            jnp.asarray(prompt))
        ext = {}
        for m in (1, M):
            for per_row in (False, True):
                pos = (jnp.asarray([T0, T0 - 2, T0 - 5], jnp.int32)
                       if per_row else jnp.int32(T0))
                ext[m, per_row] = extend(cache, pos, jnp.asarray(toks[:, :m]))

    def host(c):
        return {i: (np.asarray(k), np.asarray(v)) for i, (k, v) in c.items()}

    return dict(family=family, geo=geo, state=jax_state(jm), toks=toks,
                cache=host(cache),
                ext={key: (np.asarray(codes), host(new))
                     for key, (codes, new) in ext.items()})


def _carried(ref, **cfg):
    name = "gpt_tiny" if ref["family"] == "gpt" else "llama_tiny"
    m = tzoo.build(name, config=qt.QuantConfig(**cfg), device="cpu",
                   **ref["geo"])
    load_jax_state(m, ref["state"])
    return m


def _cache(ref):
    return {i: (torch.tensor(k), torch.tensor(v))
            for i, (k, v) in ref["cache"].items()}


@pytest.mark.parametrize("m", [1, M])
@pytest.mark.parametrize("per_row", [False, True])
def test_extend_matches_jax(ref, m, per_row):
    model = _carried(ref)
    cache = _cache(ref)
    pos = torch.tensor([T0, T0 - 2, T0 - 5]) if per_row else T0
    with torch.no_grad():
        codes, cache = model._extend_step(
            cache, pos, torch.tensor(ref["toks"][:, :m], dtype=torch.int64))
    want_codes, want_cache = ref["ext"][m, per_row]
    check = (np.testing.assert_array_equal if ref["family"] == "gpt"
             else assert_contract)
    check(codes.numpy(), want_codes)
    for i, (k, v) in cache.items():
        check(k.numpy(), want_cache[i][0])
        check(v.numpy(), want_cache[i][1])


@pytest.mark.parametrize("cfg", [{}, dict(decode_attention="off",
                                          fuse_qkv="off")])
def test_extend_equals_sequential_decode(ref, cfg):
    """m rows in one extend give the codes and the cache of m decode
    steps, at per-row positions."""
    model = _carried(ref, **cfg)
    toks = torch.tensor(ref["toks"], dtype=torch.int64)
    pos = torch.tensor([T0, T0 - 2, T0 - 5])
    ext, seq = _cache(ref), _cache(ref)
    with torch.no_grad():
        codes, _ = model._extend_step(ext, pos, toks)
        steps = [model._decode_step(seq, pos + j, toks[:, j])[0]
                 for j in range(M)]
    assert torch.equal(codes, torch.stack(steps, 1))
    for i in ext:
        assert torch.equal(ext[i][0], seq[i][0])
        assert torch.equal(ext[i][1], seq[i][1])


def test_extend_past_max_len_clamps_to_the_last_rows(ref):
    model = _carried(ref)
    t = ref["geo"]["max_len"]
    toks = torch.tensor(ref["toks"], dtype=torch.int64)
    clamped, at_end = _cache(ref), _cache(ref)
    with torch.no_grad():
        got, _ = model._extend_step(clamped, t - 2, toks)
        want, _ = model._extend_step(at_end, t - M, toks)
    assert torch.equal(got, want)
    for i in clamped:
        assert torch.equal(clamped[i][0], at_end[i][0])
        assert clamped[i][0].shape[1] == t


def test_ring_cache_extend_is_refused(ref):
    model = _carried(ref)
    ring = {i: (k[:, :16], v[:, :16]) for i, (k, v) in _cache(ref).items()}
    with pytest.raises(NotImplementedError, match="RING"):
        model._extend_step(ring, 4, torch.zeros((3, 2), dtype=torch.int64))


# -- B3 over query-row tiles: the plan and the plain twin ---------------------

def _one_tile_plan(b, t, h, hkv, d, mq):
    """The planner before the row tiling (one tile of all mq positions),
    or None where it raised."""
    grp = h // hkv
    splits = 1
    while splits < TA.MAX_SPLITS and \
            mq * grp * -(-t // splits) > TA.ROWS_PER_BLOCK:
        splits *= 2
    while splits < TA.MAX_SPLITS and TA.decode_attn_plan(
            splits, mq, grp, t, d).smem > TA.SMEM_LIMIT:
        splits += 1
    plan = TA.decode_attn_plan(splits, mq, grp, t, d)
    return plan if plan.smem <= TA.SMEM_LIMIT else None


EXTEND_SHAPES = [(t, hkv, mq) for t in (512, 4096) for hkv in (12, 2)
                 for mq in (1, 2, 5, 9, 16, 32, 64, 128)]


@pytest.mark.parametrize("t,hkv,mq", EXTEND_SHAPES)
def test_plan_covers_extend_shapes(t, hkv, mq):
    plan = TA.plan_decode_attn(1, t, 12, hkv, 64, mq)
    assert 1 <= plan.mq_tile <= mq and 1 <= plan.splits <= TA.MAX_SPLITS
    assert plan.smem <= 227 * 1024
    assert plan == TA.decode_attn_plan(plan.splits, plan.mq_tile, 12 // hkv,
                                       t, 64)
    before = _one_tile_plan(1, t, 12, hkv, 64, mq)
    if before is not None:
        # wherever one tile fits, the plan is the one-tile plan
        assert plan == before and plan.mq_tile == mq
    else:
        # else the largest tile that fits
        assert _one_tile_plan(1, t, 12, hkv, 64, plan.mq_tile) == plan
        assert TA.split_plan(plan.mq_tile + 1, 12 // hkv, t,
                             64).smem > TA.SMEM_LIMIT


def test_plan_equals_the_one_tile_plan_wherever_it_ran():
    n = 0
    for t in (1, 64, 100, 512, 2048, 4096):
        for h, hkv in ((12, 12), (12, 2), (32, 8), (4, 2), (32, 1)):
            for d in (16, 64, 128):
                for mq in range(1, 33):
                    before = _one_tile_plan(2, t, h, hkv, d, mq)
                    if before is not None:
                        assert TA.plan_decode_attn(2, t, h, hkv, d,
                                                   mq) == before
                        n += 1
    assert n > 2000


# (b, t, heads, kv heads, head dim, mq, window)
TILE_CASES = [(2, 64, 4, 4, 16, 7, None), (2, 96, 6, 2, 16, 9, 40)]


@pytest.mark.parametrize("b,t,h,kv,d,mq,window", TILE_CASES)
def test_row_tiled_plain_equals_composed(b, t, h, kv, d, mq, window):
    """Every tiling (and 1 or 3 splits in each tile) gives the composed
    version's codes bit for bit: rows are independent."""
    q, k, v = (torch.tensor(x) for x in _case(b, t, h, kv, d, mq, seed=mq))
    per_seq = torch.tensor([1, t - mq + 1], dtype=torch.int32)
    for rounding in ("trunc", "nearest"):
        kw = dict(PARAMS, alpha=d ** -0.5, rounding=rounding, n_heads=h,
                  n_kv_heads=kv, window=window)
        for valid in (3, per_seq):
            want = TA.decode_attention_flat(q, k, v, valid, **kw)
            for mq_tile in range(1, mq + 1):
                for splits in (1, 3):
                    got = TA.decode_attention_split_plain(
                        q, k, v, valid, splits=splits, mq_tile=mq_tile, **kw)
                    assert torch.equal(got, want), (mq_tile, splits, valid)


def test_launcher_refuses_a_tile_it_cannot_run():
    q, k, v = (torch.tensor(x) for x in _case(1, 64, 4, 2, 16, 4, seed=1))
    bad = TA.decode_attn_plan(1, 5, 2, 64, 16)         # mq_tile > mq
    with pytest.raises(ValueError, match="cannot run"):
        TA._launch(q, k, v, torch.tensor([4], dtype=torch.int32),
                   n_heads=4, n_kv=2, mq=4, window=None, softcap=None,
                   plan=bad, alpha=0.25, **PARAMS)


# -- the kernel on the card ---------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("t,kv,mq,window", [(512, 12, 64, None),
                                            (512, 2, 64, 100),
                                            (4096, 2, 16, None),
                                            (4096, 12, 128, None)])
def test_row_tiled_kernel_equals_plain_on_card(cuda_device, t, kv, mq,
                                               window):
    """B3 at extend shapes, at the planner's tile and at smaller ones, bit
    for bit against the plain twin at the same plan."""
    b, h, d = 2, 12, 64
    q, k, v = (torch.tensor(x).to(cuda_device)
               for x in _case(b, t, h, kv, d, mq, seed=9))
    kw = dict(PARAMS, alpha=d ** -0.5, n_heads=h, n_kv_heads=kv,
              window=window)
    chosen = TA.plan_decode_attn(b, t, h, kv, d, mq)
    tiles = sorted({chosen.mq_tile, 1, max(1, chosen.mq_tile // 2), 7})
    per_seq = torch.tensor([1, t - mq + 1], dtype=torch.int32,
                           device=cuda_device)
    for mq_tile in tiles:
        plan = TA.split_plan(mq_tile, h // kv, t, d)
        for valid in (1, t - mq + 1, per_seq):
            before = TA.decode_attention_flat.launches
            got = TA.decode_attention_flat(q, k, v, valid, plan=plan, **kw)
            want = TA.decode_attention_split_plain(
                q, k, v, valid, splits=plan.splits, mq_tile=mq_tile, **kw)
            torch.cuda.synchronize()
            assert TA.decode_attention_flat.launches == before + 1
            assert torch.equal(got, want), (plan, valid)
