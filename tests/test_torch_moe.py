"""PyTorch port vs JAX package: the mixture-of-experts decoder
(``models/moe.py``, ``layers.QuantMoE``, ``ops/moe.py``), mirroring
``tests/test_moe.py`` at a tiny size (vocab 97, max_len 48, dim 64, depth 2,
4 heads over 2 kv heads, 4 experts of 192, top-2).

* the FP32 forward against the port's ``torch_moe`` twin, whose weights
  equal the JAX package's twin's, at top-1, 2 and 3: 1e-5 of the largest
  logit (the JAX test's own bound is 3e-4);
* W8A8 ('nearest') with the JAX converted state carried over, held by the
  contract of the dynamic mode (``QuantConfig(dynamic_act=True)``, whose
  gates in ``chip_smoke.py`` allow 5e-2):
  the experts quantize each token at its own scale, so an ULP of a float
  exp or sum in the other framework can move one dynamic code on a
  rounding boundary.  The logits of a 16-token forward lie within 5e-2 of
  the largest |logit| of the jitted JAX forward's and of the eager one's,
  and the 12 greedy tokens equal JAX's ``generate()`` except where JAX's
  own logits were within that tolerance of a tie;
* the expert quantization equal to JAX's (codes and scales, per expert and
  per expert row), and the carry round trip;
* the port's own gates bit for bit: cached decode equal to its full
  recompute, sparse dispatch equal to dense (the layer at E = 4, 8, 16
  with top-1/2/3, and a model's ``generate()``), the engine, chunked
  prefill, the prefix cache and speculative decoding equal to
  ``generate()``; ties at the k-th router logit keep every tied expert;
* the weight-only modes: W8-float within 1e-4 of the largest |logit| of
  JAX's and closer to the FP32 twin than the dynamic mode; ``dispatch``
  and ``top_k`` validation; the registry names.

* the checkpoint round trip (``test_checkpoint_roundtrip``): the reloaded
  artifact's logits and 6 greedy tokens equal the saved model's; the JAX
  package's artifact of its converted state (the experts' s8 stacks and
  scales, the float router) equals the port's of the carried state, and
  the port loads it with the carried model's logits.

Left out, as in the rest of the port for now: expert-parallel sharding
(``test_expert_parallel_*``, item 10) and the smoothing pairs
(``test_smooth_pairs_skip_moe_boundary``, item 9b).
"""

import jax
import numpy as np
import pytest
import torch

import int8inferenceengine_tpu as qj
from int8inferenceengine_tpu import layers as JL
from int8inferenceengine_tpu.models import zoo as jzoo
from int8inferenceengine_tpu.models.moe import torch_moe as j_torch_moe
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch.carry import export_state, load_jax_state
from int8inferenceengine_tpu_torch.layers import QuantMoE
from int8inferenceengine_tpu_torch.models import zoo as tzoo
from int8inferenceengine_tpu_torch.models.moe import MoEDecoder, torch_moe
from int8inferenceengine_tpu_torch.ops import moe as moe_ops
from int8inferenceengine_tpu_torch.ops import weight_only as two
from int8inferenceengine_tpu_torch.serve import GenerationEngine
from int8inferenceengine_tpu_torch.tensor import Tensor
from test_torch_text_decoder import (assert_own_gate, jax_state,
                                     own_calibration_gap)
from test_torch_threads import one_torch_thread  # noqa: F401

GEO = dict(vocab_size=97, max_len=48, dim=64, depth=2, heads=4, kv_heads=2)
NEAREST = dict(rounding="nearest")
# the dynamic mode's contract against the JAX package, of the largest
# |logit| (``chip_smoke.FLOAT_RTOL['dynamic']``; the same bound decides a
# near-tie)
DYN_RTOL = 5e-2


def _ids(b, t, seed):
    return np.random.default_rng(seed).integers(
        0, GEO["vocab_size"], (b, t)).astype(np.int32)


def _cpu(x):
    return qt.tensor(x, device="cpu")


def _model(config=NEAREST, calibrate=True, **kw):
    m = MoEDecoder(**GEO, config=qt.QuantConfig(**config), device="cpu",
                   **kw)
    m.load(torch_moe(**GEO, **{k: v for k, v in kw.items()
                               if k != "dispatch"}).state_dict())
    if calibrate:
        m.prepare()
        m(_cpu(_ids(4, 16, 0)))
    m.convert()
    return m


def near_tie_ok(got, want, logits, rtol):
    """Tokens ``got`` equal ``want`` [B, S] except where a row leaves at a
    step whose reference logits ``logits`` [B, S, V] had a runner-up
    within ``rtol`` of the largest |logit| of the winner."""
    for r in range(got.shape[0]):
        apart = np.nonzero(got[r] != want[r])[0]
        if apart.size:
            s = apart[0]
            top = np.sort(logits[r, s])[-2:]
            assert top[1] - top[0] <= rtol * np.abs(logits[r]).max(), (r, s)


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_fp32_parity_vs_twin(top_k):
    tw = torch_moe(**GEO, top_k=top_k)
    jtw = j_torch_moe(**GEO, top_k=top_k)
    for key, v in jtw.state_dict().items():
        assert torch.equal(tw.state_dict()[key], v), key
    ids = torch.tensor(_ids(2, 16, top_k), dtype=torch.long)
    ref = tw(ids).detach().numpy()
    np.testing.assert_allclose(jtw(ids).detach().numpy(), ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())
    m = MoEDecoder(**GEO, top_k=top_k, device="cpu")
    m.load(tw.state_dict())
    np.testing.assert_allclose(m(_cpu(ids.numpy())).numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.fixture(scope="module")
def ref():
    """The JAX MoE's converted state ('nearest'), its jitted and eager
    forward logits and its greedy tokens with their logits."""
    jm = jzoo.build("moe_tiny", config=qj.QuantConfig(**NEAREST), **GEO)
    jm.load(torch_moe(**GEO).state_dict())
    jm.prepare()
    jm(qj.tensor(_ids(4, 16, 0)))
    jm.convert()
    x, prompt = _ids(3, 16, 1), _ids(2, 8, 2)
    with jax.disable_jit():
        eager = jm(qj.tensor(x)).numpy()
    tokens = np.asarray(jm.generate(prompt, 12))
    seq = np.concatenate([prompt, tokens], 1)
    steps = jm(qj.tensor(seq)).numpy()[:, prompt.shape[1] - 1:-1]
    return dict(state=jax_state(jm), x=x, jit=jm(qj.tensor(x)).numpy(),
                codes=np.asarray(jm(qj.tensor(x)).data),
                eager=eager, prompt=prompt, tokens=tokens, steps=steps)


def _carried(ref, config=NEAREST):
    m = tzoo.build("moe_tiny", config=qt.QuantConfig(**config),
                   device="cpu", **GEO)
    load_jax_state(m, ref["state"])
    return m


def test_int8_within_dynamic_contract_of_jax(ref):
    got = _carried(ref)(_cpu(ref["x"])).numpy()
    for want in (ref["jit"], ref["eager"]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=DYN_RTOL * np.abs(want).max())
        agree = (got.argmax(-1) == want.argmax(-1)).mean()
        assert agree >= 0.95, agree


def test_generate_tokens_match_jax(ref):
    got = _carried(ref).generate(ref["prompt"], 12)
    near_tie_ok(got, ref["tokens"], ref["steps"], DYN_RTOL)


def test_own_calibration_gate(ref):
    """The port's own lifecycle on the JAX one's weights and 4 x 16
    calibration ids: every zero point equal, the output scales within 6
    float32 ULPs of the JAX package's (wk1; the first min to depart is
    ln1_1's, 1 ULP: the RMSNorm's float32 mean of squares and XLA's
    approximate rsqrt against the port's float64 ones, rounded once), the
    3 x 16 forward's head codes equal to the jitted JAX forward's on
    96.78% (within 2 steps: the experts' per-token dynamic codes move with
    an ULP of their input), and the 12 greedy tokens equal."""
    m = tzoo.build("moe_tiny", config=qt.QuantConfig(**NEAREST),
                   device="cpu", **GEO)
    m.load(torch_moe(**GEO).state_dict())
    m.prepare()
    m(_cpu(_ids(4, 16, 0)))
    m.convert()
    gap = own_calibration_gap(m, ref["state"], m(_cpu(ref["x"])).data.numpy(),
                              ref["codes"], m.generate(ref["prompt"], 12),
                              ref["tokens"])
    assert_own_gate(gap, scale_ulps=6, equal=0.9677, max_dist=2,
                    token_steps=12)


@pytest.mark.parametrize("per_channel", [False, True])
def test_expert_codes_and_scales_equal_jax(per_channel):
    cfg = dict(NEAREST, weight_per_channel=per_channel)
    sd = torch_moe(**GEO).state_dict()
    jl = JL.QuantMoE(64, 192, 4, 2, config=qj.QuantConfig(**cfg))
    tl = QuantMoE(64, 192, 4, 2, config=qt.QuantConfig(**cfg), device="cpu")
    for key in ("router", "gate_w", "up_w", "down_w"):
        getattr(jl, "load_" + key)(sd[f"moe1.{key}"].numpy())
        getattr(tl, "load_" + key)(sd[f"moe1.{key}"])
    jl.convert()
    tl.convert()
    for key in ("q_gate_w", "q_up_w", "q_down_w", "gate_w_s", "up_w_s",
                "down_w_s", "router"):
        np.testing.assert_array_equal(getattr(tl, key).numpy(),
                                      np.asarray(jl.params[key]), key)
    assert tl.gate_w is None and tl.down_w_s.dim() == 1 + per_channel


def test_carry_round_trip(ref):
    back = export_state(_carried(ref))
    assert set(back) == set(ref["state"])
    for name in ("moe1", "moe2"):
        want = ref["state"][name]["params"]
        assert set(back[name]["params"]) == set(want)
        for key, v in want.items():
            np.testing.assert_array_equal(back[name]["params"][key], v)
    fp = export_state(MoEDecoder(**GEO, device="cpu"))
    assert set(fp["moe1"]["params"]) == {"router", "gate_w", "up_w",
                                         "down_w"}


def test_checkpoint_roundtrip(tmp_path):
    from int8inferenceengine_tpu_torch import utils
    m, ids = _model(), _ids(3, 10, 13)
    base, base_toks = m(_cpu(ids)).numpy(), m.generate(ids, 6)
    path = str(tmp_path / "moe_int8.npz")
    utils.save(m, path)
    fresh = MoEDecoder(**GEO, config=qt.QuantConfig(**NEAREST),
                       device="cpu")
    utils.load(fresh, path)
    assert fresh.is_quant
    np.testing.assert_array_equal(fresh(_cpu(ids)).numpy(), base)
    np.testing.assert_array_equal(fresh.generate(ids, 6), base_toks)


def test_artifact_equals_jax(ref, tmp_path):
    from int8inferenceengine_tpu_torch import utils
    from test_torch_checkpoint import assert_same_artifact, install_state
    m = _carried(ref)
    jm = install_state(jzoo.build("moe_tiny",
                                  config=qj.QuantConfig(**NEAREST), **GEO),
                       ref["state"])
    jp, _ = assert_same_artifact(jm, m, tmp_path)
    x = _cpu(ref["x"])
    np.testing.assert_array_equal(utils.load(_carried(ref), jp)(x).numpy(),
                                  m(x).numpy())


def test_cached_decode_equals_recompute():
    m = _model()
    ids = _ids(3, 7, 5)
    toks = m.generate(ids, 8)
    seq = ids
    for _ in range(8):
        codes = m(_cpu(seq)).data.numpy()
        seq = np.concatenate([seq, codes[:, -1].argmax(-1)[:, None]], 1)
    np.testing.assert_array_equal(seq[:, 7:], toks)


def test_engine_chunked_prefix_and_speculative_equal_generate():
    m = _model()
    ids, long = _ids(2, 7, 6), _ids(1, 20, 7)[0]
    want = m.generate(ids, 10)
    want_long = m.generate(long[None], 8)[0]
    eng = GenerationEngine(m, slots=2, chunk_steps=4, prefill_chunk=8)
    try:
        got = [eng.submit(ids[i], 10).result(timeout=120) for i in range(2)]
        chunked = eng.submit(long, 8).result(timeout=120)
        pid = eng.register_prefix(long[:12])
        prefixed = eng.submit(long, 8, prefix_id=pid).result(timeout=120)
    finally:
        eng.shutdown()
    np.testing.assert_array_equal(np.stack(got), want)
    np.testing.assert_array_equal(chunked, want_long)
    np.testing.assert_array_equal(prefixed, want_long)
    # a dense gpt draft for the MoE target, and the target itself
    draft = tzoo.build("gpt_tiny", config=qt.QuantConfig(**NEAREST),
                       device="cpu", vocab_size=97, max_len=48, dim=32,
                       depth=1, heads=2)
    draft.load(tzoo.torch_text_decoder(vocab_size=97, max_len=48, dim=32,
                                       depth=1, heads=2).state_dict())
    draft.prepare()
    draft(_cpu(_ids(4, 16, 8)))
    draft.convert()
    for d in (draft, m):
        np.testing.assert_array_equal(
            m.generate_speculative(d, ids, 10, k=3), want)


@pytest.mark.parametrize("n_experts,top_k", [(4, 2), (8, 2), (16, 1),
                                             (8, 3)])
def test_sparse_dispatch_bit_exact(n_experts, top_k):
    """The JAX test's weights and input: sparse dispatch gives dense
    dispatch's codes, and skips experts (fewer s8 products)."""
    rng = np.random.default_rng(n_experts * 10 + top_k)
    e, dim, hid = n_experts, 64, 128
    w = dict(
        router=rng.normal(scale=0.5, size=(e, dim)).astype(np.float32),
        gate_w=rng.normal(scale=0.1, size=(e, hid, dim)).astype(np.float32),
        up_w=rng.normal(scale=0.1, size=(e, hid, dim)).astype(np.float32),
        down_w=rng.normal(scale=0.1, size=(e, dim, hid)).astype(np.float32))
    x = rng.normal(size=(8, dim)).astype(np.float32)
    xi = np.clip(np.round(x / 0.02) + 128, 0, 255).astype(np.uint8)
    outs, calls = {}, {}
    for disp in ("dense", "sparse"):
        m = QuantMoE(dim, hid, e, top_k, config=qt.QuantConfig(),
                     dispatch=disp, device="cpu")
        for k, v in w.items():
            getattr(m, "load_" + k)(v)
        m.prepare()
        m(_cpu(x))
        m.convert()
        before = two.s8_matmul.calls
        outs[disp] = m(Tensor(torch.tensor(xi), 0.02, 128)).data.numpy()
        calls[disp] = two.s8_matmul.calls - before
    np.testing.assert_array_equal(outs["dense"], outs["sparse"])
    assert calls["dense"] == 2 + e
    assert calls["sparse"] <= 3 * e


def test_sparse_dispatch_model_level():
    outs = {}
    for disp in ("dense", "sparse"):
        m = _model(n_experts=8, dispatch=disp)
        assert m.moe1._use_sparse(8) == (disp == "sparse")
        outs[disp] = m.generate(_ids(2, 6, 3), 8)
    np.testing.assert_array_equal(outs["dense"], outs["sparse"])


def test_dispatch_and_top_k_validation():
    with pytest.raises(ValueError, match="dispatch"):
        QuantMoE(8, 16, 4, 2, dispatch="bogus", device="cpu")
    with pytest.raises(ValueError, match="top_k"):
        QuantMoE(8, 16, 4, 5, device="cpu")
    auto = QuantMoE(8, 16, 8, 2, device="cpu")
    assert auto._use_sparse(16) and not auto._use_sparse(17)
    assert not QuantMoE(8, 16, 4, 2, device="cpu")._use_sparse(1)


def test_route_keeps_every_tied_expert():
    """Ties at the k-th logit keep every tied expert (``torch.topk`` alone
    would keep k); the weights are a softmax over the kept logits."""
    f = torch.tensor([[1.0, 0.0]])
    router = torch.tensor([[2.0, 0.0], [1.0, 0.0], [1.0, 0.0], [0.0, 0.0]])
    w = moe_ops.route(f, router, 2)
    assert (w[0, :3] > 0).all() and w[0, 3] == 0
    np.testing.assert_allclose(w[0, :3].numpy(), torch.softmax(
        torch.tensor([2.0, 1.0, 1.0]), 0).numpy(), rtol=1e-6)


def test_weight_only_float_contract():
    """W8-float keeps float activations (error = weight rounding only),
    within 1e-4 of the JAX package's, closer to the FP32 twin than the
    dynamic mode; its cached decode equals its recompute."""
    tw = torch_moe(**GEO)
    ids = _ids(4, 12, 19)
    want = tw(torch.tensor(ids, dtype=torch.long)).detach().numpy()
    m = _model(config=dict(weight_only=True), calibrate=False)
    got = m(_cpu(ids)).numpy()
    md = _model(config=dict(weight_only=True, dynamic_act=True),
                calibrate=False)
    err = np.abs(got - want).max()
    assert err < np.abs(md(_cpu(ids)).numpy() - want).max()
    jm = jzoo.build("moe_tiny", config=qj.QuantConfig(weight_only=True),
                    **GEO)
    jm.load(tw.state_dict())
    jm.convert()
    jw = jm(qj.tensor(ids)).numpy()
    np.testing.assert_allclose(got, jw, rtol=0, atol=1e-4 * np.abs(jw).max())
    toks = m.generate(ids[:, :6], 5)
    seq = ids[:, :6]
    for _ in range(5):
        seq = np.concatenate(
            [seq, m(_cpu(seq)).numpy()[:, -1].argmax(-1)[:, None]], 1)
    np.testing.assert_array_equal(seq[:, 6:], toks)


def test_registry_names():
    m = tzoo.build("moe_tiny", device="cpu")
    assert isinstance(m, MoEDecoder) and m.kv_heads == 2
    assert isinstance(m.moe1, QuantMoE) and m.moe1.n_experts == 4
    assert m.moe1.top_k == 2 and not hasattr(m, "gate1")
    tw, jtw = tzoo.torch_twin("moe_tiny"), jzoo.torch_twin("moe_tiny")
    assert set(tw.state_dict()) == set(jtw.state_dict())
    for key, v in jtw.state_dict().items():
        assert torch.equal(tw.state_dict()[key], v), key
