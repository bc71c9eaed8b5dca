"""PyTorch port vs JAX package: the decoders' tensor-parallel roles and
``generate()`` after ``shard()``.

As ``tests/test_torch_parallel.py``: one world of 4 gloo ranks on the CPU
runs every case (``tests/torch_parallel_ranks.py``) while this process
computes the JAX package's references on the same inputs, sharded on 4 of
conftest's 8 virtual devices over the same mesh shapes and unsharded.

The cases are those of ``tests/test_sharding.py``, ``tests/test_llama.py``,
``tests/test_bloom.py`` and ``tests/test_moe.py``, and NeoX's plan: the
decoder's roles (head-local QKV, row-parallel proj/fc2, column-parallel
fc1; the flags asserted, then the forward bit for bit), greedy
``generate()`` bit for bit on (2, 2) and (1, 4) over the head-sharded KV
cache, sampled tokens in range and repeatable; llama's plan and its
kv-head fallback; BLOOM without head-local attention; the MoE's
expert-parallel ``generate()``; and ``generate_speculative`` refused with
a sharded draft.

The same world serves the sharded engines (``serve.GenerationEngine`` and
``serve.InferenceEngine`` over a ``shard()``ed model, in lockstep across
the ranks) and the sharded speculative target, mirroring
``tests/test_engine_sharded.py``, ``tests/test_speculative.py`` (its
sharded target and guards), ``tests/test_serve.py`` (the sharded
``InferenceEngine``), ``tests/test_prefix_cache.py``,
``tests/test_ring_cache.py`` and ``tests/test_sampling_topp.py`` (their
sharded engines) at (2, 2).  Their reference is the JAX package's
unsharded ``generate()`` or forward on the carried state (its own tests
hold its sharded runs to those): greedy engine tokens equal it, sharded
``generate()`` and the port's unsharded ``generate()``; sampled engine
tokens equal the port's unsharded engine's (the draw is keyed by (seed,
position), with no slot or data-shard term).  The engine cases serve the
converted models of the cases above and take their JAX tokens from them,
so that they add few JAX compiles.
"""


import jax
import numpy as np
import pytest

from int8inferenceengine_tpu.parallel.mesh import make_mesh as jmake_mesh
import torch_parallel_ranks as R
from test_torch_cnn_zoo import jax_forward
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch.carry import export_state
from int8inferenceengine_tpu_torch.models import zoo as tzoo
from test_torch_parallel import (WORLD, _converted, _loaded, _model_case,
                                 jax_model, jax_sharded, result, spawn_world,
                                 twin_state)
from test_torch_threads import one_torch_thread  # noqa: F401

GPT = dict(vocab_size=97, max_len=48, dim=128, depth=2, heads=4)
# one block each: the roles repeat per block, and the JAX references'
# compiles (the file's time) grow with the depth
LLAMA = dict(vocab_size=97, max_len=32, dim=128, depth=1, heads=4,
             kv_heads=2)
BLOOM = dict(vocab_size=97, max_len=32, dim=64, depth=1, heads=4)
MOE = dict(vocab_size=97, max_len=32, dim=64, depth=1, heads=4, kv_heads=2)
MESHES = [(2, 2), (1, 4)]
# the sharded engines' draft and ring models (JAX tests/test_speculative.py
# and tests/test_ring_cache.py's widths); the other engine cases serve the
# gpt and llama models above
ENG_DRAFT = dict(vocab_size=97, max_len=48, dim=64, depth=1, heads=2)
ENG_RING = dict(vocab_size=97, max_len=96, dim=64, depth=2, heads=4,
                kv_heads=2, sliding_window=8, ring_cache=True)
ENG_STEPS = 10


def build_cases():
    """The JAX tests' cases: gpt_tiny calibrated on its 4 x 16 prompt and
    decoding 20 tokens (``test_sharding.test_tp_generate_bit_exact``), the
    other families one block deep at small widths; the default
    QuantConfig."""
    rng = np.random.default_rng(0)
    cases, models = [], {}
    for name, zname, geo, meshes, flags, steps in (
            ("gpt", "gpt_tiny", GPT, MESHES,
             ("wq1", "wk1", "wv1", "proj1", "fc1_1", "fc2_1", "head"), 20),
            ("llama", "llama_tiny", LLAMA, [(2, 2)],
             ("wq1", "proj1", "gate1", "up1", "down1"), 10),
            ("llama_kv1", "llama_tiny", dict(LLAMA, kv_heads=1), [(2, 2)],
             ("wq1", "down1"), 0),
            ("neox", "neox_tiny", BLOOM, [(2, 2)],
             ("wq1", "proj1", "fc1_1", "fc2_1"), 0),
            ("bloom", "bloom_tiny", BLOOM, [(2, 2)],
             ("wq1", "proj1", "fc1_1", "fc2_1"), 4),
            ("moe", "moe_tiny", MOE, [(2, 2)],
             ("moe1", "wq1", "proj1"), 8)):
        ids = rng.integers(0, 97, (4, 16)).astype(np.int32)
        m = _converted(zname, ids, **geo)
        spec = (zname, geo, {})
        models[name] = (m, spec, ids)
        cases.append(_model_case(f"{name}_forward", "forward", m, spec,
                                 x=ids, meshes=[(s, False) for s in meshes],
                                 flags=flags))
        if steps:
            cases.append(_model_case(
                f"{name}_generate", "generate", m, spec,
                ids=ids if name == "gpt" else ids[:, :8], steps=steps,
                meshes=meshes))
    m = _converted("gpt_tiny", rng.integers(0, 97, (4, 16)).astype(
        np.int32), **GPT)
    cases.append(_model_case("speculative_refused", "raises", m,
                             ("gpt_tiny", GPT, {}), what="speculative",
                             shape=(2, 2),
                             x=rng.integers(0, 97, (4, 8)).astype(np.int32)))
    return cases + engine_cases(models, np.random.default_rng(1))


def _requests(prompts, n=ENG_STEPS, **kw):
    return [dict(prompt=p, n=n, kw=kw) for p in prompts]


def engine_cases(models, rng):
    """The sharded engines' cases at (2, 2), on the converted gpt, llama
    and kv-head-1 llama of the cases above: a request whose prompt is a
    row of the ``gpt_generate`` / ``llama_generate`` prompts is held to
    that case's JAX tokens (its first ``n``), so only the MQA, ring and
    LeNet cases compile JAX programs of their own; the other requests
    (shorter prompts, for the bucketed prefill's groups) are held to the
    port's unsharded ``generate()``."""
    gpt, gspec, ids = models["gpt"]
    engine = dict(slots=4, chunk_steps=4)
    cases = []

    def gpt_case(name, **more):
        cases.append(_model_case(name, "engine", gpt, gspec, mesh=(2, 2),
                                 **more))

    gpt_case("engine_gpt", engine=engine, sharded_generate=True,
             requests=_requests([ids[0], ids[1][:5], ids[2], ids[3][:9]]))
    # more requests than slots, several chunks a sync
    gpt_case("engine_oversubscribed", engine=dict(engine, sync_chunks=3),
             requests=_requests([ids[j % 4] if j % 2 else ids[j % 4][:7]
                                 for j in range(10)], n=12))
    # greedy, sampled, top-p, and top-k with top-p (held to the unsharded
    # engine's draws)
    p = ids[2]
    gpt_case("engine_sampled", engine=engine, unsharded_engine=True,
             requests=(_requests([p])
                       + _requests([p], temperature=1.0, seed=7)
                       + _requests([p], temperature=1.0, seed=7, top_p=0.6)
                       + _requests([p], temperature=1.0, seed=5, top_k=6,
                                   top_p=0.8)))
    # a 16-token prompt in two chunks of 8, and a short one bucketed
    gpt_case("engine_chunked", engine=dict(engine, prefill_chunk=8),
             requests=_requests([ids[1], ids[0][:5]]))
    # two prefixes (suffixes of 1 and 5 tokens), each request prefixed and
    # cold
    gpt_case("engine_prefix", engine=dict(engine, prefill_chunk=8),
             prefixes=[ids[0][:15], ids[1][:11]], sharded_generate=True,
             requests=[r for i in (0, 1) for r in (
                 _requests([ids[i]], prefix=i) + _requests([ids[i]]))])
    wo_geo = dict(vocab_size=97, max_len=32, dim=64, depth=1, heads=4)
    wo = _loaded("gpt_tiny", dict(weight_only=True), **wo_geo)
    wo.convert()
    cases.append(_model_case(
        "engine_guards", "engine_guards", gpt, gspec, mesh=(2, 2),
        bad_slots=3, weight_only_model=("gpt_tiny", wo_geo,
                                        dict(weight_only=True)),
        weight_only_state=export_state(wo)))
    llama, lspec, lids = models["llama"]
    cases.append(_model_case(
        "engine_llama", "engine", llama, lspec, mesh=(2, 2), engine=engine,
        sharded_generate=True, requests=_requests(list(lids[:, :8]))))
    cal = rng.integers(0, 97, (2, 8)).astype(np.int32)
    draft = _converted("gpt_tiny", cal, **ENG_DRAFT)
    cases.append(_model_case(
        "speculative_sharded", "speculative", llama, lspec, mesh=(2, 2),
        draft=("gpt_tiny", ENG_DRAFT, {}), draft_state=export_state(draft),
        ids=lids[:, :8], steps=ENG_STEPS, k=3))
    mqa, mspec, mids = models["llama_kv1"]
    cases.append(_model_case(
        "engine_mqa", "engine", mqa, mspec, mesh=(2, 2),
        engine=dict(engine, slots=2), jax_generate=True,
        requests=_requests([mids[0, :8]], n=8)))
    ring = tzoo.build("llama_tiny", config=qt.QuantConfig(
        rounding="nearest"), device="cpu", **ENG_RING)
    ring.load(twin_state("llama_tiny", **{
        k: v for k, v in ENG_RING.items() if k != "ring_cache"}))
    ring.prepare()
    ring(qt.tensor(cal, device="cpu"))
    ring.convert()
    cases.append(_model_case(
        "engine_ring", "engine", ring,
        ("llama_tiny", ENG_RING, dict(rounding="nearest")), mesh=(2, 2),
        engine=engine, jax_generate=True,
        requests=_requests([rng.integers(0, 97, (7,)).astype(np.int32)],
                           n=30)))
    lenet = _converted("lenet", rng.uniform(-1, 1, (16, 1, 28, 28)).astype(
        np.float32))
    cases.append(_model_case(
        "inference_engine", "inference_engine", lenet, ("lenet", {}, {}),
        mesh=(2, 2), x=rng.uniform(-1, 1, (20, 1, 28, 28)).astype(
            np.float32),
        bad=rng.uniform(-1, 1, (2, 3, 28, 28)).astype(np.float32)))
    return cases


def jax_refs(cases) -> dict:
    refs = {}
    for case in cases:
        if case["kind"] == "forward":
            jm = jax_model(case)
            ref = {"base": jax_forward(jm, case["x"])}
            for shape, _ in case["meshes"]:
                ref[R.mesh_key(shape)] = jax_sharded(jm, case["x"], shape)
            refs[case["name"]] = ref
        elif case["kind"] == "generate":
            jm = jax_model(case)
            ref = {"base": jm.generate(case["ids"], case["steps"])}
            for shape in case["meshes"]:
                jm.shard(jmake_mesh(shape, devices=jax.devices()[:WORLD]))
                ref[R.mesh_key(shape)] = jm.generate(case["ids"],
                                                     case["steps"])
            refs[case["name"]] = ref
        elif case["kind"] == "engine" and case.get("jax_generate"):
            jm = jax_model(case)
            refs[case["name"]] = [np.asarray(jm.generate(
                r["prompt"][None], r["n"]))[0] for r in case["requests"]]
        elif case["kind"] == "inference_engine":
            refs[case["name"]] = jax_forward(jax_model(case), case["x"])
    return refs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawn_world(build_cases(), jax_refs, tmp_path_factory)


FLAG = dict(zip(R.FLAGS, range(len(R.FLAGS))))


def _flag(res, key, layer, flag):
    return res["flags"][key][layer][FLAG[flag]]


@pytest.mark.parametrize("mesh", MESHES)
def test_transformer_tp_decoder_bit_exact(world, mesh):
    key = R.mesh_key(mesh)
    res, refs = result(world, "gpt_forward"), world[1]["gpt_forward"]
    # the transformer roles engaged
    assert _flag(res, key, "wq1", "_tp_local")
    assert _flag(res, key, "wq1", "_tp_sharded")
    assert _flag(res, key, "proj1", "_tp_row")
    assert _flag(res, key, "fc2_1", "_tp_row")
    assert _flag(res, key, "fc1_1", "_tp_local")
    # a 97-token vocabulary does not divide the model axis: replicated
    assert not _flag(res, key, "head", "_tp_sharded")
    np.testing.assert_array_equal(res["out"][key], res["base"])
    np.testing.assert_array_equal(res["out"][key], refs[key])
    np.testing.assert_array_equal(res["base"], refs["base"])


@pytest.mark.parametrize("mesh", MESHES)
def test_tp_generate_bit_exact(world, mesh):
    key = R.mesh_key(mesh)
    res, refs = result(world, "gpt_generate"), world[1]["gpt_generate"]
    np.testing.assert_array_equal(res["out"][key], res["base"])
    np.testing.assert_array_equal(res["out"][key], refs[key])
    np.testing.assert_array_equal(res["base"], refs["base"])


@pytest.mark.parametrize("mesh", MESHES)
def test_tp_generate_sampled_in_range_and_repeatable(world, mesh):
    a, b = result(world, "gpt_generate")["sampled"][R.mesh_key(mesh)]
    assert a.shape == (4, 6) and ((a >= 0) & (a < GPT["vocab_size"])).all()
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["llama_forward", "llama_generate"])
def test_llama_tp_bit_exact(world, case):
    res, refs = result(world, case), world[1][case]
    if case == "llama_forward":
        # 4 heads and 2 kv heads both divide the model axis: head-local
        assert _flag(res, "2x2", "wq1", "_tp_local")
        assert _flag(res, "2x2", "proj1", "_tp_row")
        assert _flag(res, "2x2", "gate1", "_tp_local")
        assert _flag(res, "2x2", "up1", "_tp_local")
        assert _flag(res, "2x2", "down1", "_tp_row")
    np.testing.assert_array_equal(res["out"]["2x2"], res["base"])
    np.testing.assert_array_equal(res["out"]["2x2"], refs["2x2"])


def test_llama_tp_head_fallback_kv_not_divisible(world):
    res, refs = result(world, "llama_kv1_forward"), \
        world[1]["llama_kv1_forward"]
    assert not _flag(res, "2x2", "wq1", "_tp_local")   # 1 kv head over 2
    assert _flag(res, "2x2", "down1", "_tp_row")
    np.testing.assert_array_equal(res["out"]["2x2"], res["base"])
    np.testing.assert_array_equal(res["out"]["2x2"], refs["2x2"])


def test_neox_tp_bit_exact(world):
    res, refs = result(world, "neox_forward"), world[1]["neox_forward"]
    assert _flag(res, "2x2", "wq1", "_tp_local")       # the gpt block's plan
    assert _flag(res, "2x2", "fc1_1", "_tp_local")
    assert _flag(res, "2x2", "fc2_1", "_tp_row")
    np.testing.assert_array_equal(res["out"]["2x2"], res["base"])
    np.testing.assert_array_equal(res["out"]["2x2"], refs["2x2"])


@pytest.mark.parametrize("case", ["bloom_forward", "bloom_generate"])
def test_bloom_tp_no_head_local(world, case):
    res, refs = result(world, case), world[1][case]
    if case == "bloom_forward":
        # ALiBi slopes index global heads: no head-local attention
        assert not _flag(res, "2x2", "wq1", "_tp_local")
        assert _flag(res, "2x2", "fc2_1", "_tp_row")
    np.testing.assert_array_equal(res["out"]["2x2"], res["base"])
    np.testing.assert_array_equal(res["out"]["2x2"], refs["2x2"])


@pytest.mark.parametrize("case", ["moe_forward", "moe_generate"])
def test_moe_expert_parallel_decoder_bit_exact(world, case):
    res, refs = result(world, case), world[1][case]
    if case == "moe_forward":
        assert _flag(res, "2x2", "moe1", "_tp_expert")
        assert _flag(res, "2x2", "wq1", "_tp_local")
        assert _flag(res, "2x2", "proj1", "_tp_row")
    np.testing.assert_array_equal(res["out"]["2x2"], res["base"])
    np.testing.assert_array_equal(res["out"]["2x2"], refs["2x2"])


def test_speculative_refused_on_a_sharded_model(world):
    # the model drafting for itself is a sharded draft: JAX's guard
    res = result(world, "speculative_refused")
    assert res["type"] == "NotImplementedError"
    assert "replicated draft" in res["message"]


# -- the sharded engines (JAX tests/test_engine_sharded.py and the others'
# sharded cases) -------------------------------------------------------------

def _equal_rows(got, *wants):
    assert len(got) == len(wants[0])
    for want in wants:
        for g, w in zip(got, want):
            if w is not None:
                np.testing.assert_array_equal(g, w)


def _jax_rows(world, case, rows):
    """The JAX package's tokens of prompt row ``rows[i]`` of ``case``'s
    ``generate()`` (None: a prompt that is no such row), to each engine
    request's length."""
    c = world[2][case]
    base = world[1][f"{c['model'][0].split('_')[0]}_generate"]["base"]
    return [None if i is None else base[i][:r["n"]]
            for i, r in zip(rows, c["requests"])]


@pytest.mark.parametrize("case,rows,channels", [
    # gpt: 4 heads of 32 over 2; llama: 2 kv heads of 32 over 2
    ("engine_gpt", [0, None, 2, None], 64),
    ("engine_llama", [0, 1, 2, 3], 32)])
def test_engine_matches_sharded_generate(world, case, rows, channels):
    """gpt and llama GQA at (2, 2): the engine's tokens equal sharded
    ``generate()``, the unsharded one and JAX's; the slot caches are
    head-sharded; a follower's ``submit()`` names rank 0."""
    res = result(world, case)
    _equal_rows(res["out"], res["sharded_generate"], res["base"],
                _jax_rows(world, case, rows))
    assert res["kv_sharded"] is True
    assert res["cache_channels"] == channels
    assert "rank 0" in res["follower"]


def test_engine_oversubscribed_and_multichunk(world):
    res = result(world, "engine_oversubscribed")
    assert res["stats"]["requests"] == 10 and res["stats"]["chunks"] > 0
    _equal_rows(res["out"], res["base"], _jax_rows(
        world, "engine_oversubscribed",
        [j % 4 if j % 2 else None for j in range(10)]))


def test_engine_sampled_topp_matches_unsharded_engine(world):
    """Greedy, sampled and top-p requests: the sharded engine's draws
    equal the unsharded engine's (keyed by (seed, position))."""
    res = result(world, "engine_sampled")
    _equal_rows(res["out"][:3], res["unsharded_engine"][:3])
    _equal_rows(res["out"], _jax_rows(world, "engine_sampled",
                                      [2, None, None, None]))


def test_engine_topk_sharded(world):
    res = result(world, "engine_sampled")
    np.testing.assert_array_equal(res["out"][3], res["unsharded_engine"][3])
    assert res["out"][3].shape == (ENG_STEPS,)


def test_engine_chunked_prefill_sharded(world):
    res = result(world, "engine_chunked")
    _equal_rows(res["out"], res["base"],
                _jax_rows(world, "engine_chunked", [1, None]))


def test_engine_mqa_fallback_geometry(world):
    """kv_heads 1 on a model axis of 2: the slot caches stay
    channel-replicated."""
    res = result(world, "engine_mqa")
    assert res["kv_sharded"] is False
    assert res["cache_channels"] == 32
    _equal_rows(res["out"], res["base"], world[1]["engine_mqa"])


def test_engine_sharded_guards(world):
    res = result(world, "engine_guards")
    assert res["slots"] == "ValueError"        # slots % data_size
    assert res["pid"] >= 1                     # a prefix registers


def test_engine_weight_only_sharded_guard(world):
    assert result(world, "engine_guards")["weight_only"] == \
        "NotImplementedError"


def test_prefix_cache_sharded_engine(world):
    """Two prefixes registered on the sharded engine: prefixed tokens
    equal the cold submission's, sharded ``generate()``'s and JAX's."""
    res = result(world, "engine_prefix")
    assert res["stats"]["prefix_hits"] == 2 and len(res["pids"]) == 2
    _equal_rows(res["out"], res["sharded_generate"], res["base"],
                _jax_rows(world, "engine_prefix", [0, 0, 1, 1]))
    for i in (0, 2):
        np.testing.assert_array_equal(res["out"][i], res["out"][i + 1])


def test_ring_engine_sharded(world):
    """Ring slot caches under the sharded engine: tokens equal
    ``generate()`` and JAX's."""
    res = result(world, "engine_ring")
    assert res["kv_sharded"] is True
    _equal_rows(res["out"], res["base"], world[1]["engine_ring"])


def test_sharded_target_spec_equals_sharded_generate(world):
    res = result(world, "speculative_sharded")
    ref = world[1]["llama_generate"]["base"]
    for key in ("base", "spec_base", "sharded", "spec"):
        np.testing.assert_array_equal(res[key], ref)
    assert res["stats"]["emitted"] >= 4 * (ENG_STEPS - 1)
    # each data group's own count; the longest sets the macro-steps
    by_group = res["stats"]["macro_steps_by_data_group"]
    assert len(by_group) == 2 and max(by_group) == \
        res["stats"]["macro_steps"]


def test_sharded_spec_guards(world):
    assert result(world, "speculative_sharded")["guards"] == {
        "batch": "ValueError", "sharded_draft": "NotImplementedError"}


def test_inference_engine_serves_sharded_model(world):
    """The CNN engine over LeNet sharded on (2, 2): replies equal the
    unsharded forward and JAX's; a request that the model refuses fails
    alone."""
    res = result(world, "inference_engine")
    np.testing.assert_array_equal(res["out"], res["base"])
    np.testing.assert_array_equal(res["out"], world[1]["inference_engine"])
    np.testing.assert_array_equal(res["small"], res["base"][:4])
    assert res["bad"] is not None


def test_inference_engine_follower_failure_raises(world):
    """A tile that fails on one follower alone is no refused request: rank
    0 reports its own outcome in its next record, and the follower's
    engine raises, which its ``shutdown()`` reports."""
    reply, err = result(world, "inference_engine")["follower_failure"]
    assert reply == (4, 10)
    assert "rank 1" in err and "MemoryError" in err
