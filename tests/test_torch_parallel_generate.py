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
expert-parallel ``generate()``; and ``generate_speculative`` refused on a
sharded model.
"""

import jax
import numpy as np
import pytest

from int8inferenceengine_tpu.parallel.mesh import make_mesh as jmake_mesh
import torch_parallel_ranks as R
from test_torch_cnn_zoo import jax_forward
from test_torch_parallel import (WORLD, _converted, _model_case, jax_model,
                                 jax_sharded, result, spawn_world)
from test_torch_threads import one_torch_thread  # noqa: F401

GPT = dict(vocab_size=97, max_len=48, dim=128, depth=2, heads=4)
# one block each: the roles repeat per block, and the JAX references'
# compiles (the file's time) grow with the depth
LLAMA = dict(vocab_size=97, max_len=32, dim=128, depth=1, heads=4,
             kv_heads=2)
BLOOM = dict(vocab_size=97, max_len=32, dim=64, depth=1, heads=4)
MOE = dict(vocab_size=97, max_len=32, dim=64, depth=1, heads=4, kv_heads=2)
MESHES = [(2, 2), (1, 4)]


def build_cases():
    """The JAX tests' cases: gpt_tiny calibrated on its 4 x 16 prompt and
    decoding 20 tokens (``test_sharding.test_tp_generate_bit_exact``), the
    other families one block deep at small widths; the default
    QuantConfig."""
    rng = np.random.default_rng(0)
    cases = []
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
    res = result(world, "speculative_refused")
    assert res["type"] == "NotImplementedError"
    assert "next slice" in res["message"]
