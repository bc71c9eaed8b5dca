"""PyTorch port vs JAX package: the parallel roles of the forward
(``int8inferenceengine_tpu_torch/parallel``, ``Module.shard``).

One world of 4 gloo ranks on the CPU (``parallel.launch.run_world``,
started once by the module-scope fixture, its store in the test's
temporary directory) runs every case of this file
(``tests/torch_parallel_ranks.py``) while this process computes the JAX
package's references on the same seed-made inputs: the JAX model holding
the port's state (``carry.export_state``, installed as
``tests/test_torch_cnn_zoo.py`` installs it), sharded on 4 of conftest's 8
virtual devices over the same mesh shape, and unsharded, each compiled
once without XLA's algebraic simplifier (``exact_jit``).  Each case is its
own test; every rank must return the same result.

The cases are those of ``tests/test_sharding.py``, ``tests/test_overlap.py``
and ``tests/test_moe.py`` at 4 ranks: LeNet INT8 on (4, 1), (2, 2) and (1,
4) and in overlap mode; FP32 at atol 1e-5; ``fc_mnist``'s replicated head;
the pre-quantized fast path with and without overlap; a batch that does
not divide; mesh validation; shard before convert; new weights loaded
after ``shard()`` (``Module.load``, ``utils.load``, ``load_state_dict``)
reaching the shards; ``text_tiny`` and
``gpt_tiny``; ViT with 4 heads and with 3 heads over model 2;
``ring_qgemm`` against the gathered GEMM; expert parallelism, its FP32
serving and experts that do not divide; and the two refusals of a
row-parallel Linear (an input tap, bias correction while preparing).
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import int8inferenceengine_tpu as jq
from int8inferenceengine_tpu.models import zoo as jzoo
from int8inferenceengine_tpu.ops.gemm_int8 import \
    compute_offset as jcompute_offset
from int8inferenceengine_tpu.parallel.mesh import make_mesh as jmake_mesh
from int8inferenceengine_tpu.parallel.overlap import \
    ring_linear_reference as jring_reference
from int8inferenceengine_tpu.parallel.sharding import \
    sharded_forward as jsharded_forward
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch.carry import export_state
from int8inferenceengine_tpu_torch.models import zoo as tzoo
from int8inferenceengine_tpu_torch.ops.gemm_int8 import (compute_offset,
                                                         epilogue_vector)
from int8inferenceengine_tpu_torch.parallel.launch import run_world
import torch
import torch_parallel_ranks as R
from test_torch_cnn_zoo import exact_jit, install_jax_state, jax_forward
from test_torch_threads import one_torch_thread  # noqa: F401

WORLD = 4
WORLD_S = 240            # the world's time limit (and each collective's)
JAX_THREADS = 3
LENET_MESHES = [((4, 1), False), ((2, 2), False), ((1, 4), False),
                ((2, 2), True), ((1, 4), True)]
RING_KW = dict(scale_a=0.025, zp_a=127, scale_w=0.01, scale_c=0.05, zp_c=93)


def _rand(rng, shape):
    return rng.uniform(-1, 1, shape).astype(np.float32)


def twin_state(name, **kw):
    """The FP32 weights of ``name``'s torch twin at geometry ``kw``."""
    from int8inferenceengine_tpu_torch.models import (bloom, llama, moe,
                                                      neox, vit)
    from int8inferenceengine_tpu_torch.models.text_decoder import \
        torch_text_decoder
    if not kw:
        return tzoo.torch_twin(name).state_dict()
    twin = {"vit_tiny": vit.torch_vit, "moe_tiny": moe.torch_moe,
            "gpt_tiny": torch_text_decoder, "llama_tiny": llama.torch_llama,
            "bloom_tiny": bloom.torch_bloom,
            "neox_tiny": neox.torch_neox}[name]
    return twin(**kw).state_dict()


def _loaded(name, cfg=None, **kw):
    m = tzoo.build(name, config=qt.QuantConfig(**(cfg or {})), device="cpu",
                   **kw)
    m.load(twin_state(name, **kw))
    return m


def _converted(name, x_calib, **kw):
    m = _loaded(name, **kw)
    m.prepare()
    m(qt.tensor(x_calib, device="cpu"))
    m.convert()
    return m


def _model_case(name, kind, m, spec, **more):
    return dict(name=name, kind=kind, model=spec, state=export_state(m),
                **more)


def build_cases():
    rng = np.random.default_rng(0)
    cases = []
    x16 = _rand(rng, (16, 1, 28, 28))
    lenet = _converted("lenet", _rand(rng, (16, 1, 28, 28)))
    spec = ("lenet", {}, {})
    cases.append(_model_case("lenet_int8", "forward", lenet, spec, x=x16,
                             meshes=LENET_MESHES,
                             flags=("conv1", "conv2", "fc1", "fc2")))
    cases.append(_model_case("lenet_fast_path", "forward", lenet, spec,
                             x=x16, quantized_input=True,
                             meshes=[((2, 2), False), ((1, 4), False),
                                     ((2, 2), True)]))
    fp32 = _loaded("lenet")
    cases.append(_model_case("lenet_fp32", "forward", fp32, spec, x=x16,
                             meshes=[((2, 2), False)]))
    calib = _rand(rng, (16, 1, 28, 28))
    cases.append(_model_case(
        "shard_before_convert", "shard_before_convert", fp32, spec,
        mesh=(2, 2), calib=calib, x=x16,
        converted=export_state(_converted("lenet", calib))))
    # new weights for load_after_shard: the twin's, negated
    new_sd = {k: -v.numpy() for k, v in twin_state("lenet").items()}
    new_fp32 = _loaded("lenet")
    new_fp32.load(new_sd)
    new_fp32.prepare()
    new_fp32(qt.tensor(calib, device="cpu"))
    new_fp32.convert()
    cases.append(_model_case(
        "load_after_shard", "load_after_shard", lenet, spec, mesh=(2, 2),
        x=x16, fp32_state=export_state(fp32), new_sd=new_sd,
        new_state=export_state(new_fp32)))
    x32 = _rand(rng, (32, 1, 28, 28))
    fc = _converted("fc_mnist", _rand(rng, (32, 1, 28, 28)))
    cases.append(_model_case("fc_mnist", "forward", fc, ("fc_mnist", {}, {}),
                             x=x32, meshes=[((1, 4), False), ((2, 2), True)],
                             flags=("fc1",)))
    cases.append(_model_case("batch_not_divisible", "raises", lenet, spec,
                             what="batch", shape=(4, 1),
                             x=_rand(rng, (6, 1, 28, 28))))
    cases.append(dict(name="mesh_validation", kind="raises", what="mesh",
                      shape=(3, 2)))
    for name in ("text_tiny", "gpt_tiny"):
        t = tzoo.build(name, device="cpu").INPUT_SHAPE[0]
        ids = rng.integers(0, 1000, (8, t)).astype(np.int32)
        m = _converted(name, ids)
        cases.append(_model_case(name, "forward", m, (name, {}, {}), x=ids,
                                 meshes=[((2, 2), False)]))
    for name, geo, meshes in (
            ("vit_heads4", dict(img_size=32, patch=8, dim=64, depth=2,
                                heads=4, num_classes=10),
             [((2, 2), False), ((1, 4), False)]),
            ("vit_heads3", dict(img_size=32, patch=8, dim=66, depth=1,
                                heads=3, num_classes=10),
             [((2, 2), False)])):
        m = _converted("vit_tiny", _rand(rng, (4, 3, 32, 32)), **geo)
        cases.append(_model_case(name, "forward", m, ("vit_tiny", geo, {}),
                                 x=_rand(rng, (4, 3, 32, 32)), meshes=meshes,
                                 flags=("wq1", "proj1", "fc1_1", "fc2_1")))
    for p in (2, 4):
        for relu in (False, True):
            r = np.random.default_rng(p)
            m_, k, n = 32, 64 * p, 16 * p
            a = r.integers(0, 256, (m_, k), dtype=np.uint8)
            w_kn = r.integers(-127, 128, (k, n), dtype=np.int8)
            qb = r.integers(-127, 128, (n,), dtype=np.int8)
            w_nk = np.ascontiguousarray(w_kn.T)
            oc = compute_offset(torch.from_numpy(qb), torch.from_numpy(
                w_nk.astype(np.int32).sum(axis=1)), RING_KW["scale_a"],
                RING_KW["zp_a"], recentered=True).numpy()
            ep = epilogue_vector(RING_KW["scale_a"], RING_KW["scale_w"],
                                 RING_KW["scale_c"], n, "cpu").numpy()
            cases.append(dict(
                name=f"ring_p{p}_relu{int(relu)}", kind="ring", p=p,
                a=a, w_nk=w_nk, w_kn=w_kn, qb=qb, oc=oc, ep=ep, relu=relu,
                kw=dict(scale_a=RING_KW["scale_a"], scale_c=RING_KW["scale_c"],
                        zp_c=RING_KW["zp_c"], relu=relu)))
    moe_geo = dict(vocab_size=97, max_len=32, dim=64, depth=2, heads=4,
                   kv_heads=2)
    ids = rng.integers(0, 97, (4, 12)).astype(np.int32)
    for name, extra, convert in (("moe_expert_parallel", {}, True),
                                 ("moe_fp32_serving", {}, False),
                                 ("moe_experts_not_divisible",
                                  dict(n_experts=3, top_k=2), True)):
        geo = dict(moe_geo, **extra)
        m = (_converted("moe_tiny", ids, **geo) if convert
             else _loaded("moe_tiny", **geo))
        cases.append(_model_case(name, "forward", m, ("moe_tiny", geo, {}),
                                 x=ids, meshes=[((2, 2), False)],
                                 flags=("moe1", "wq1", "proj1")))
    gpt = dict(vocab_size=97, max_len=16, dim=128, depth=2, heads=4)
    ids = rng.integers(0, 97, (4, 16)).astype(np.int32)
    m = tzoo.build("gpt_tiny", device="cpu", **gpt)
    cases.append(_model_case("refuse_row_parallel_tap", "raises", m,
                             ("gpt_tiny", gpt, {}), what="tap", shape=(2, 2),
                             x=ids.astype(np.float32)))
    m = tzoo.build("gpt_tiny", device="cpu",
                   config=qt.QuantConfig(bias_correction=True), **gpt)
    cases.append(_model_case("refuse_row_parallel_bias_correction", "raises",
                             m, ("gpt_tiny", gpt, dict(bias_correction=True)),
                             what="bias_correction", shape=(2, 2),
                             layer="proj1", x=_rand(rng, (8, 128))))
    return cases


def jax_model(case):
    """The JAX package's model of the case holding the port's state."""
    name, kw, cfg = case["model"]
    jm = jzoo.build(name, config=jq.QuantConfig(**cfg), **kw)
    if case["state"][next(iter(case["state"]))]["is_quantized"]:
        install_jax_state(jm, case["state"])
    else:
        for lname, layer in jm.named_layers():
            layer.params = {k: jnp.asarray(v) for k, v in
                            case["state"][lname]["params"].items()}
    return jm


def jax_sharded(jm, x, shape, overlap=False):
    jm.shard(jmake_mesh(shape, devices=jax.devices()[:WORLD]),
             overlap=overlap)
    return np.asarray(exact_jit(jsharded_forward(jm), jm._gather_params(),
                                jnp.asarray(x)))


def jax_refs(cases) -> dict:
    refs = {}
    for case in cases:
        name = case["name"]
        if case["kind"] == "forward" and not case.get("quantized_input"):
            x = case["x"]
            jm = jax_model(case)
            ref = {"base": jax_forward(jm, x)}
            for shape, overlap in case["meshes"]:
                ref[R.mesh_key(shape, overlap)] = jax_sharded(
                    jm, x, shape, overlap)
            refs[name] = ref
        elif case["kind"] == "ring":
            refs[name] = np.asarray(jring_reference(
                jnp.asarray(case["a"]), jnp.asarray(case["w_kn"]),
                jcompute_offset(jnp.asarray(case["qb"]), jnp.asarray(
                    case["w_kn"].astype(np.int32).sum(axis=0)),
                    scale_a=RING_KW["scale_a"], zp_a=RING_KW["zp_a"],
                    recentered=True), relu=case["relu"], **RING_KW))
        elif case["kind"] == "shard_before_convert":
            # the unsharded conversion on the same calibration batch (the
            # port's, in the JAX package's forward)
            jm = jax_model(dict(case, state=case["converted"]))
            refs[name] = jax_forward(jm, case["x"])
    return refs


def spawn_world(cases, references, tmp_path_factory):
    """(each rank's {case: result}, the JAX package's references of every
    case, the cases by name): the world of ``WORLD`` gloo ranks runs the
    cases in a thread while this process computes ``references([case])``
    for each case in ``JAX_THREADS`` threads (XLA compiles without the
    interpreter lock; each case has its own JAX model)."""
    box = {}

    def spawn():
        try:
            box["ranks"] = run_world(
                R.run_cases, WORLD, args=(cases,), device="cpu",
                timeout_s=WORLD_S,
                store_dir=str(tmp_path_factory.mktemp("world")))
        except BaseException as e:          # re-raised below
            box["error"] = e

    spawner = threading.Thread(target=spawn)
    spawner.start()
    refs = {}
    try:
        with ThreadPoolExecutor(JAX_THREADS) as pool:
            for part in pool.map(lambda c: references([c]), cases):
                refs.update(part)
    finally:
        spawner.join(WORLD_S + 60)
    if "error" in box:
        raise box["error"]
    return box["ranks"], refs, {c["name"]: c for c in cases}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawn_world(build_cases(), jax_refs, tmp_path_factory)


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def result(world, name):
    """Rank 0's result of case ``name``, after checking that every rank
    returned the same."""
    ranks = world[0]
    res = ranks[0][name]
    assert "error" not in res, res["error"]
    for r, other in enumerate(ranks[1:], 1):
        assert _same(res, other[name]), f"rank {r} differs from rank 0"
    return res


@pytest.mark.parametrize("mesh,overlap", LENET_MESHES)
def test_lenet_int8_sharded_equals_unsharded_and_jax(world, mesh, overlap):
    res, refs = result(world, "lenet_int8"), world[1]["lenet_int8"]
    key = R.mesh_key(mesh, overlap)
    np.testing.assert_array_equal(res["out"][key], res["base"])
    np.testing.assert_array_equal(res["base"], refs["base"])
    np.testing.assert_array_equal(res["out"][key], refs[key])
    flags = res["flags"][key]
    assert flags["conv1"][0] == (mesh[1] > 1)          # 20 channels divide
    assert flags["conv2"][0] == (mesh[1] == 2)         # 50 % 4 != 0
    assert flags["fc2"][0] == (mesh[1] == 2)           # 10 % 4 != 0
    # overlap: fc2 ring-consumes fc1's channel shard where it shards
    assert res["ring"][key] == (1 if overlap and mesh[1] == 2 else 0)


def test_fp32_sharded_equals_unsharded(world):
    res, refs = result(world, "lenet_fp32"), world[1]["lenet_fp32"]
    np.testing.assert_allclose(res["out"]["2x2"], res["base"], atol=1e-5)
    np.testing.assert_allclose(res["out"]["2x2"], refs["2x2"], atol=1e-5)


@pytest.mark.parametrize("key", ["1x4", "2x2_overlap"])
def test_linear_only_model_tp(world, key):
    res, refs = result(world, "fc_mnist"), world[1]["fc_mnist"]
    np.testing.assert_array_equal(res["out"][key], res["base"])
    np.testing.assert_array_equal(res["out"][key], refs[key])
    # fc 784 -> 10: replicated over model 4, sharded over model 2
    assert res["flags"][key]["fc1"][0] == (key != "1x4")


@pytest.mark.parametrize("key", ["2x2", "1x4", "2x2_overlap"])
def test_quantized_input_fast_path_sharded(world, key):
    res = result(world, "lenet_fast_path")
    np.testing.assert_array_equal(res["out"][key], res["out"][key + "_float"])
    np.testing.assert_array_equal(res["out"][key], res["base"])
    # the same model and input as lenet_int8: its JAX references
    np.testing.assert_array_equal(res["out"][key],
                                  world[1]["lenet_int8"][key])


def test_batch_not_divisible_raises_cleanly(world):
    res = result(world, "batch_not_divisible")
    assert res["type"] == "ValueError" and "data axis" in res["message"]


def test_mesh_shape_validation(world):
    res = result(world, "mesh_validation")
    assert res["type"] == "ValueError"
    assert res["message"] == "mesh shape (3, 2) != 4 devices"


def test_shard_before_convert_stays_sharded(world):
    res = result(world, "shard_before_convert")
    assert res["sharded"]
    assert {"qw", "q_bias", "rowsum", "w_scale"} <= set(res["conv1_slices"])
    np.testing.assert_array_equal(res["out"],
                                  world[1]["shard_before_convert"])


@pytest.mark.parametrize("writer", ["module_load", "utils_load",
                                    "load_state_dict"])
def test_weights_loaded_after_shard_reach_the_shards(world, writer):
    res = result(world, "load_after_shard")[writer]
    assert not np.array_equal(res["after"], res["before"])
    if writer == "module_load":                  # FP32
        np.testing.assert_allclose(res["after"], res["unsharded"],
                                   atol=1e-5)
    else:
        np.testing.assert_array_equal(res["after"], res["unsharded"])


@pytest.mark.parametrize("name", ["text_tiny", "gpt_tiny"])
def test_text_models_shard_bit_exact(world, name):
    res, refs = result(world, name), world[1][name]
    np.testing.assert_array_equal(res["out"]["2x2"], res["base"])
    np.testing.assert_array_equal(res["out"]["2x2"], refs["2x2"])
    np.testing.assert_array_equal(res["base"], refs["base"])


@pytest.mark.parametrize("name,key", [("vit_heads4", "2x2"),
                                      ("vit_heads4", "1x4"),
                                      ("vit_heads3", "2x2")])
def test_transformer_tp_vit_bit_exact(world, name, key):
    res, refs = result(world, name), world[1][name]
    np.testing.assert_array_equal(res["out"][key], res["base"])
    np.testing.assert_array_equal(res["out"][key], refs[key])
    flags = res["flags"][key]
    # head-local QKV where the heads divide the model axis (3 over 2: no)
    assert flags["wq1"][1] == (name == "vit_heads4")
    assert flags["proj1"][2] and flags["fc2_1"][2] and flags["fc1_1"][1]
    assert res["row"][key] > 0


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("relu", [False, True])
def test_ring_qgemm_matches_gathered(world, p, relu):
    name = f"ring_p{p}_relu{int(relu)}"
    res = result(world, name)
    np.testing.assert_array_equal(res["got"], res["reference"])
    np.testing.assert_array_equal(res["got"], world[1][name])


def test_expert_parallel_bit_exact(world):
    res, refs = result(world, "moe_expert_parallel"), \
        world[1]["moe_expert_parallel"]
    flags = res["flags"]["2x2"]
    assert flags["moe1"][3], "expert role did not engage"
    assert flags["wq1"][1] and flags["proj1"][2]   # attention TP composes
    np.testing.assert_array_equal(res["out"]["2x2"], res["base"])
    np.testing.assert_array_equal(res["out"]["2x2"], refs["2x2"])


def test_expert_parallel_fp32_serving(world):
    res, refs = result(world, "moe_fp32_serving"), \
        world[1]["moe_fp32_serving"]
    assert res["flags"]["2x2"]["moe1"][3]
    np.testing.assert_allclose(res["out"]["2x2"], res["base"], atol=2e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(res["out"]["2x2"], refs["2x2"], atol=2e-5,
                               rtol=1e-5)


def test_experts_not_divisible_falls_back_replicated(world):
    res, refs = result(world, "moe_experts_not_divisible"), \
        world[1]["moe_experts_not_divisible"]
    assert not res["flags"]["2x2"]["moe1"][3]     # 3 % 2 != 0
    np.testing.assert_array_equal(res["out"]["2x2"], res["base"])
    np.testing.assert_array_equal(res["out"]["2x2"], refs["2x2"])


@pytest.mark.parametrize("name,match", [
    ("refuse_row_parallel_tap", "input-tap"),
    ("refuse_row_parallel_bias_correction", "bias_correction")])
def test_row_parallel_refusals(world, name, match):
    res = result(world, name)
    assert res["type"] == "RuntimeError" and match in res["message"], res


@pytest.mark.cuda
def test_sharded_forward_on_the_card(tmp_path):
    """One (2, 2) world of 4 ranks sharing the card over gloo: LeNet's
    sharded codes (gather and overlap mode) equal the unsharded card
    run's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the ranks run the port's kernels")
    rng = np.random.default_rng(0)
    lenet = _converted("lenet", _rand(rng, (16, 1, 28, 28)))
    case = _model_case("lenet_card", "forward", lenet, ("lenet", {}, {}),
                       x=_rand(rng, (16, 1, 28, 28)), device="cuda",
                       meshes=[((2, 2), False), ((2, 2), True)])
    ranks = run_world(R.run_cases, WORLD, args=([case],), device="cuda",
                      timeout_s=WORLD_S, store_dir=str(tmp_path))
    for rank in ranks:
        res = rank["lenet_card"]
        assert "error" not in res, res["error"]
        for key in ("2x2", "2x2_overlap"):
            np.testing.assert_array_equal(res["out"][key], res["base"])
