"""PyTorch port vs JAX package: the INT8 artifact (``utils.checkpoint``),
mirroring ``tests/test_checkpoint.py`` case for case:

* quantized and FP32 round trips through .npz and .safetensors, the
  branching models' weightless layers, ``read_state_dict``'s three formats
  and its errors, the architecture and layer-type mismatches, a newer
  format, a safetensors file without the i8ie header, ``state_dict``'s flat
  view, and the decoder families' round trips (gpt W8A8 and W8-float);

and beyond it:

* **across packages**: the JAX package's artifact of its own converted
  LeNet and of a grouped-conv CNN (depthwise and two-group convs), and
  the port's artifact of the same state carried by ``load_jax_state``,
  are equal: meta for meta, every array by dtype, shape and bytes; the
  JAX package loads the port's LeNet artifact and gives its own codes,
  and the port loads the JAX package's and gives the carried model's
  codes (the decoders' and encoders' cases are in their own files);
* **the port's own round trip** is exact for the lifecycle's other modes:
  bias-corrected, an FP32 island, the LUT ``QuantAct``, W8-float and
  dynamic convs, and a load into a model that has already generated.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import int8inferenceengine_tpu as qj
from int8inferenceengine_tpu import utils as jutils
from int8inferenceengine_tpu.models import zoo as jzoo
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch import utils
from int8inferenceengine_tpu_torch.carry import load_jax_state
from int8inferenceengine_tpu_torch.models import zoo as tzoo
from test_torch_text_decoder import jax_state
from test_torch_threads import one_torch_thread  # noqa: F401


def _rand(shape, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _cpu(x):
    return qt.tensor(x, device="cpu")


def _calibrated(name="lenet", batch=16, config=qt.DEFAULT_CONFIG, skip=()):
    m = tzoo.build(name, config=config, device="cpu")
    m.load(tzoo.torch_twin(name).state_dict())
    shape = (batch,) + m.INPUT_SHAPE
    m.prepare()
    m(_cpu(_rand(shape)))
    m.convert(skip=skip)
    return m, shape


def assert_artifacts_equal(path_a, path_b):
    """Two .npz artifacts hold the same meta and the same arrays: dtype,
    shape and bytes."""
    with np.load(path_a) as a, np.load(path_b) as b:
        assert sorted(a.files) == sorted(b.files)
        assert json.loads(bytes(a["__meta__"])) == \
            json.loads(bytes(b["__meta__"]))
        for k in a.files:
            x, y = a[k], b[k]
            assert (x.dtype, x.shape) == (y.dtype, y.shape), k
            assert x.tobytes() == y.tobytes(), k


def install_state(jm, state):
    """A JAX package Module holding ``state`` (``jax_state``'s format), as
    its own lifecycle left it; returns the Module."""
    for name, layer in jm.named_layers():
        st = state[name]
        layer.params = {k: jnp.asarray(v) for k, v in st["params"].items()}
        ws = st["weight_scale"]
        layer.weight_scale = ws if isinstance(ws, float) else jnp.asarray(ws)
        layer.scale, layer.zero_point = st["scale"], st["zero_point"]
        layer.is_quantized = st["is_quantized"]
        layer.is_preparing, layer.calibrator = False, None
    jm.is_quant = any(st["is_quantized"] for st in state.values())
    return jm


def assert_same_artifact(jm, m, tmp_path):
    """The JAX package's artifact of ``jm`` and the port's of ``m`` are
    equal; returns their paths (JAX's, the port's)."""
    jp, tp = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jutils.save(jm, jp)
    utils.save(m, tp)
    assert_artifacts_equal(tp, jp)
    return jp, tp


@pytest.mark.parametrize("ext", ["npz", "safetensors"])
def test_quantized_roundtrip(tmp_path, ext):
    mm, shape = _calibrated()
    x = _rand(shape, 1)
    base = mm(_cpu(x)).numpy()
    path = str(tmp_path / f"lenet_int8.{ext}")
    utils.save(mm, path)
    fresh = tzoo.build("lenet", device="cpu")
    assert utils.load(fresh, path) is fresh
    assert fresh.is_quant
    np.testing.assert_array_equal(fresh(_cpu(x)).numpy(), base)


def test_fp32_roundtrip(tmp_path):
    mm = tzoo.build("fc_mnist", device="cpu")
    mm.load(tzoo.torch_twin("fc_mnist").state_dict())
    x = _rand((8, 1, 28, 28))
    base = mm(_cpu(x)).numpy()
    path = str(tmp_path / "fc_fp32.npz")
    utils.save(mm, path)
    fresh = tzoo.build("fc_mnist", device="cpu")
    utils.load(fresh, path)
    assert not fresh.is_quant
    np.testing.assert_array_equal(fresh(_cpu(x)).numpy(), base)


def test_read_state_dict_formats(tmp_path):
    """``Module.load`` ingests .pt / .npz / .safetensors files alike."""
    from safetensors.numpy import save_file

    tm = tzoo.torch_twin("fc_mnist")
    sd_np = {k: v.numpy() for k, v in tm.state_dict().items()}
    pt, npz, st = (str(tmp_path / f"w.{e}") for e in
                   ("pt", "npz", "safetensors"))
    torch.save(tm.state_dict(), pt)
    np.savez(npz, **sd_np)
    save_file(sd_np, st)
    x = _rand((4, 1, 28, 28))
    outs = []
    for path in (pt, npz, st):
        sd = utils.read_state_dict(path)
        assert all(isinstance(v, np.ndarray) for v in sd.values())
        mm = tzoo.build("fc_mnist", device="cpu")
        mm.load(sd)
        outs.append(mm(_cpu(x)).numpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])


@pytest.mark.parametrize("case", ["no_header", "extension", "architecture",
                                  "layer_type", "newer"])
def test_errors_match_jax(tmp_path, case):
    """Each bad file raises the JAX package's ``ValueError`` with its
    message, in both packages."""
    from safetensors.numpy import save_file

    path = str(tmp_path / "w.npz")
    if case == "no_header":
        path = str(tmp_path / "plain.safetensors")
        save_file({"fc1.weight": np.zeros((10, 784), np.float32)}, path)
        args, match = ("fc_mnist",), "not an i8ie checkpoint"
    elif case == "extension":
        for u in (utils, jutils):
            with pytest.raises(ValueError, match="unsupported extension"):
                u.read_state_dict(str(tmp_path / "w.npy"))
        return
    else:
        utils.save(_calibrated("fc_mnist", batch=4)[0], path)
        if case == "architecture":
            args, match = ("lenet",), "architecture mismatch"
        elif case == "layer_type":
            args = ("fc_mnist",)
            with np.load(path) as z:
                arrays = dict(z)
            meta = json.loads(bytes(arrays["__meta__"]))
            meta["layers"]["fc1"]["type"] = "Conv2d"
            arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                               np.uint8)
            np.savez(path, **arrays)
            match = "checkpoint has Conv2d, model has Linear"
        else:
            with np.load(path) as z:
                arrays = dict(z)
            meta = json.loads(bytes(arrays["__meta__"]))
            meta["format_version"] = 2
            arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                               np.uint8)
            np.savez(path, **arrays)
            args, match = ("fc_mnist",), "newer than supported v1"
    for u, build in ((utils, lambda n: tzoo.build(n, device="cpu")),
                     (jutils, jzoo.build)):
        with pytest.raises(ValueError, match=match):
            u.load(build(*args), path)


def test_safetensors_needs_its_package(tmp_path, monkeypatch):
    """Without ``safetensors`` a .safetensors path raises ImportError; it
    never falls back to .npz."""
    import sys
    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "safetensors.numpy", None)
    mm = tzoo.build("fc_mnist", device="cpu")
    path = tmp_path / "w.safetensors"
    with pytest.raises(ImportError):
        utils.save(mm, str(path))
    assert not path.exists() and not list(tmp_path.iterdir())


def test_state_dict_flat_view():
    mm, _ = _calibrated("fc_mnist", batch=4)
    sd = utils.state_dict(mm)
    assert "fc1.qw_kn" in sd and sd["fc1.qw_kn"].dtype == np.int8
    assert sd["fc1.qw_kn"].shape == (784, 10)
    assert sorted(sd) == ["fc1.q_bias", "fc1.qw_kn", "fc1.rowsum"]


@pytest.mark.parametrize("name", ["squeezenet", "googlenet",
                                  "mobilenet_v3_small"])
def test_quantized_roundtrip_branching_models(tmp_path, name):
    """QuantConcat / QuantAdd / QuantAct / QuantMul layers (weightless,
    calibrated) persist their (scale, zp) through the artifact too."""
    mm = tzoo.build(name, device="cpu")
    mm.load(tzoo.torch_twin(name).state_dict())
    x = _rand((2, 3, 64, 64))
    mm.prepare()
    mm(_cpu(x))
    mm.convert()
    base = mm(_cpu(x)).numpy()
    path = str(tmp_path / f"{name}_int8.npz")
    utils.save(mm, path)
    fresh = tzoo.build(name, device="cpu")
    utils.load(fresh, path)
    np.testing.assert_array_equal(fresh(_cpu(x)).numpy(), base)


@pytest.mark.parametrize("mode", ["w8a8", "weight_only"])
def test_roundtrip_new_families(tmp_path, mode):
    """Quantized-artifact checkpoints cover the decoder and weight-only
    modes: reload reproduces outputs and greedy tokens bit for bit."""
    cfg = qt.QuantConfig(weight_only=mode == "weight_only")
    rng = np.random.default_rng(0)
    m = tzoo.build("gpt_tiny", config=cfg, device="cpu")
    m.load(tzoo.torch_twin("gpt_tiny").state_dict())
    ids = rng.integers(0, 1000, (4, 32)).astype(np.int32)
    if not cfg.weight_only:
        m.prepare()
        m(_cpu(ids))
    m.convert()
    want = m(_cpu(ids)).numpy()
    gen_want = m.generate(ids[:, :8], 5)
    utils.save(m, str(tmp_path / "ck.npz"))
    m2 = tzoo.build("gpt_tiny", config=cfg, device="cpu")
    utils.load(m2, str(tmp_path / "ck.npz"))
    np.testing.assert_array_equal(m2(_cpu(ids)).numpy(), want)
    np.testing.assert_array_equal(m2.generate(ids[:, :8], 5), gen_want)


# -- across packages -----------------------------------------------------------

class GroupedNet(qt.Module):
    """A grouped-conv CNN: depthwise, two-group and pointwise convs."""

    def __init__(self, device="cpu"):
        super().__init__(device=device)
        self.conv1 = qt.Conv2d(3, 8, 3, padding=1, device=device)
        self.dw = qt.Conv2d(8, 8, 3, stride=2, padding=1, groups=8,
                            device=device)
        self.g2 = qt.Conv2d(8, 16, 1, groups=2, device=device)
        self.fc = qt.Linear(16 * 8 * 8, 10, device=device)

    def forward(self, x):
        x = qt.relu(self.conv1(x))
        x = qt.relu(self.g2(qt.relu(self.dw(x))))
        return self.fc(x.reshape(x.shape[0], -1))


class JGroupedNet(qj.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = qj.Conv2d(3, 8, 3, padding=1)
        self.dw = qj.Conv2d(8, 8, 3, stride=2, padding=1, groups=8)
        self.g2 = qj.Conv2d(8, 16, 1, groups=2)
        self.fc = qj.Linear(16 * 8 * 8, 10)

    def forward(self, x):
        x = qj.relu(self.conv1(x))
        x = qj.relu(self.g2(qj.relu(self.dw(x))))
        return self.fc(x.reshape(x.shape[0], -1))


def _grouped_state():
    rng = np.random.default_rng(7)
    sd = {}
    for name, shape in (("conv1", (8, 3, 3, 3)), ("dw", (8, 1, 3, 3)),
                        ("g2", (16, 4, 1, 1)), ("fc", (10, 1024))):
        sd[f"{name}.weight"] = rng.normal(0, 0.3, shape).astype(np.float32)
        sd[f"{name}.bias"] = rng.normal(0, 0.1, shape[0]).astype(np.float32)
    return sd


@pytest.fixture(scope="module")
def jax_cnns(tmp_path_factory):
    """The JAX package's own lifecycle on LeNet and the grouped-conv CNN,
    its artifacts, and its LeNet codes."""
    d = tmp_path_factory.mktemp("jax_cnns")
    out = {}
    for name, build, sd, shape in (
            ("lenet", lambda: jzoo.build("lenet"),
             jzoo.torch_twin("lenet").state_dict(), (8, 1, 28, 28)),
            ("grouped", JGroupedNet, _grouped_state(), (4, 3, 16, 16))):
        jm = build()
        jm.load(sd)
        jm.prepare()
        jm(qj.tensor(_rand(shape)))
        jm.convert()
        path = str(d / f"{name}_jax.npz")
        jutils.save(jm, path)
        out[name] = dict(state=jax_state(jm), path=path, shape=shape)
    x = _rand(out["lenet"]["shape"], 1)
    out["lenet"].update(x=x, codes=jm_codes(out["lenet"]["path"], x))
    return out


def jm_codes(path, x):
    """The output of the JAX package's LeNet loaded from ``path``."""
    jm = jzoo.build("lenet")
    jutils.load(jm, path)
    return jm(qj.tensor(x)).numpy()


def _port(name):
    return (tzoo.build("lenet", device="cpu") if name == "lenet"
            else GroupedNet())


@pytest.mark.parametrize("name", ["lenet", "grouped"])
def test_port_artifact_of_carried_state_equals_jax(jax_cnns, tmp_path,
                                                   name):
    m = _port(name)
    load_jax_state(m, jax_cnns[name]["state"])
    path = str(tmp_path / "port.npz")
    utils.save(m, path)
    assert_artifacts_equal(path, jax_cnns[name]["path"])


def test_artifacts_load_across_packages(jax_cnns, tmp_path):
    """The port loads the JAX package's LeNet artifact and gives the
    carried model's codes; the JAX package loads the port's and gives its
    own."""
    r = jax_cnns["lenet"]
    carried = _port("lenet")
    load_jax_state(carried, r["state"])
    want = carried(_cpu(r["x"])).numpy()
    m = utils.load(_port("lenet"), r["path"])
    np.testing.assert_array_equal(m(_cpu(r["x"])).numpy(), want)
    path = str(tmp_path / "port.npz")
    utils.save(m, path)
    np.testing.assert_array_equal(jm_codes(path, r["x"]), r["codes"])
    np.testing.assert_array_equal(want, r["codes"])


@pytest.mark.parametrize("mode", [dict(weight_only=True),
                                  dict(weight_only=True, dynamic_act=True)])
def test_weight_only_artifact_equals_jax(tmp_path, mode):
    """W8-float and dynamic: the JAX package's LeNet converted in its own
    lifecycle (no calibration) and the port's carried copy write the same
    artifact, and the port loads JAX's with the carried model's output."""
    jm = jzoo.build("lenet", config=qj.QuantConfig(**mode))
    jm.load(jzoo.torch_twin("lenet").state_dict())
    jm.convert()
    carried = tzoo.build("lenet", config=qt.QuantConfig(**mode),
                         device="cpu")
    load_jax_state(carried, jax_state(jm))
    jp, _ = assert_same_artifact(jm, carried, tmp_path)
    x = _cpu(_rand((2, 1, 28, 28)))
    got = utils.load(tzoo.build("lenet", config=qt.QuantConfig(**mode),
                                device="cpu"), jp)
    np.testing.assert_array_equal(got(x).numpy(), carried(x).numpy())


def test_grouped_artifact_loads_in_port(jax_cnns):
    r = jax_cnns["grouped"]
    carried = GroupedNet()
    load_jax_state(carried, r["state"])
    x = _cpu(_rand(r["shape"], 2))
    got = utils.load(GroupedNet(), r["path"])(x).numpy()
    np.testing.assert_array_equal(got, carried(x).numpy())


# -- the port's own round trips -----------------------------------------------

def _roundtrip(m, build, x, tmp_path, ext="npz"):
    path = str(tmp_path / f"m.{ext}")
    utils.save(m, path)
    fresh = utils.load(build(), path)
    np.testing.assert_array_equal(fresh(x).numpy(), m(x).numpy())
    return fresh


@pytest.mark.parametrize("mode", ["bias_correction", "fp32_island",
                                  "per_channel"])
def test_lifecycle_modes_roundtrip(tmp_path, mode):
    cfg = qt.QuantConfig(bias_correction=mode == "bias_correction",
                         weight_per_channel=mode == "per_channel")
    skip = ("fc2",) if mode == "fp32_island" else ()
    m, shape = _calibrated(config=cfg, skip=skip)
    fresh = _roundtrip(m, lambda: tzoo.build("lenet", config=cfg,
                                              device="cpu"),
                       _cpu(_rand(shape, 3)), tmp_path)
    assert fresh.fc2.quant_fallback == bool(skip)
    sd = utils.state_dict(fresh)
    if skip:
        assert {"fc2.weight", "fc2.bias"} <= set(sd)
    if mode == "per_channel":
        assert sd["conv1.w_scale"].shape == (20,)


@pytest.mark.parametrize("dynamic", [False, True])
def test_weight_only_cnn_roundtrip(tmp_path, dynamic):
    """W8-float and dynamic convs and Linears (``q_w_hwio``, ``q_weight``
    with the float bias)."""
    cfg = qt.QuantConfig(weight_only=True, dynamic_act=dynamic)
    m = tzoo.build("lenet", config=cfg, device="cpu")
    m.load(tzoo.torch_twin("lenet").state_dict())
    m.convert()
    _roundtrip(m, lambda: tzoo.build("lenet", config=cfg, device="cpu"),
               _cpu(_rand((4, 1, 28, 28))), tmp_path, "safetensors")
    assert set(utils.state_dict(m)) >= {"conv1.q_w_hwio", "conv1.bias",
                                         "fc1.q_weight", "fc1.bias"}


class ActNet(qt.Module):
    def __init__(self, backend):
        super().__init__(device="cpu")
        self.fc1 = qt.Linear(16, 32, device="cpu")
        self.act = qt.QuantAct("gelu", backend=backend, device="cpu")
        self.fc2 = qt.Linear(32, 8, device="cpu")

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


def test_lut_act_roundtrip_and_stale_tables(tmp_path):
    """The LUT ``QuantAct`` round trips; a model that has built its tables
    on an old grid rebuilds them after a load."""
    rng = np.random.default_rng(4)
    sd = {"fc1.weight": rng.normal(0, 0.3, (32, 16)),
          "fc1.bias": rng.normal(0, 0.1, 32),
          "fc2.weight": rng.normal(0, 0.3, (8, 32)),
          "fc2.bias": rng.normal(0, 0.1, 8)}

    def calibrated(scale):
        m = ActNet("lut")
        m.load(sd)
        m.prepare()
        m(_cpu(_rand((8, 16), 5) * scale))
        m.convert()
        return m

    x = _cpu(_rand((6, 16), 6))
    a, b = calibrated(1.0), calibrated(3.0)
    want = a(x).numpy()
    b(x)
    assert b.act._luts
    path = str(tmp_path / "a.npz")
    utils.save(a, path)
    utils.load(b, path)
    np.testing.assert_array_equal(b(x).numpy(), want)
    elementwise = utils.load(ActNet("elementwise"), path)
    np.testing.assert_array_equal(elementwise(x).numpy(), want)


def test_load_into_a_model_that_has_generated(tmp_path):
    """A decoder that has run (its operands cached per input grid) and is
    loaded with another artifact gives that artifact's tokens."""
    sd = tzoo.torch_twin("gpt_tiny").state_dict()
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 1000, (2, 8)).astype(np.int32)

    def calibrated(seed, t):
        m = tzoo.build("gpt_tiny", device="cpu")
        m.load(sd)
        m.prepare()
        m(_cpu(np.random.default_rng(seed).integers(
            0, 1000, (4, t)).astype(np.int32)))
        m.convert()
        return m

    a, b = calibrated(2, 32), calibrated(3, 12)
    want = a.generate(ids, 6)
    assert not np.array_equal(b.generate(ids, 6), want) or \
        b.head.scale != a.head.scale
    utils.save(a, str(tmp_path / "a.npz"))
    utils.load(b, str(tmp_path / "a.npz"))
    np.testing.assert_array_equal(b.generate(ids, 6), want)
    np.testing.assert_array_equal(b(_cpu(ids)).numpy(), a(_cpu(ids)).numpy())
