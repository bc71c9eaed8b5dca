"""PyTorch port vs JAX package: observability, roofline accounting and
validation (``utils.observe``, ``utils.roofline``, ``utils.validate``),
mirroring the report, roofline and validate cases of
``tests/test_checkpoint.py``:

* the quantization report (JSON-serialisable, the JAX package's keys,
  calibration counts and zero points) and its JSON lines;
* ``roofline.collect``'s LeNet numbers, and its per-layer ``flops`` and
  ``bytes`` equal to the JAX package's, integer for integer, for LeNet,
  AlexNet-224, ResNet-18, MobileNetV2, vit_tiny, gpt_tiny and llama_tiny
  in W4A8, FP32 and converted (the port's converted state carried into
  the JAX model);
  ``roofline.report``'s shares at the H100's peaks;
* ``validate`` clean and dirty, with the JAX package's findings word for
  word on the same corrupted artifacts;
* ``trace`` writes a profiler trace, ``device_op_times`` reads it (no
  kernel events without a card) and raises ``FileNotFoundError`` without
  one.
"""

import io
import json
import os

import numpy as np
import pytest

import int8inferenceengine_tpu as qj
from int8inferenceengine_tpu import utils as jutils
from int8inferenceengine_tpu.models import zoo as jzoo
from int8inferenceengine_tpu.utils import roofline as jroofline
from int8inferenceengine_tpu.utils import validate as jvalidate
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch import utils
from int8inferenceengine_tpu_torch.carry import export_state
from int8inferenceengine_tpu_torch.models import zoo as tzoo
from int8inferenceengine_tpu_torch.models.vit import torch_vit
from int8inferenceengine_tpu_torch.utils import observe, roofline, validate
from test_torch_checkpoint import install_state
from test_torch_threads import one_torch_thread  # noqa: F401


def _rand(shape, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _cpu(x):
    return qt.tensor(x, device="cpu")


def _calibrated(name="lenet", batch=16, shape=None,
                config=qt.DEFAULT_CONFIG, **kw):
    """A port zoo model (``kw``: the encoder's geometry) loaded with its
    twin's weights and calibrated on one batch (token ids for a
    decoder)."""
    m = tzoo.build(name, config=config, device="cpu", **kw)
    m.load((torch_vit(**kw) if kw else tzoo.torch_twin(name)).state_dict())
    shape = (batch,) + (shape or m.INPUT_SHAPE)
    m.prepare()
    m(_cpu(np.random.default_rng(0).integers(0, 100, shape)
           if m._consumes_ids() else _rand(shape)))
    m.convert()
    return m, shape


def test_quantization_report_matches_jax():
    """The report of a LeNet calibrated in both packages on the same batch:
    the JAX package's keys, types, zero points and calibration counts; the
    ranges within a few float32 ULPs; serialisable end to end."""
    mm, shape = _calibrated()
    jm = jzoo.build("lenet")
    jm.load(jzoo.torch_twin("lenet").state_dict())
    jm.prepare()
    jm(qj.tensor(_rand(shape)))
    jm.convert()
    rep, jrep = utils.quantization_report(mm), jutils.quantization_report(jm)
    assert set(rep) == set(jrep) == {"conv1", "conv2", "fc1", "fc2"}
    for name, rec in rep.items():
        want = jrep[name]
        assert set(rec) == set(want)
        assert rec["is_quantized"] and rec["scale"] > 0
        assert 0 <= rec["zero_point"] <= 255
        assert (rec["type"], rec["zero_point"]) == (want["type"],
                                                    want["zero_point"])
        assert rec["calib"]["count"] == want["calib"]["count"] > 0
        for k in ("min", "max"):
            np.testing.assert_array_max_ulp(
                np.float32(rec["calib"][k]), np.float32(want["calib"][k]),
                maxulp=4)
        assert isinstance(rec["weight_scale"], float)
    json.dumps(rep)
    fresh = tzoo.build("lenet", device="cpu")
    assert utils.quantization_report(fresh)["fc1"]["calib"] is None


def test_log_report_json_lines():
    mm, _ = _calibrated("fc_mnist", batch=4)
    buf = io.StringIO()
    utils.log_quantization_report(mm, stream=buf)
    lines = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert len(lines) == 1 and lines[0]["layer"] == "fc1"
    pc, _ = _calibrated("fc_mnist", batch=4,
                        config=qt.QuantConfig(weight_per_channel=True))
    rec = utils.quantization_report(pc)["fc1"]
    assert isinstance(rec["weight_scale"], list) and \
        len(rec["weight_scale"]) == 10


def test_roofline_collect():
    mm, _ = _calibrated("lenet", batch=4)
    rep = roofline.collect(mm, (1, 28, 28), batch=8)
    # LeNet conv1: 2*8*24*24*20*(1*5*5) ; conv2: 2*8*8*8*50*(20*5*5)
    assert rep["per_layer"]["conv1"]["flops"] == 2 * 8 * 24 * 24 * 20 * 25
    assert rep["per_layer"]["conv2"]["flops"] == 2 * 8 * 8 * 8 * 50 * 20 * 25
    assert rep["per_layer"]["fc1"]["flops"] == 2 * 8 * 800 * 500
    assert rep["total_flops"] > 0 and rep["total_bytes"] > 0

    full = roofline.report(mm, (1, 28, 28), batch=8, measured_s=1e-3)
    assert full["precision"] == "int8"
    assert full["peak_ops"] == 1979e12 and full["peak_hbm_Bps"] == 3.35e12
    assert 0 < full["percent_of_peak"] < 100
    assert full["sol_compute_s"] > 0
    fp = tzoo.build("lenet", device="cpu")
    assert roofline.report(fp, (1, 28, 28), batch=8)["peak_ops"] == 989e12


# name -> (input shape, batch, build kwargs, QuantConfig kwargs); the
# decoders take token ids (the merged QKV, gelu in the GEMM's epilogue,
# the merged W4A8 groups)
ROOF = {"lenet": ((1, 28, 28), 8, {}, {}),
        "alexnet": ((3, 224, 224), 1, {}, {}),
        "resnet18": ((3, 32, 32), 2, {}, {}),
        "mobilenet_v2": ((3, 32, 32), 2, {}, {}),
        "vit_tiny": ((3, 32, 32), 2, dict(img_size=32, patch=8, dim=64,
                                           depth=2, heads=2, mlp_ratio=2),
                     {}),
        "gpt_tiny": ((16,), 2, {}, {}),
        "llama_tiny": ((16,), 2, {}, dict(weight_bits=4,
                                          rounding="nearest"))}


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("name", list(ROOF))
def test_roofline_collect_equals_jax(name, int8):
    """Per layer, the port's ``flops`` and ``bytes`` equal the JAX
    package's for the same model, state and batch (the port's state
    carried into the JAX model)."""
    shape, batch, kw, cfg = ROOF[name]
    if int8:
        m, _ = _calibrated(name, batch=batch, shape=shape,
                           config=qt.QuantConfig(**cfg), **kw)
    else:
        m = tzoo.build(name, device="cpu", **kw)
    jm = install_state(jzoo.build(name, config=qj.QuantConfig(**cfg), **kw),
                       export_state(m))
    got = roofline.collect(m, shape, batch)
    want = jroofline.collect(jm, shape, batch)
    assert got["per_layer"] == want["per_layer"]
    assert (got["total_flops"], got["total_bytes"]) == \
        (want["total_flops"], want["total_bytes"])


CORRUPT = {
    "scale": lambda layer: setattr(layer, "scale", -1.0),
    "zero_point": lambda layer: setattr(layer, "zero_point", 300),
    "weight_scale": lambda layer: setattr(layer, "weight_scale", 0.0),
}


@pytest.mark.parametrize("case", list(CORRUPT) + ["code", "preparing"])
def test_validate_findings_match_jax(case):
    """Both packages' findings on the same corrupted artifact, word for
    word."""
    mm, shape = _calibrated("lenet", batch=4)
    assert validate.validate(mm, _rand(shape)) == []
    jm = install_state(jzoo.build("lenet"), export_state(mm))
    if case == "preparing":
        mm, jm = tzoo.build("fc_mnist", device="cpu"), jzoo.build("fc_mnist")
        mm.prepare()
        jm.prepare()
    elif case == "code":
        mm.fc1.qw[3, 5] = -128
        jm.fc1.params = dict(jm.fc1.params,
                             qw_kn=jm.fc1.params["qw_kn"].at[5, 3].set(-128))
    else:
        CORRUPT[case](mm.fc1)
        CORRUPT[case](jm.fc1)
    got = validate.validate(mm)
    assert got and got == jvalidate.validate(jm)
    want = {"scale": "bad output scale", "zero_point": "outside u8 range",
            "weight_scale": "non-positive/non-finite weight scale",
            "code": "weight code outside [-127,127]",
            "preparing": "still preparing"}[case]
    assert any(want in f for f in got), got


def test_validate_forward_probe():
    mm, shape = _calibrated("lenet", batch=4)
    mm.fc2.qw.zero_()
    mm.fc2.q_bias.zero_()
    mm.fc2.rowsum.zero_()
    mm.fc2._epilogue_cache = {}
    assert validate.validate(mm, _rand(shape)) == [
        "forward probe: constant output (degenerate)"]


def test_trace_and_device_op_times(tmp_path):
    mm, shape = _calibrated("lenet", batch=4)
    x = _cpu(_rand(shape))
    with utils.trace("fwd"):
        mm(x)
    with pytest.raises(FileNotFoundError):
        observe.device_op_times(str(tmp_path))
    with utils.trace("fwd", log_dir=str(tmp_path)):
        mm(x)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].startswith("fwd.") and \
        files[0].endswith(".trace.json.gz")
    # the CPU run holds host events only: no device kernels
    assert observe.device_op_times(str(tmp_path)) == {}
