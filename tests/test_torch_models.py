"""PyTorch port vs JAX package: the whole slice, on the reference's models.

For FCMnist, LeNet, SimpleConv and AlexNet-224 (full width, batch 1) both
packages load the same ``torch_twin`` weights and run the reference
workflow — FP32 forward, prepare, calibrate, convert, INT8 forward — on the
same numpy inputs:

* FP32 logits agree to rtol 1e-5 (the frameworks sum float convolutions in
  different orders);
* with the JAX package's converted state carried over (``load_jax_state``)
  the INT8 logits are bit-identical;
* with each package calibrating on its own, scales agree to rtol 1e-5, zero
  points are equal, and the logits are within 2 output-scale steps on at
  least 99.5% of entries (a float-order difference in calibration can move
  a scale by an ULP, which moves codes near truncation boundaries).
"""

import numpy as np
import pytest
import torch

import int8inferenceengine_tpu as qj
from int8inferenceengine_tpu.models import zoo as jzoo
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch.carry import export_state, load_jax_state
from int8inferenceengine_tpu_torch.models import zoo as tzoo
from test_torch_threads import one_torch_thread  # noqa: F401

BATCH = {"fc_mnist": 8, "lenet": 8, "simple_conv": 8, "alexnet": 1}


def jax_state(model) -> dict:
    """A JAX Module's per-layer state in ``load_jax_state``'s format."""
    state = {}
    for name, layer in model.named_layers():
        ws = layer.weight_scale
        state[name] = {
            "params": {k: np.asarray(v) for k, v in layer.params.items()},
            "scale": layer.scale, "zero_point": layer.zero_point,
            "weight_scale": ws if isinstance(ws, float) else np.asarray(ws),
            "is_quantized": layer.is_quantized}
    return state


@pytest.fixture(scope="module", params=list(BATCH))
def ref(request):
    """The JAX package's lifecycle on one model, run once per model."""
    name = request.param
    sd = jzoo.torch_twin(name).state_dict()
    rng = np.random.default_rng(0)
    shape = (BATCH[name],) + jzoo.MODEL_SPECS[name].INPUT_SHAPE
    x_calib = rng.standard_normal(shape).astype(np.float32)
    x_test = rng.standard_normal(shape).astype(np.float32)
    m = jzoo.build(name)
    m.load(sd)
    fp32_state = jax_state(m)
    fp32 = m(qj.tensor(x_test)).numpy()
    m.prepare()
    m(qj.tensor(x_calib))
    m.convert()
    return dict(name=name, sd=sd, x_calib=x_calib, x_test=x_test, fp32=fp32,
                fp32_state=fp32_state, int8=m(qj.tensor(x_test)).numpy(),
                state=jax_state(m), model=m)


def _port(ref):
    m = tzoo.build(ref["name"], device="cpu")
    m.load(ref["sd"])
    return m


def _run(m, x):
    return m(qt.tensor(x, device="cpu")).numpy()


def test_fp32_matches_jax(ref):
    got = _run(_port(ref), ref["x_test"])
    want = ref["fp32"]
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_carried_fp32_state_matches_own_load(ref):
    m = tzoo.build(ref["name"], device="cpu")
    load_jax_state(m, ref["fp32_state"])
    assert not m.is_quant
    np.testing.assert_array_equal(_run(m, ref["x_test"]),
                                  _run(_port(ref), ref["x_test"]))


def test_carried_int8_state_is_bit_identical(ref):
    m = tzoo.build(ref["name"], device="cpu")
    load_jax_state(m, ref["state"])
    assert m.is_quant
    np.testing.assert_array_equal(_run(m, ref["x_test"]), ref["int8"])
    # and the state comes back out unchanged
    back = export_state(m)
    for name, st in ref["state"].items():
        assert back[name]["scale"] == st["scale"]
        assert back[name]["zero_point"] == st["zero_point"]
        for key, arr in st["params"].items():
            np.testing.assert_array_equal(back[name]["params"][key], arr)


def test_independent_lifecycle_matches_jax(ref):
    m = _port(ref)
    m.prepare()
    _run(m, ref["x_calib"])
    m.convert()
    layers = dict(ref["model"].named_layers())
    for name, layer in m.named_layers():
        want = layers[name]
        assert layer.zero_point == want.zero_point, name
        assert layer.scale == pytest.approx(want.scale, rel=1e-5), name
    got = _run(m, ref["x_test"])
    steps = np.abs(got - ref["int8"]) / list(layers.values())[-1].scale
    assert (steps <= 2 + 1e-3).mean() >= 0.995, steps.max()
