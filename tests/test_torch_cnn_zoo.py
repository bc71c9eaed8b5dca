"""PyTorch port vs JAX package: the CNN zoo's other families.

VGG-11/16/19 (224 x 224, batch 1, as ``tests/test_models.py`` runs VGG),
MobileNet V1, V2, V3-large and V3-small, EfficientNet-B0, ShuffleNetV2,
SqueezeNet, GoogLeNet and DenseNet-121 (64 x 64, batch 2, the JAX tests'
size), each loading its ``torch_twin`` weights:

* the port's FP32 forward is within the JAX tests' tolerance of the twin's
  (atol 5e-3; VGG 2e-2);
* the port runs the PTQ lifecycle (prepare, calibrate, convert), and its
  converted state, installed in the JAX package's model of the same name,
  gives the JAX package's INT8 forward the port's logits exactly.

The JAX package's INT8 forward is its own jitted program (``Module``'s
forward) compiled without XLA's algebraic simplifier: with it, XLA:CPU
turns every division by a constant scale into a multiply by its
reciprocal, which moves codes on truncation boundaries (ROADMAP queue 3,
"The JAX reference is not one function under ``jit``").  That program
equals the JAX package's un-jitted forward, the float order the port
follows, and compiles once a model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from int8inferenceengine_tpu.models import zoo as jzoo
from int8inferenceengine_tpu.tensor import Tensor as JTensor
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch.carry import export_state
from int8inferenceengine_tpu_torch.models import zoo as tzoo
from test_torch_threads import one_torch_thread  # noqa: F401

# name -> (input shape, FP32 atol against the twin: the JAX tests')
ZOO = {
    "vgg11": ((1, 3, 224, 224), 2e-2),
    "vgg16": ((1, 3, 224, 224), 2e-2),
    "vgg19": ((1, 3, 224, 224), 2e-2),
    "mobilenet_v1": ((2, 3, 64, 64), 5e-3),
    "mobilenet_v2": ((2, 3, 64, 64), 5e-3),
    "mobilenet_v3_large": ((2, 3, 64, 64), 5e-3),
    "mobilenet_v3_small": ((2, 3, 64, 64), 5e-3),
    "efficientnet_b0": ((2, 3, 64, 64), 5e-3),
    "shufflenet_v2": ((2, 3, 64, 64), 5e-3),
    "squeezenet": ((2, 3, 64, 64), 5e-3),
    "googlenet": ((2, 3, 64, 64), 5e-3),
    "densenet121": ((2, 3, 64, 64), 5e-3),
}

# the JAX package's programs without the pass that rewrites a division by
# a constant into a reciprocal multiply
EXACT_XLA = {"xla_disable_hlo_passes": "algsimp"}


def install_jax_state(model, state: dict) -> None:
    """Install a converted state in ``load_jax_state``'s format (the port's
    ``export_state``) into a JAX package Module."""
    for name, layer in model.named_layers():
        st = state[name]
        layer.params = {k: jnp.asarray(v) for k, v in st["params"].items()}
        ws = st["weight_scale"]
        layer.weight_scale = ws if isinstance(ws, float) else jnp.asarray(ws)
        layer.scale, layer.zero_point = st["scale"], st["zero_point"]
        layer.is_quantized, layer.is_preparing = True, False
        layer.calibrator = None
    model.is_quant = True


def jax_forward(model, x: np.ndarray) -> np.ndarray:
    """The JAX package's forward of ``model`` on ``x`` (its ``Module``
    program: bind the params, run, unbind) compiled with ``EXACT_XLA``."""
    def fwd(params, data):
        model._bind(params)
        try:
            return model._run(JTensor(data)).logical_data
        finally:
            model._bind(None)

    params = model._gather_params()
    data = jnp.asarray(x)
    program = jax.jit(fwd).lower(params, data).compile(
        compiler_options=EXACT_XLA)
    return np.asarray(program(params, data))


def exact_jit(fn, *args):
    """``fn(*args)`` as one XLA program compiled with ``EXACT_XLA``: the
    JAX function's float order without the reciprocal rewrite, one compile
    instead of one per eager op."""
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT_XLA)(*args)


@pytest.mark.parametrize("name", list(ZOO))
def test_zoo_model_matches_jax(name):
    shape, atol = ZOO[name]
    twin = tzoo.torch_twin(name)
    rng = np.random.default_rng(0)
    x_calib = rng.uniform(-1, 1, shape).astype(np.float32)
    x_test = rng.uniform(-1, 1, shape).astype(np.float32)
    m = tzoo.build(name, device="cpu")
    m.load(twin.state_dict())
    with torch.no_grad():
        want = twin(torch.from_numpy(x_calib)).numpy()
    m.prepare()                   # the calibration forward is the FP32 one
    np.testing.assert_allclose(m(qt.tensor(x_calib, device="cpu")).numpy(),
                               want, atol=atol)
    m.convert()
    got = m(qt.tensor(x_test, device="cpu")).numpy()
    assert got.shape == (shape[0], 10) and np.isfinite(got).all()
    jm = jzoo.build(name)
    install_jax_state(jm, export_state(m))
    np.testing.assert_array_equal(got, jax_forward(jm, x_test))


CNNS = ["fc_mnist", "simple_conv", "alexnet", "lenet", "resnet18", "resnet34",
        "resnet50", "resnet101", "resnet152", *ZOO]


@pytest.mark.parametrize("name", CNNS)
def test_build_accepts_every_cnn_of_the_jax_zoo(name):
    """Every CNN name of the JAX package's ``build()`` builds in the port,
    with the JAX model's layer names in its order."""
    assert name in jzoo.MODEL_SPECS
    jm = jzoo.build(name)
    got = tzoo.build(name, device="cpu")
    assert [n for n, _ in got.named_layers()] == [
        n for n, _ in jm.named_layers()]
    assert got.INPUT_SHAPE == jm.INPUT_SHAPE
