"""PyTorch port vs JAX package: cross-layer equalization
(``utils.cross_layer_equalize``), mirroring ``tests/test_equalize.py``.

* LeNet (conv1 -> conv2 through a max-pool, fc1 -> fc2 through a ReLU)
  and the pathological two-Linear model (one output channel 300x wide):
  the equalized weights and biases equal the JAX package's bit for bit (a
  conv's OIHW weight against JAX's HWIO transposed).  Max, divide and the
  root are exact IEEE operations; the port takes the root in float64 and
  rounds it once, because torch's float32 sqrt on the CPU is an ULP off on
  some inputs where numpy's and XLA's are correctly rounded.
* The FP32 function is unchanged (1e-4, the JAX test's bound), the
  producer's out-channel ranges equal the consumer's in-channel ranges
  (rtol 1e-5), and the per-tensor INT8 error of the pathological model
  falls below half of the unequalized model's.
* The guards raise the JAX package's types: no such layer (KeyError), a
  channel-count mismatch, a grouped consumer (ValueError), a layer without
  weights (TypeError), a prepared or converted model (RuntimeError).
"""

import numpy as np
import pytest
import torch

import int8inferenceengine_tpu as qj
from int8inferenceengine_tpu import utils as jutils
from int8inferenceengine_tpu.layers import Conv2d as JConv2d
from int8inferenceengine_tpu.layers import Linear as JLinear
from int8inferenceengine_tpu.models import zoo as jzoo
from int8inferenceengine_tpu.module import Module as JModule
from int8inferenceengine_tpu.ops import functional as JF
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch import utils as tutils
from int8inferenceengine_tpu_torch.models import zoo as tzoo
from int8inferenceengine_tpu_torch.ops import functional as TF
from test_torch_threads import one_torch_thread  # noqa: F401

LENET_PAIRS = [("conv1", "conv2"), ("fc1", "fc2")]


def _cpu(x):
    return qt.tensor(x, device="cpu")


def _lenets():
    sd = jzoo.torch_twin("lenet").state_dict()
    mj, mt = jzoo.build("lenet"), tzoo.build("lenet", device="cpu")
    mj.load(sd)
    mt.load(sd)
    return mj, mt


def _params(jl, tl):
    """(JAX weight in the port's layout, port weight, JAX bias, port bias)."""
    if isinstance(jl, JConv2d):
        wj = np.asarray(jl.params["w_hwio"]).transpose(3, 2, 0, 1)
    else:
        wj = np.asarray(jl.params["weight"])
    return wj, tl.weight.numpy(), np.asarray(jl.params["bias"]), \
        tl.bias.numpy()


class _JPath(JModule):
    def __init__(self):
        super().__init__()
        self.fc1 = JLinear(32, 32)
        self.fc2 = JLinear(32, 8)

    def forward(self, x):
        return self.fc2(JF.relu(self.fc1(x)))


class _TPath(qt.Module):
    def __init__(self):
        super().__init__(device="cpu")
        self.fc1 = qt.Linear(32, 32, device="cpu")
        self.fc2 = qt.Linear(32, 8, device="cpu")

    def forward(self, x):
        return self.fc2(TF.relu(self.fc1(x)))


def _pathological(cls):
    """fc1 with one 300x-range output channel, fc2 compensating: the
    per-tensor worst case of ``tests/test_equalize.py``."""
    rng = np.random.default_rng(0)
    w1 = rng.normal(0, 0.3, (32, 32)).astype(np.float32)
    w1[5] *= 300.0
    w2 = rng.normal(0, 0.3, (8, 32)).astype(np.float32)
    w2[:, 5] /= 300.0
    m = cls()
    m.fc1.load_weight(w1)
    m.fc1.load_bias(np.zeros(32, np.float32))
    m.fc2.load_weight(w2)
    m.fc2.load_bias(np.zeros(8, np.float32))
    return m


@pytest.mark.parametrize("model", ["lenet", "pathological"])
def test_weights_equal_jax_bit_for_bit(model):
    if model == "lenet":
        mj, mt = _lenets()
        pairs = LENET_PAIRS
    else:
        mj, mt = _pathological(_JPath), _pathological(_TPath)
        pairs = [("fc1", "fc2")]
    jutils.cross_layer_equalize(mj, pairs)
    assert tutils.cross_layer_equalize(mt, pairs) is mt
    for name in {n for p in pairs for n in p}:
        wj, wt, bj, bt = _params(getattr(mj, name), getattr(mt, name))
        np.testing.assert_array_equal(wt, wj, err_msg=name)
        np.testing.assert_array_equal(bt, bj, err_msg=name)


def test_fp32_invariance_and_ranges_lenet():
    _, mt = _lenets()
    x = np.random.default_rng(0).uniform(-1, 1, (8, 1, 28, 28)).astype(
        np.float32)
    before = mt(_cpu(x)).numpy()
    tutils.cross_layer_equalize(mt, LENET_PAIRS)
    np.testing.assert_allclose(mt(_cpu(x)).numpy(), before, atol=1e-4)
    _, one = _lenets()
    tutils.cross_layer_equalize(one, [("fc1", "fc2")], iterations=1)
    r1 = one.fc1.weight.abs().amax(dim=1).numpy()
    r2 = one.fc2.weight.abs().amax(dim=0).numpy()
    np.testing.assert_allclose(r1, r2, rtol=1e-5)


def test_per_tensor_int8_error_shrinks():
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (64, 32)).astype(np.float32)
    calib = rng.uniform(-1, 1, (64, 32)).astype(np.float32)
    ref = _pathological(_TPath)(_cpu(x)).numpy()

    def int8_err(m):
        m.prepare()
        m(_cpu(calib))
        m.convert()
        return np.abs(m(_cpu(x)).numpy() - ref).mean()

    err_plain = int8_err(_pathological(_TPath))
    m_eq = _pathological(_TPath)
    tutils.cross_layer_equalize(m_eq, [("fc1", "fc2")])
    err_eq = int8_err(m_eq)
    assert err_eq < 0.5 * err_plain, (err_plain, err_eq)


class _JGrouped(JModule):
    def __init__(self):
        super().__init__()
        self.conv1 = JConv2d(4, 8, 3)
        self.conv2 = JConv2d(8, 8, 3, groups=2)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class _TGrouped(qt.Module):
    def __init__(self):
        super().__init__(device="cpu")
        self.conv1 = qt.Conv2d(4, 8, 3, device="cpu")
        self.conv2 = qt.Conv2d(8, 8, 3, groups=2, device="cpu")

    def forward(self, x):
        return self.conv2(self.conv1(x))


def _guard(case, pkg):
    """Run one misuse under ``pkg`` ('jax' or 'torch'); returns what it
    raised."""
    is_jax = pkg == "jax"
    cle = (jutils if is_jax else tutils).cross_layer_equalize
    if case == "grouped":
        m = _JGrouped() if is_jax else _TGrouped()
        pairs = [("conv1", "conv2")]
    elif case in ("prepared", "converted"):
        m = _pathological(_JPath if is_jax else _TPath)
        pairs = [("fc1", "fc2")]
        m.prepare()
        if case == "converted":
            x = np.zeros((2, 32), np.float32)
            m(qj.tensor(x) if is_jax else _cpu(x))
            m.convert()
    else:
        mj, mt = _lenets()
        m = mj if is_jax else mt
        pairs = {"no_layer": [("conv1", "nope")],
                 "mismatch": [("conv1", "fc1")],
                 "unsupported": [("conv1", "conv2")]}[case]
        if case == "unsupported":
            m = qj.Module() if is_jax else qt.Module(device="cpu")
            m.conv1 = (qj.QuantAct("relu") if is_jax
                       else qt.QuantAct("relu", device="cpu"))
            m.conv2 = mj.conv2 if is_jax else mt.conv2
    with pytest.raises(Exception) as info:
        cle(m, pairs)
    return info


@pytest.mark.parametrize("case,error,match", [
    ("no_layer", KeyError, "no layer"),
    ("mismatch", ValueError, "out=.*!=.*in"),
    ("grouped", ValueError, "grouped"),
    ("unsupported", TypeError, "unsupported layer"),
    ("prepared", RuntimeError, "before prepare"),
    ("converted", RuntimeError, "before convert")])
def test_guards_raise_the_jax_types(case, error, match):
    got, want = _guard(case, "torch"), _guard(case, "jax")
    assert want.type is error and got.type is error, (want.type, got.type)
    assert got.match(match)
