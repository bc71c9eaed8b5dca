"""PyTorch port vs JAX package: the ResNet family and its BatchNorm fold.

* ``fold_bn`` and ``fold_resnet_state_dict`` give the JAX package's arrays
  exactly (the same float32 numpy operations in the same order), and the
  folded conv equals conv + BatchNorm in torch;
* ResNet-18/34/50/101/152 (``QuantConfig(weight_per_channel=True)``, the
  family's recommended lever) load the twin's torchvision-layout state dict
  with BN statistics (folded at load) and run the PTQ lifecycle on 64 x 64
  inputs at batch 2 (the JAX tests' size): the FP32 logits are within 1e-5
  of the largest |logit| of the unfolded twin's, and the port's converted
  state, installed in the JAX package's model, gives the JAX package's
  INT8 forward (``test_torch_cnn_zoo.jax_forward``: its jitted program
  without XLA's algebraic simplifier, equal to its un-jitted forward) the
  port's logits exactly.  Every deep model runs one INT8 forward.
"""

import numpy as np
import pytest
import torch

import int8inferenceengine_tpu as qj
from int8inferenceengine_tpu.models import resnet as jresnet
from int8inferenceengine_tpu.models import zoo as jzoo
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch.carry import export_state
from int8inferenceengine_tpu_torch.models import resnet as tresnet
from int8inferenceengine_tpu_torch.models import zoo as tzoo
from test_torch_cnn_zoo import install_jax_state, jax_forward
from test_torch_threads import one_torch_thread  # noqa: F401

RESNETS = ["resnet18", "resnet34", "resnet50", "resnet101", "resnet152"]
CONFIG = dict(weight_per_channel=True)


def test_fold_bn_matches_jax_and_torch():
    torch.manual_seed(0)
    conv = torch.nn.Conv2d(4, 8, 3, padding=1, bias=False)
    bn = torch.nn.BatchNorm2d(8)
    bn.train()
    with torch.no_grad():
        bn(conv(torch.randn(2, 4, 8, 8)))
    bn.eval()
    rng = np.random.default_rng(0)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(rng.uniform(0.5, 1.5, 8)))
        bn.bias.copy_(torch.tensor(rng.normal(0, 0.1, 8)))
    args = (conv.weight.detach().numpy(), rng.normal(0, 0.1, 8).astype(
        np.float32), bn.weight.detach().numpy(), bn.bias.detach().numpy(),
        bn.running_mean.numpy(), bn.running_var.numpy())
    got, want = tresnet.fold_bn(*args), jresnet.fold_bn(*args)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    x = torch.randn(2, 4, 8, 8)
    folded = torch.nn.Conv2d(4, 8, 3, padding=1)
    with torch.no_grad():
        folded.weight.copy_(torch.tensor(got[0]))
        folded.bias.copy_(torch.tensor(got[1]))
        want_y = bn(conv(x) + torch.tensor(args[1]).reshape(1, -1, 1, 1))
        np.testing.assert_allclose(folded(x).numpy(), want_y.numpy(),
                                   atol=1e-5)


@pytest.fixture(scope="module")
def state_dicts():
    return {name: tzoo.torch_twin(name).state_dict() for name in
            ("resnet18", "resnet50")}


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_fold_resnet_state_dict_equals_jax(state_dicts, name):
    sd = state_dicts[name]
    got = tresnet.fold_resnet_state_dict(sd)
    want = jresnet.fold_resnet_state_dict(sd)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    # every key is name.weight / name.bias of a port layer with weights
    # (all but the residual adds); no BN is left
    layers = dict(tzoo.build(name, device="cpu").named_layers())
    assert {k.rsplit(".", 1)[0] for k in got} == {
        n for n, layer in layers.items() if not isinstance(layer, qt.QuantAdd)}
    assert "layer2.0.downsample.0.weight" in got and "fc.weight" in got
    with pytest.raises(KeyError, match="conv for BN"):
        tresnet._bn_to_conv_key("layer1.0.norm")


@pytest.mark.parametrize("name", RESNETS)
def test_resnet_lifecycle_matches_jax(name):
    twin = tzoo.torch_twin(name)
    rng = np.random.default_rng(0)
    x_calib = rng.standard_normal((2, 3, 64, 64)).astype(np.float32)
    x_test = rng.standard_normal((2, 3, 64, 64)).astype(np.float32)
    m = tzoo.build(name, config=qt.QuantConfig(**CONFIG), device="cpu")
    m.load(twin.state_dict())              # folds BN: the state has stats
    m.prepare()                   # the calibration forward is the FP32 one
    got = m(qt.tensor(x_calib, device="cpu")).numpy()
    with torch.no_grad():
        want = twin(torch.from_numpy(x_calib)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    m.convert()
    assert m.fc.weight_scale.shape == (10,)           # per-channel scales
    out = m(qt.tensor(x_test, device="cpu")).numpy()
    assert out.shape == (2, 10) and np.isfinite(out).all()
    jm = jzoo.build(name, config=qj.QuantConfig(**CONFIG))
    install_jax_state(jm, export_state(m))
    np.testing.assert_array_equal(out, jax_forward(jm, x_test))
