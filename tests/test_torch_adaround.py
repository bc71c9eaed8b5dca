"""PyTorch port vs JAX package: AdaRound (``utils.adaround``) and the
convert hooks that take the levers' codes, mirroring
``tests/test_adaround.py``.

* ``_h``'s init recovers the fraction (to 2e-7, float32 rounding), so the
  optimizer starts at round-to-nearest: the init's hard rounding is
  nearest's codes exactly, away from the halfway point; JAX's ``_h`` of
  the same V agrees to 1e-6.
* Quality at the JAX test's bounds: a Linear on correlated rows beats
  round-to-nearest's layer-output error by 5%; the W4 weight-only layer
  beats the default (MSE-scaled) pack by 10%; on LeNet (prepare,
  calibrate, adaround, convert) the logit error stays within 1.25x of the
  lever-free model's; a converted model is refused.
* Agreement with the JAX package: AdaRound is not bit-exact across
  frameworks (sigmoid, the products and the reductions round differently
  inside 300 Adam steps), so for the same weights and rows the test states
  the share of equal codes: at least 99% of the Linear's (measured: all of
  them) and no code more than 1 apart.
* The convert hooks: the same stashed codes give the JAX package's
  converted parameters (``carry.export_state``: a conv's HWIO transposed)
  in W8 static with bias correction, W8-float, W4A8 and W4 weight-only,
  and in a plain and a grouped conv; and the same codes give the same
  INT8 LeNet forward bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import int8inferenceengine_tpu as qj
from int8inferenceengine_tpu import QuantConfig as JConfig
from int8inferenceengine_tpu import utils as jutils
from int8inferenceengine_tpu.layers import Conv2d as JConv2d
from int8inferenceengine_tpu.layers import Linear as JLinear
from int8inferenceengine_tpu.models import zoo as jzoo
from int8inferenceengine_tpu.module import Module as JModule
from int8inferenceengine_tpu.utils.adaround import _h as j_h
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch import utils as tutils
from int8inferenceengine_tpu_torch.carry import export_state
from int8inferenceengine_tpu_torch.layers import weight_quant_spec
from int8inferenceengine_tpu_torch.models import zoo as tzoo
from int8inferenceengine_tpu_torch.utils.adaround import (_h, _h_init,
                                                          _layer_out)
from test_torch_cnn_zoo import jax_forward
from test_torch_gptq import One, _correlated
from test_torch_text_decoder import jax_state
from test_torch_threads import one_torch_thread  # noqa: F401


def _cpu(x):
    return qt.tensor(x, device="cpu")


def test_h_init_recovers_the_fraction():
    frac = torch.tensor(np.random.default_rng(0).uniform(
        1e-4, 1 - 1e-4, 4096).astype(np.float32))
    v = _h_init(frac)
    h = _h(v)
    assert ((h >= 0) & (h <= 1)).all()
    np.testing.assert_allclose(h.numpy(), frac.numpy(), rtol=0, atol=2e-7)
    away = (frac - 0.5).abs() > 1e-6
    assert torch.equal((h > 0.5)[away], torch.round(frac)[away].bool())
    np.testing.assert_allclose(np.asarray(j_h(jnp.asarray(v.numpy()))),
                               h.numpy(), rtol=0, atol=1e-6)


def _linear_problem(k=64, n=32, seed=0, rank=4):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.1, (n, k)).astype(np.float32)
    b = rng.normal(0, 0.05, n).astype(np.float32)
    return w, b, _correlated(512, k, rank=rank, seed=seed + 1)


def _loaded(cls, w, b, **kw):
    layer = cls(w.shape[1], w.shape[0], **kw)
    layer.load_weight(w)
    layer.load_bias(b)
    return layer


def test_linear_beats_nearest_and_agrees_with_jax():
    w, b, x = _linear_problem()
    tl = _loaded(qt.Linear, w, b, device="cpu")
    jl = _loaded(JLinear, w, b)
    for layer, tensor in ((tl, _cpu), (jl, qj.tensor)):
        layer.prepare()
        layer(tensor(x))
    tutils.adaround(One(tl), x, iters=300)
    jutils.adaround(One(jl), x, iters=300)

    wt, s, _, _ = weight_quant_spec(tl)
    nearest = torch.clamp(torch.round(wt / s), -127, 127)
    ada = tl._adaround_qw
    assert (ada != nearest.to(torch.int8)).sum() > 0          # re-rounded
    xt = torch.from_numpy(x)
    ref = _layer_out(tl, wt, xt)
    e_near = float(torch.mean((_layer_out(tl, s * nearest, xt) - ref) ** 2))
    e_ada = float(torch.mean((_layer_out(tl, s * ada.float(), xt) - ref)
                             ** 2))
    assert e_ada < e_near * 0.95, (e_ada, e_near)

    want = np.asarray(jl._adaround_qw).astype(np.int32)
    apart = np.abs(ada.numpy().astype(np.int32) - want)
    assert (apart == 0).mean() >= 0.99, (apart == 0).mean()
    assert apart.max() <= 1, apart.max()


def test_w4_adaround_beats_default_pack():
    w, b, x = _linear_problem(k=128, seed=4)
    cfg = qt.QuantConfig(weight_only=True, weight_bits=4, w4_group=64)
    outs = {}
    for use_ada in (False, True):
        layer = _loaded(qt.Linear, w, b, config=cfg, device="cpu")
        if use_ada:
            tutils.adaround(One(layer), x, iters=300)
            assert layer._adaround_scales is not None
        layer.convert()
        outs[use_ada] = layer(_cpu(x)).numpy()
    ref = x @ w.T + b
    e = {k: float(np.mean((v - ref) ** 2)) for k, v in outs.items()}
    assert e[True] < e[False] * 0.9, e


def test_lifecycle_lenet_and_requires_unconverted():
    tw = tzoo.torch_twin("lenet")
    x = np.random.default_rng(2).uniform(-1, 1, (64, 1, 28, 28)).astype(
        np.float32)
    outs = {}
    for use_ada in (False, True):
        m = tzoo.build("lenet", device="cpu")
        m.load(tw.state_dict())
        m.prepare()
        m(_cpu(x))
        if use_ada:
            tutils.adaround(m, x, iters=100)
            # the tapped forward did not feed the calibrators twice
            assert all(l.is_preparing for _, l in m.named_layers())
        m.convert()
        outs[use_ada] = m(_cpu(x)).numpy()
        assert np.isfinite(outs[use_ada]).all()
    with torch.no_grad():
        want = tw(torch.from_numpy(x)).numpy()
    mse = {k: float(np.mean((v - want) ** 2)) for k, v in outs.items()}
    assert mse[True] <= mse[False] * 1.25, mse
    with pytest.raises(RuntimeError, match="before convert"):
        tutils.adaround(m, x)


class _JOne(JModule):
    def __init__(self, layer):
        super().__init__()
        self.l = layer

    def forward(self, x):
        return self.l(x)


class _TOne(qt.Module):
    def __init__(self, layer):
        super().__init__(device="cpu")
        self.l = layer

    def forward(self, x):
        return self.l(x)


HOOKS = {  # case -> (layer kind, config)
    "linear_w8_static_bias_correction": (
        "linear", dict(bias_correction=True, rounding="nearest")),
    "linear_w8_float": ("linear", dict(weight_only=True)),
    "linear_w4a8": ("linear", dict(weight_bits=4, w4_group=32)),
    "linear_w4_weight_only": ("linear", dict(weight_only=True, weight_bits=4,
                                             w4_group=32)),
    "conv_w8_static_bias_correction": ("conv", dict(bias_correction=True)),
    "grouped_conv_w8_static": ("grouped", dict(weight_per_channel=True)),
}


@pytest.mark.parametrize("case", list(HOOKS))
def test_convert_hooks_give_jax_parameters(case):
    kind, cfg = HOOKS[case]
    rng = np.random.default_rng(7)
    w4 = cfg.get("weight_bits") == 4
    if kind == "linear":
        args, shape = (64, 16), (32, 64)
        wshape = (16, 64)
        make = (lambda c: qt.Linear(*args, config=c, device="cpu"),
                lambda c: JLinear(*args, config=c))
    else:
        g = 2 if kind == "grouped" else 1
        args, shape = (4, 8, 3), (4, 4, 6, 6)
        wshape = (8, 4 // g, 3, 3)
        make = (lambda c: qt.Conv2d(*args, padding=1, groups=g, config=c,
                                    device="cpu"),
                lambda c: JConv2d(*args, padding=1, groups=g, config=c))
    w = rng.normal(0, 0.1, wshape).astype(np.float32)
    b = rng.normal(0, 0.05, wshape[0]).astype(np.float32)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    bound = 7 if w4 else 127
    codes = rng.integers(-bound, bound + 1, wshape).astype(np.int8)
    scales = rng.uniform(0.005, 0.02, (16, 2)).astype(np.float32)
    tl, jl = make[0](qt.QuantConfig(**cfg)), make[1](JConfig(**cfg))
    tm, jm = _TOne(tl), _JOne(jl)
    for layer in (tl, jl):
        layer.load_weight(w)
        layer.load_bias(b)
    tl._adaround_qw = torch.from_numpy(codes)
    jl._adaround_qw = jnp.asarray(codes if kind == "linear"
                                  else codes.transpose(2, 3, 1, 0))
    if w4:
        tl._adaround_scales = torch.from_numpy(scales)
        jl._adaround_scales = jnp.asarray(scales)
    if not cfg.get("weight_only"):
        tm.prepare()
        jm.prepare()
        tm(_cpu(x))
        jm(qj.tensor(x))
    tm.convert()
    jm.convert()
    got = export_state(tm)["l"]
    want = jax_state(jm)["l"]
    assert set(got["params"]) == set(want["params"])
    for key, value in want["params"].items():
        if w4 and key in ("bias", "w4_wsum"):
            # float32 sums that add in another order
            np.testing.assert_allclose(got["params"][key], value,
                                       rtol=1e-6, atol=1e-7, err_msg=key)
        else:
            np.testing.assert_array_equal(got["params"][key], value,
                                          err_msg=key)
    # the output grid comes from the FP32 product, ULPs apart between the
    # frameworks; the weight's scale is the convert hook's
    np.testing.assert_array_equal(got["weight_scale"], want["weight_scale"])


def test_same_codes_same_int8_lenet_forward():
    """The same stashed codes (nearest's, a tenth of them moved one step;
    a conv's OIHW codes transposed to JAX's HWIO) give the port's LeNet
    the JAX package's INT8 logits exactly."""
    tw = jzoo.torch_twin("lenet")
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (16, 1, 28, 28)).astype(np.float32)
    mj = jzoo.build("lenet")
    mt = tzoo.build("lenet", device="cpu")
    for m, tensor in ((mj, qj.tensor), (mt, _cpu)):
        m.load(tw.state_dict())
        m.prepare()
        m(tensor(x))
    for name, tl in mt.named_layers():
        w, s, bound, _ = weight_quant_spec(tl)
        q = torch.round(w / s).numpy()
        q += rng.choice([-1.0, 0.0, 1.0], q.shape, p=[0.05, 0.9, 0.05])
        q = np.clip(q, -bound, bound).astype(np.int8)
        tl._adaround_qw = torch.from_numpy(q)
        getattr(mj, name)._adaround_qw = jnp.asarray(
            q.transpose(2, 3, 1, 0) if q.ndim == 4 else q)
    mj.convert()
    mt.convert()
    np.testing.assert_array_equal(mt(_cpu(x)).numpy(), jax_forward(mj, x))
