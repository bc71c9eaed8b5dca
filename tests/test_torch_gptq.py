"""PyTorch port vs JAX package: GPTQ (``utils.gptq``), mirroring
``tests/test_gptq.py``.

* The sweep: given the inverse Hessian that numpy forms as the JAX
  package's ``_gptq_layer`` forms it, the port's ``gptq_sweep`` gives the
  codes of JAX's ``_gptq_layer`` on the same rows bit for bit, in W8
  static (per-tensor and per-channel), W8-float, W4A8 and W4 weight-only.
  The rows are small integers, so their Gram matrix is exact in float32
  and both frameworks form the same Hessian; the port then forms it itself
  (float64 from float32 rows, ``torch.linalg.inv``) and still matches.
* End to end on real-valued correlated rows (``gptq()`` on both sides,
  each forming its own Hessian and inverse): at most 1 code apart on at
  most 0.2% of the weights (the repo's contract); and with more rows than
  ``max_rows`` both take the same sample of rows.
* Layers that read the same rows (a llama's wq, wk, wv and gate, up) run
  as one sweep in ``gptq()``: each gets the codes of its own sweep bit for
  bit.
* Quality, as the JAX test asks: at W4 the GPTQ layer's output error is
  below 0.7x round-to-nearest's (AdaRound's is recorded beside it and
  also beats nearest); W8 static rides ``convert()`` with a smaller error;
  ``gpt_tiny`` in W4 weight-only takes GPTQ at the model level.
"""

import numpy as np
import pytest
import torch

from int8inferenceengine_tpu import QuantConfig as JConfig
from int8inferenceengine_tpu import utils as jutils
from int8inferenceengine_tpu.layers import Linear as JLinear
from int8inferenceengine_tpu.models import zoo as jzoo
from int8inferenceengine_tpu.utils.gptq import _gptq_layer
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch import utils as tutils
from int8inferenceengine_tpu_torch.layers import weight_quant_spec
from int8inferenceengine_tpu_torch.models import zoo as tzoo
from int8inferenceengine_tpu_torch.models.llama import torch_llama
from int8inferenceengine_tpu_torch.ops import functional as TF
from int8inferenceengine_tpu_torch.utils.gptq import (gptq_sweep,
                                                      inverse_hessian)
from int8inferenceengine_tpu_torch.utils.tap import tapped_forward
from test_torch_threads import one_torch_thread  # noqa: F401

MODES = {"w8_static": dict(rounding="nearest"),
         "w8_per_channel": dict(weight_per_channel=True),
         "w8_float": dict(weight_only=True),
         "w4a8": dict(weight_bits=4, w4_group=32, rounding="nearest"),
         "w4_weight_only": dict(weight_only=True, weight_bits=4,
                                w4_group=32)}


class One:
    """A one-layer model as the levers see one (``tests/test_gptq.py``)."""
    is_quant = False

    def __init__(self, layer):
        self._l = layer

    def named_layers(self):
        return [("lin", self._l)]

    def forward(self, t):
        return self._l(t)


def _correlated(n, k, rank, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (n, rank)) @ rng.normal(0, 1, (rank, k))
            ).astype(np.float32)


def _pair(mode, k, n, seed=0):
    """A JAX and a port Linear of ``mode`` with the same weights."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.1, (n, k)).astype(np.float32)
    b = rng.normal(0, 0.05, n).astype(np.float32)
    jl = JLinear(k, n, config=JConfig(**MODES[mode]))
    tl = qt.Linear(k, n, config=qt.QuantConfig(**MODES[mode]), device="cpu")
    for layer in (jl, tl):
        layer.load_weight(w)
        layer.load_bias(b)
    return jl, tl, w, b


def _numpy_hinv(x, damp=0.01):
    """The JAX package's ``_gptq_layer`` Hessian and inverse, in numpy."""
    h = 2.0 * (x.T @ x).astype(np.float64)
    h += np.eye(x.shape[1]) * (damp * float(np.mean(np.diag(h))) + 1e-8)
    return np.linalg.inv(h)


@pytest.mark.parametrize("mode", list(MODES))
def test_sweep_equals_jax_given_its_inverse_hessian(mode):
    k, n = 64, 32
    jl, tl, _, _ = _pair(mode, k, n)
    x = np.random.default_rng(1).integers(-2, 3, (48, k)).astype(np.float32)
    _gptq_layer(jl, x, 0.01)
    want = np.asarray(jl._adaround_qw)
    w, s, bound, _ = weight_quant_spec(tl)
    hinv = _numpy_hinv(x)
    got = gptq_sweep(w, s, bound, torch.from_numpy(hinv)).numpy()
    np.testing.assert_array_equal(got, want)
    own = inverse_hessian(torch.from_numpy(x), 0.01)
    np.testing.assert_array_equal(
        gptq_sweep(w, s, bound, own).numpy(), want)
    assert np.abs(want).max() <= bound


@pytest.mark.parametrize("mode", ["w8_static", "w4a8"])
def test_end_to_end_codes_within_the_contract(mode):
    k, n = 128, 32
    jl, tl, _, _ = _pair(mode, k, n, seed=2)
    # 600 rows > max_rows: both take the same sorted sample of 512
    x = _correlated(600, k, rank=6, seed=3)
    jutils.gptq(One(jl), x, max_rows=512)
    tutils.gptq(One(tl), x, max_rows=512)
    want = np.asarray(jl._adaround_qw).astype(np.int32)
    got = tl._adaround_qw.numpy().astype(np.int32)
    apart = np.abs(got - want)
    assert apart.max() <= 1, apart.max()
    assert (apart > 0).mean() <= 0.002, (apart > 0).mean()
    if mode == "w4a8":
        np.testing.assert_array_equal(tl._adaround_scales.numpy(),
                                      np.asarray(jl._adaround_scales))


def test_layers_that_share_rows_sweep_as_one():
    geo = dict(vocab_size=97, max_len=32, dim=64, depth=2, heads=4,
               kv_heads=2)
    cfg = qt.QuantConfig(weight_bits=4, w4_group=32, rounding="nearest")
    m = tzoo.build("llama_tiny", config=cfg, device="cpu", **geo)
    m.load(torch_llama(**geo).state_dict())
    ids = np.random.default_rng(5).integers(0, 97, (2, 16)).astype(np.int32)
    tap = tapped_forward(m, ids)
    assert tap[id(m.wq1)][0] is tap[id(m.wv1)][0]      # one input, shared
    tutils.gptq(m, ids)
    for name, layer in m.named_layers():
        if not isinstance(layer, qt.Linear):
            continue
        x = torch.cat(tap[id(layer)], 0)
        w, s, bound, _ = weight_quant_spec(layer)
        own = gptq_sweep(w, s, bound, inverse_hessian(x, 0.01))
        assert torch.equal(layer._adaround_qw, own), name


def _mse(layer, x, w, b):
    got = layer(qt.tensor(x, device="cpu")).numpy()
    return float(np.mean((got - (x @ w.T + b)) ** 2))


def test_w4_gptq_beats_nearest():
    rng = np.random.default_rng(0)
    k, n = 128, 32
    w = rng.normal(0, 0.1, (n, k)).astype(np.float32)
    b = rng.normal(0, 0.05, n).astype(np.float32)
    x = _correlated(512, k, rank=6, seed=1)
    cfg = qt.QuantConfig(weight_only=True, weight_bits=4, w4_group=64)
    errs = {}
    for method in ("nearest", "adaround", "gptq"):
        layer = qt.Linear(k, n, config=cfg, device="cpu")
        layer.load_weight(w)
        layer.load_bias(b)
        if method == "adaround":
            tutils.adaround(One(layer), x, iters=300)
        elif method == "gptq":
            tutils.gptq(One(layer), x)
        layer.convert()
        errs[method] = _mse(layer, x, w, b)
    assert errs["gptq"] < errs["nearest"] * 0.7, errs
    assert errs["adaround"] < errs["nearest"], errs


def test_w8_static_gptq_rides_convert():
    rng = np.random.default_rng(2)
    k, n = 64, 16
    w = rng.normal(0, 0.1, (n, k)).astype(np.float32)
    b = rng.normal(0, 0.05, n).astype(np.float32)
    x = _correlated(512, k, rank=4, seed=3)
    outs = {}
    for use in (False, True):
        layer = qt.Linear(k, n, device="cpu")
        layer.load_weight(w)
        layer.load_bias(b)
        layer.prepare()
        layer(qt.tensor(x, device="cpu"))
        if use:
            tutils.gptq(One(layer), x)
        layer.convert()
        if use:
            np.testing.assert_array_equal(layer.qw.numpy(),
                                          layer._adaround_qw.numpy())
        qx = TF.quantize(qt.tensor(x, device="cpu"),
                         float(np.abs(x).max()) / 127.0, 128)
        outs[use] = TF.dequantize(layer(qx)).numpy()
    ref = x @ w.T + b
    e = {u: float(np.mean((v - ref) ** 2)) for u, v in outs.items()}
    assert e[True] < e[False], e


def test_model_level_gptq_w4_weight_only():
    m = tzoo.build("gpt_tiny", config=qt.QuantConfig(
        weight_only=True, weight_bits=4), device="cpu")
    m.load(jzoo.torch_twin("gpt_tiny").state_dict())
    ids = np.random.default_rng(4).integers(0, 1000, (8, 64)).astype(
        np.int32)
    with pytest.raises(RuntimeError, match="before convert"):
        m.is_quant = True
        tutils.gptq(m, ids)
    m.is_quant = False
    tutils.gptq(m, ids)
    stashed = [l for _, l in m.named_layers()
               if getattr(l, "_adaround_qw", None) is not None]
    assert len(stashed) == 2 * 6 + 1          # 6 Linears a block + head
    m.convert()
    toks = m.generate(ids[:2, :8], 5)
    assert toks.shape == (2, 5)
    assert np.isfinite(m(qt.tensor(ids, device="cpu")).numpy()).all()
