"""PyTorch port vs JAX package: SmoothQuant-style smoothing
(``utils.smooth``, ``utils.transformer_smooth_pairs``), mirroring
``tests/test_smooth.py``.

Three families at a tiny size, each in the outlier regime of the JAX
tests (4 hot channels a norm, gain x30, the consumers' columns /30: the
same FP32 function), built in both packages from the same numpy-seeded
state: ``text_tiny`` (LayerNorm with bias), ``llama_tiny`` (RMSNorm, the
gate + up pair) and ``gemma_tiny`` (unit-offset RMSNorm: the gain is ``1 +
w``, so the hot channels get ``30 (1 + w) - 1`` and smoothing folds ``(1 +
w) / s - 1``).

* ``s``: the port computes ``amax^a / wmax^(1-a)`` in float64 and rounds
  once; JAX in float32 (two powers and a quotient, each rounded).  On the
  same maxima they are at most 3 ULPs apart (2 at alpha 0.5).  The maxima
  themselves come from each package's tapped FP32 forward, which differ by
  ULPs (the port's LayerNorm takes its mean and variance in float64), so
  the rewritten gains, biases and Linear weights are within 12 ULPs of the
  JAX package's (a unit-offset gain: ``1 + w``; measured 9 for text_tiny,
  2 for llama_tiny, 4 for gemma_tiny).
* The smoothed FP32 logits equal the unsmoothed ones to 2e-4 (the JAX
  tests' bound), and the INT8 error falls as the JAX tests ask (text: MSE
  below 0.6x; llama and gemma: last-position RMS below 0.5x).
* The port's smoothed weights, converted at the JAX package's calibrated
  grids, give INT8 logits within 2 codes of the JAX package's everywhere
  and equal on at least 99% of entries (the repo's contract).  The grids
  are carried because each package's own calibration forward is ULPs
  apart from the other's with or without the lever: at these seeds the
  unsmoothed gemma's own lifecycle is already 16 codes apart on 3% of its
  logits, while both packages' converted state carried over gives equal
  codes (``tests/test_torch_gemma.py``).
* The port's own smoothed lifecycle against the JAX package's
  (``OWN_GATE``, measured): every zero point equal, the output scales
  within 3 / 6 / 11 float32 ULPs, every head code equal for text_tiny and
  llama_tiny and 97.84% for gemma_tiny (within 2 steps).
* The pairs lists equal the JAX package's (the MoE decoder's ln2 stays
  unsmoothed), and the guards raise the JAX package's types.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import int8inferenceengine_tpu as qj
from int8inferenceengine_tpu import QuantConfig as JConfig
from int8inferenceengine_tpu import utils as jutils
from int8inferenceengine_tpu.models import zoo as jzoo
from int8inferenceengine_tpu.models.gemma import torch_gemma
from int8inferenceengine_tpu.models.llama import torch_llama
from int8inferenceengine_tpu.models.text_transformer import \
    torch_text_transformer
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch import utils as tutils
from int8inferenceengine_tpu_torch.models import zoo as tzoo
from int8inferenceengine_tpu_torch.utils.smooth import smoothing_factor
from test_torch_cnn_zoo import jax_forward
from test_torch_text_decoder import assert_own_gate, own_calibration_gap
from test_torch_threads import one_torch_thread  # noqa: F401

GEO = {
    "text_tiny": dict(vocab_size=200, max_len=16, dim=64, depth=2, heads=2,
                      mlp_ratio=2),
    "llama_tiny": dict(vocab_size=97, max_len=32, dim=64, depth=2, heads=4,
                       kv_heads=2),
    "gemma_tiny": dict(vocab_size=97, max_len=32, dim=64, depth=2, heads=4,
                       kv_heads=2, sliding_window=8),
}
TWIN = {"text_tiny": torch_text_transformer, "llama_tiny": torch_llama,
        "gemma_tiny": torch_gemma}
CFG = {"text_tiny": {}, "llama_tiny": dict(rounding="nearest"),
       "gemma_tiny": dict(rounding="nearest")}
SEQ = {"text_tiny": 16, "llama_tiny": 32, "gemma_tiny": 32}


def _ids(name, b, seed):
    return np.random.default_rng(seed).integers(
        0, GEO[name]["vocab_size"], (b, SEQ[name])).astype(np.int32)


def _outlier_state(name):
    """The twin's state in the outlier regime: on every smoothed norm, 4
    hot channels take 30x the gain (and bias), the consumers' columns
    1/30; gemma's unit-offset deltas start from N(0, 0.1)."""
    sd = {k: v.numpy().copy()
          for k, v in TWIN[name](**GEO[name]).state_dict().items()}
    rng = np.random.default_rng(5)
    unit = name == "gemma_tiny"
    if unit:
        for key in sd:
            if key.startswith(("ln", "postn")):
                sd[key] = (0.1 * rng.standard_normal(sd[key].shape)
                           ).astype(np.float32)
    pairs = tutils.transformer_smooth_pairs(tzoo.build(
        name, device="cpu", **GEO[name]))
    for ln_name, lin_names in pairs:
        hot = rng.choice(GEO[name]["dim"], 4, replace=False)
        g = sd[f"{ln_name}.weight"]
        g[hot] = 30.0 * (1.0 + g[hot]) - 1.0 if unit else 30.0 * g[hot]
        if f"{ln_name}.bias" in sd:
            sd[f"{ln_name}.bias"][hot] *= 30.0
        for n in lin_names:
            sd[f"{n}.weight"][:, hot] /= 30.0
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def _jax_model(name, state):
    m = jzoo.build(name, config=JConfig(**CFG[name]), **GEO[name])
    m.load(state)
    return m


def _port_model(name, state):
    m = tzoo.build(name, config=qt.QuantConfig(**CFG[name]), device="cpu",
                   **GEO[name])
    m.load(state)
    return m


def _convert(m, ids, tensor):
    m.prepare()
    m(tensor(ids))
    m.convert()
    return m


def _cpu(x):
    return qt.tensor(x, device="cpu")


class _Fixed:
    """A calibrator that returns a carried (scale, zero_point)."""

    def __init__(self, grid):
        self.grid = grid

    def sample(self, x):
        pass

    def get_range(self, quantile=None):
        return self.grid

    def stats(self):
        return {"count": 0, "min": None, "max": None}


@pytest.fixture(scope="module", params=list(GEO))
def fam(request):
    """Each family's models before and after smoothing, in both packages,
    the JAX package's INT8 logits, and the port's smoothed model converted
    on its own calibration and at the JAX package's grids; built once."""
    name = request.param
    state = _outlier_state(name)
    ids_c, ids_t = _ids(name, 8, 2), _ids(name, 8, 3)
    mj, mt, plain = (_jax_model(name, state), _port_model(name, state),
                     _port_model(name, state))
    jutils.smooth(mj, jutils.transformer_smooth_pairs(mj), ids_c)
    tutils.smooth(mt, tutils.transformer_smooth_pairs(mt), ids_c)
    smoothed = {n: {k: v.clone() for k, v in l.state_dict().items()
                    if v is not None}
                for n, l in mt.named_layers()}
    jax_params = {n: {k: np.asarray(v) for k, v in l.params.items()}
                  for n, l in mj.named_layers()}
    fp32 = {"plain": plain(_cpu(ids_t)).numpy(),
            "smoothed": mt(_cpu(ids_t)).numpy()}
    at_jax_grids = copy.deepcopy(mt)
    _convert(mj, ids_c, qj.tensor)
    _convert(mt, ids_c, _cpu)
    at_jax_grids.prepare()
    for n, layer in at_jax_grids.named_layers():
        jl = dict(mj.named_layers())[n]
        layer.calibrator = _Fixed((jl.scale, jl.zero_point))
    at_jax_grids.convert()
    return dict(name=name, state=state, ids_c=ids_c, ids_t=ids_t,
                smoothed=smoothed, jax_params=jax_params, fp32=fp32,
                port_int8=mt, at_jax_grids=at_jax_grids,
                jax_int8=jax_forward(mj, ids_t.astype(np.float32)))


def test_smoothing_factor_within_ulps_of_jax():
    rng = np.random.default_rng(0)
    amax = np.abs(rng.standard_normal(4096) * 10).astype(np.float32) + 1e-5
    wmax = np.abs(rng.standard_normal(4096) * 0.1).astype(np.float32) + 1e-5
    for alpha in (0.5, 0.8):
        got = smoothing_factor(torch.from_numpy(amax),
                               torch.from_numpy(wmax), alpha).numpy()
        a, w = jnp.asarray(amax), jnp.asarray(wmax)
        want = np.asarray(jnp.clip(a ** alpha / w ** (1.0 - alpha), 1e-5,
                                   1e5))
        np.testing.assert_array_max_ulp(got, want,
                                        maxulp=2 if alpha == 0.5 else 3)


def test_rewritten_weights_within_ulps_of_jax(fam):
    unit = fam["name"] == "gemma_tiny"
    for name, bufs in fam["smoothed"].items():
        want = fam["jax_params"][name]
        for key in ("weight", "bias"):
            if key not in bufs or key not in want:
                continue
            got, exp = bufs[key].numpy(), want[key]
            if unit and name.startswith(("ln", "postn")):
                got, exp = 1.0 + got, 1.0 + exp        # the effective gain
            np.testing.assert_array_max_ulp(got, exp, maxulp=12)


def test_fp32_invariance(fam):
    np.testing.assert_allclose(fam["fp32"]["smoothed"], fam["fp32"]["plain"],
                               rtol=2e-4, atol=2e-4)


def test_int8_codes_within_the_contract_of_jax(fam):
    m = fam["at_jax_grids"]
    got = m(_cpu(fam["ids_t"])).numpy()
    steps = np.abs(got - fam["jax_int8"]) / m.head.scale
    assert steps.max() <= 2 + 1e-3, steps.max()
    assert (steps < 0.5).mean() >= 0.99, (steps < 0.5).mean()


# measured: the largest scale distance, the share of equal head codes and
# their largest distance
OWN_GATE = {"text_tiny": dict(scale_ulps=3, equal=1.0, max_dist=0),
            "llama_tiny": dict(scale_ulps=6, equal=1.0, max_dist=0),
            "gemma_tiny": dict(scale_ulps=11, equal=0.9784, max_dist=2)}


def test_own_calibration_gate(fam):
    """The port's own smoothed lifecycle against the JAX package's on the
    same state and ids (in the outlier regime): every zero point equal,
    the output scales within ``OWN_GATE``'s float32 ULPs of the JAX
    package's and the logit codes within its share and distance (the
    smoothed weights are themselves ULPs apart, see above)."""
    m, grids = fam["port_int8"], dict(fam["at_jax_grids"].named_layers())
    state = {n: dict(scale=g.scale, zero_point=g.zero_point)
             for n, g in grids.items()}
    got = m(_cpu(fam["ids_t"])).numpy()
    gap = own_calibration_gap(m, state, got, fam["jax_int8"])
    assert_own_gate(gap, **OWN_GATE[fam["name"]])


def test_int8_error_falls(fam):
    name = fam["name"]
    want = fam["fp32"]["plain"]
    plain = _convert(_port_model(name, fam["state"]), fam["ids_c"], _cpu)
    errs = {}
    for label, m in (("plain", plain), ("smoothed", fam["port_int8"])):
        got = m(_cpu(fam["ids_t"])).numpy()
        if name == "text_tiny":
            errs[label] = float(np.mean((got - want) ** 2))
        else:
            errs[label] = float(np.sqrt(np.mean(
                (got[:, -1] - want[:, -1]) ** 2)))
    bound = 0.6 if name == "text_tiny" else 0.5
    assert errs["smoothed"] < bound * errs["plain"], errs


@pytest.mark.parametrize("name", ["text_tiny", "gpt_tiny", "llama_tiny",
                                  "gemma_tiny", "moe_tiny"])
def test_pairs_equal_jax(name):
    geo = dict(vocab_size=61, max_len=16, dim=32, depth=2, heads=2)
    got = tutils.transformer_smooth_pairs(tzoo.build(name, device="cpu",
                                                     **geo))
    assert got == jutils.transformer_smooth_pairs(jzoo.build(name, **geo))
    assert ("ln2_1" in dict(got)) == (name != "moe_tiny")


@pytest.mark.parametrize("case", ["prepared", "converted", "not_a_norm",
                                  "off_path"])
def test_guards_raise_the_jax_types(case):
    name = "llama_tiny"
    ids = _ids(name, 2, 4)
    state = TWIN[name](**GEO[name]).state_dict()
    raised = []
    for build, u, tensor, linear in (
            (_jax_model, jutils, qj.tensor, qj.Linear),
            (_port_model, tutils, _cpu,
             lambda *a: qt.Linear(*a, device="cpu"))):
        m = build(name, state)
        pairs = u.transformer_smooth_pairs(m)
        if case == "prepared":
            m.prepare()
        elif case == "converted":
            m.is_quant = True                 # what convert() leaves set
        elif case == "not_a_norm":
            pairs = [("wq1", ["wk1"])]
            m.forward = lambda x: x           # the pair check comes first
        else:
            pairs = [("ln1_1", ["head"])]     # a fresh head reads nothing
            del m.head
            m.head = linear(64, 97)
            m.forward = lambda x: x
        with pytest.raises(Exception) as info:
            u.smooth(m, pairs, ids)
        raised.append(info.type)
    want = {"prepared": RuntimeError, "converted": RuntimeError,
            "not_a_norm": TypeError, "off_path": ValueError}[case]
    assert raised == [want, want], raised
