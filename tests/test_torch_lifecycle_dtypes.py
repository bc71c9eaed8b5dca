"""PyTorch port vs JAX package: the last lifecycle knobs.

Mirrors ``tests/test_glue_dtype.py``, the space-to-depth cases of
``tests/test_conv_lowering.py``, ``tests/test_models.py::
test_bf16_epilogue_accuracy`` and the op-level cases of
``tests/test_decode_attention.py`` that the port's other tests do not
cover, on the same seeded numpy inputs:

* ``glue_dtype='bfloat16'``: each pointwise layer's codes (QuantAct's
  hardswish, sigmoid and silu, QuantAdd, QuantMul, QuantConcat) equal to
  the JAX package's eager bfloat16 glue and within 2 codes of the port's
  own float32 glue (``test_glue_dtype.py``'s contract);
* ``epilogue_dtype='bfloat16'``: the port's ``down_scale`` replays the JAX
  package's bfloat16 order op by op (every op rounded).  Measured on these
  accumulators (|acc| up to 2^26, so the s32 -> bfloat16 cast rounds
  twice on some): the codes equal the JAX package's eager and jitted
  ``down_scale`` on every element (a share of 0 differ), and sit within 2
  codes of the float32 epilogue, as the JAX package's own do.  On a model
  the port's codes equal the JAX model's;
* ``conv_backend='xla_conv'`` (another name for 'auto' in the port):
  codes equal the JAX package's 'xla_conv' (and the port's 'auto'), bit
  for bit, with and without the pre-laid-out input;
* ``s2d_input`` / ``s2d_weights`` equal the JAX package's;
* ``fp_dtype='bfloat16'`` is accepted and changes nothing;
* the head-split ``decode_attention`` against the JAX package's
  ``backend='xla'`` within the reference's contract (at most 1 code on at
  most 0.2%), and equal to the port's ``decode_attention_flat``.

On the card (``cuda``-marked): B1's gathered conv and G1 under the
bfloat16 epilogue equal their plain versions bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import int8inferenceengine_tpu as qj
from int8inferenceengine_tpu.layers import QuantAct as JQuantAct
from int8inferenceengine_tpu.layers import QuantAdd as JQuantAdd
from int8inferenceengine_tpu.layers import QuantConcat as JQuantConcat
from int8inferenceengine_tpu.layers import QuantMul as JQuantMul
from int8inferenceengine_tpu.ops import attention as jattn
from int8inferenceengine_tpu.ops import conv as jconv
from int8inferenceengine_tpu.ops import quant as jquant
from int8inferenceengine_tpu.tensor import Tensor as JTensor
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch.carry import export_state, load_jax_state
from int8inferenceengine_tpu_torch.ops import attention as tattn
from int8inferenceengine_tpu_torch.ops import conv as C
from int8inferenceengine_tpu_torch.ops import gemm_int8 as G
from int8inferenceengine_tpu_torch.ops import quant as tquant
from int8inferenceengine_tpu_torch.tensor import Tensor
from test_torch_cnn_zoo import install_jax_state, jax_forward
from test_torch_threads import one_torch_thread  # noqa: F401

BF16_GLUE = dict(glue_dtype="bfloat16")


def _floats(seed, shape, lo=-2.0, hi=2.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _codes(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


def _gap(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(int)
                      - np.asarray(b).astype(int)).max())


# -- bfloat16 glue ------------------------------------------------------------

GLUE = {
    "hardswish": (lambda c: qt.QuantAct("hardswish", config=c, device="cpu"),
                  lambda c: JQuantAct("hardswish", config=c), 1),
    "sigmoid": (lambda c: qt.QuantAct("sigmoid", config=c, device="cpu"),
                lambda c: JQuantAct("sigmoid", config=c), 1),
    "silu": (lambda c: qt.QuantAct("silu", config=c, device="cpu"),
             lambda c: JQuantAct("silu", config=c), 1),
    "add": (lambda c: qt.QuantAdd(config=c, device="cpu"),
            lambda c: JQuantAdd(config=c), 2),
    "mul": (lambda c: qt.QuantMul(config=c, device="cpu"),
            lambda c: JQuantMul(config=c), 2),
    "concat": (lambda c: qt.QuantConcat(config=c, device="cpu"),
               lambda c: JQuantConcat(config=c), 2),
}


@pytest.mark.parametrize("kind", list(GLUE))
def test_bf16_glue_within_2_codes_of_jax_and_f32(kind):
    make, jmake, arity = GLUE[kind]
    xs = [_floats(seed, (2, 16, 5, 5)) for seed in range(1, arity + 1)]
    f32l, bf16l = make(qt.DEFAULT_CONFIG), make(qt.QuantConfig(**BF16_GLUE))
    for layer in (f32l, bf16l):
        layer.prepare()
        layer(*[qt.tensor(x, device="cpu") for x in xs])
        layer.convert()
    jl = jmake(qj.QuantConfig(**BF16_GLUE))
    jl.scale, jl.zero_point = bf16l.scale, bf16l.zero_point
    jl.is_quantized, jl.is_preparing = True, False
    grids = [(0.02, 128), (0.027, 119)][:arity]
    codes = [_codes(10 + i, x.shape) for i, x in enumerate(xs)]
    ins = [Tensor(torch.from_numpy(c), s, z) for c, (s, z) in zip(codes,
                                                                  grids)]
    jins = [JTensor(jnp.asarray(c), s, z) for c, (s, z) in zip(codes, grids)]
    got = bf16l(*ins).data.numpy()
    assert _gap(got, f32l(*ins).data.numpy()) <= 2
    # measured: the JAX package's eager bfloat16 glue on every code (on
    # EfficientNet-B0's glue layers too, where both are 3 codes from the
    # float32 glue at the squeeze-excite sigmoids)
    with jax.disable_jit():
        assert _gap(got, jl(*jins).data) == 0
    if kind in ("hardswish", "sigmoid", "silu"):
        lut = qt.QuantAct(kind, config=qt.QuantConfig(**BF16_GLUE),
                          backend="lut", device="cpu")
        lut.scale, lut.zero_point = bf16l.scale, bf16l.zero_point
        lut.is_quantized = True
        np.testing.assert_array_equal(lut(ins[0]).data.numpy(), got)


def test_bf16_glue_keeps_the_act_out_of_the_gemm():
    """``fused_linear_act`` composes a bfloat16-glue activation, as the
    JAX package's gate does: the codes are the layers' own."""
    from int8inferenceengine_tpu_torch.layers import fused_linear_act
    cfg = qt.QuantConfig(**BF16_GLUE)
    lin = qt.Linear(16, 8, config=cfg, device="cpu")
    act = qt.QuantAct("silu", config=cfg, device="cpu")
    rng = np.random.default_rng(2)
    lin.load_weight(rng.normal(0, 0.3, (8, 16)).astype(np.float32))
    lin.load_bias(rng.normal(0, 0.1, (8,)).astype(np.float32))
    x = _floats(3, (32, 16))
    for layer in (lin, act):
        layer.prepare()
    act(lin(qt.tensor(x, device="cpu")))
    for layer in (lin, act):
        layer.convert()
    qx = Tensor(torch.from_numpy(_codes(4, (32, 16))), 0.02, 128)
    np.testing.assert_array_equal(fused_linear_act(lin, act, qx).data.numpy(),
                                  act(lin(qx)).data.numpy())


# -- the bfloat16 conv epilogue -----------------------------------------------

def _accumulators():
    rng = np.random.default_rng(5)
    return np.concatenate([rng.integers(-2**14, 2**14, (1500, 48)),
                           rng.integers(-2**26, 2**26, (300, 48))]
                          ).astype(np.int32)


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("rounding", ["trunc", "nearest"])
def test_bf16_down_scale_equals_jax_eager_and_jitted(per_channel, rounding):
    acc = _accumulators()
    sw = (np.random.default_rng(6).uniform(0.001, 0.02, 48).astype(np.float32)
          if per_channel else np.float32(0.0123))
    s_a, s_c, zp = 0.0173, 12.33, 113
    jsw = jnp.asarray(sw) if per_channel else float(sw)
    tsw = torch.from_numpy(sw) if per_channel else float(sw)
    got = tquant.down_scale(torch.from_numpy(acc), s_a, tsw, s_c, zp,
                            rounding, compute_dtype=torch.bfloat16).numpy()

    def jfn(a):
        return jquant.down_scale(a, s_a, jsw, s_c, zp,
                                 compute_dtype=jnp.bfloat16,
                                 rounding=rounding)

    eager = np.asarray(jfn(jnp.asarray(acc)))
    jitted = np.asarray(jax.jit(jfn)(jnp.asarray(acc)))
    # measured: no element differs from either (share 0)
    np.testing.assert_array_equal(got, eager)
    np.testing.assert_array_equal(got, jitted)
    f32 = tquant.down_scale(torch.from_numpy(acc), s_a, tsw, s_c, zp,
                            rounding).numpy()
    assert _gap(got, f32) <= 2
    # the epilogue vector of the kernels' 'conv_bf16' order and its tail
    ep = G.epilogue_vector(s_a, tsw, s_c, 48, "cpu", "conv_bf16")
    np.testing.assert_array_equal(ep.numpy(), tquant.bf16_multiplier(
        s_a, tsw, s_c, "cpu").float().expand(48).numpy())
    tail = G._requant_epilogue(torch.from_numpy(acc), ep, scale_a=s_a,
                               scale_c=s_c, zp_c=zp, rounding=rounding,
                               order="conv_bf16")
    np.testing.assert_array_equal(tail.numpy(), got)


def test_grouped_plain_takes_the_bf16_order():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(_codes(8, (2, 9, 9, 16)))
    qw = torch.from_numpy(rng.integers(-127, 128, (16, 9)).astype(np.int8))
    oc = torch.from_numpy(rng.integers(-5000, 5000, (16,)).astype(np.int32))
    kw = dict(groups=16, kh=3, kw=3, stride=1, padding=1, scale_a=0.02,
              zp_a=120, scale_c=0.05, zp_c=100)
    ep = G.epilogue_vector(0.02, 0.01, 0.05, 16, "cpu", "conv_bf16")
    got = C.conv2d_int8_grouped(x, qw, oc, ep, order="conv_bf16", **kw)
    ep32 = G.epilogue_vector(0.02, 0.01, 0.05, 16, "cpu", "conv")
    f32 = C.conv2d_int8_grouped(x, qw, oc, ep32, **kw)
    assert 0 < _gap(got, f32) <= 2
    with pytest.raises(ValueError, match="order"):
        C.conv2d_int8_grouped(x, qw, oc, ep, order="gemm", **kw)


class _Net(qt.Module):
    """A strided small-C conv (space-to-depth'ed by the JAX package), a
    stride-1 conv with relu, a depthwise conv and a Linear."""

    def __init__(self, config=qt.DEFAULT_CONFIG):
        super().__init__(config, device="cpu")
        self.conv1 = qt.Conv2d(3, 8, 5, stride=2, padding=2, config=config,
                               device="cpu")
        self.conv2 = qt.Conv2d(8, 8, 3, padding=1, fuse_relu=True,
                               config=config, device="cpu")
        self.dw = qt.Conv2d(8, 8, 3, padding=1, groups=8, config=config,
                            device="cpu")
        self.fc = qt.Linear(8 * 9 * 9, 10, config=config, device="cpu")

    def forward(self, x):
        x = self.dw(self.conv2(self.conv1(x)))
        return self.fc(x.reshape(-1, 8 * 9 * 9))


class _JNet(qj.Module):
    def __init__(self, config=qj.DEFAULT_CONFIG):
        super().__init__(config)
        self.conv1 = qj.Conv2d(3, 8, 5, stride=2, padding=2, config=config)
        self.conv2 = qj.Conv2d(8, 8, 3, padding=1, fuse_relu=True,
                               config=config)
        self.dw = qj.Conv2d(8, 8, 3, padding=1, groups=8, config=config)
        self.fc = qj.Linear(8 * 9 * 9, 10, config=config)

    def forward(self, x):
        x = self.dw(self.conv2(self.conv1(x)))
        return self.fc(x.reshape(-1, 8 * 9 * 9))


@pytest.fixture(scope="module")
def net_state():
    """A converted ``_Net`` state (float32 config) and a test batch."""
    m = _Net()
    rng = np.random.default_rng(9)
    for name, layer in m.named_layers():
        layer.load_weight(rng.normal(0, 0.3, layer.weight.shape).astype(
            np.float32))
        layer.load_bias(rng.normal(0, 0.1, layer.bias.shape).astype(
            np.float32))
    m.prepare()
    m(qt.tensor(_floats(10, (8, 3, 17, 17), -1, 1), device="cpu"))
    m.convert()
    return export_state(m), _floats(11, (8, 3, 17, 17), -1, 1)


def _port(state, **cfg):
    m = _Net(qt.QuantConfig(**cfg))
    load_jax_state(m, state)
    return m


@pytest.mark.parametrize("epilogue", ["float32", "bfloat16"])
def test_xla_conv_and_bf16_epilogue_equal_jax(net_state, epilogue):
    state, x = net_state
    outs = {}
    for backend in ("auto", "xla_conv"):
        m = _port(state, conv_backend=backend, epilogue_dtype=epilogue)
        xt = qt.tensor(x, device="cpu")
        outs[backend] = m(xt).numpy()
        # the host pre-laid-out input gives the same codes
        q = (m.config.input_scale, m.config.input_zero_point)
        (batch,) = list(qt.DataLoader(x, batch_size=8, quantize_to=q,
                                      layout_for=m, device="cpu"))
        np.testing.assert_array_equal(m(batch).numpy(), outs[backend])
    np.testing.assert_array_equal(outs["xla_conv"], outs["auto"])
    jm = _JNet(qj.QuantConfig(conv_backend="xla_conv",
                              epilogue_dtype=epilogue))
    install_jax_state(jm, state)
    np.testing.assert_array_equal(outs["auto"], jax_forward(jm, x))
    if epilogue == "bfloat16":
        f32 = _port(state)(qt.tensor(x, device="cpu")).numpy()
        denom = np.abs(f32).mean() + 1e-9
        assert np.abs(outs["auto"] - f32).mean() / denom < 0.1


def test_gemm_backend_ignores_the_bf16_epilogue(net_state):
    """Under 'gemm' the groups == 1 convs keep the GEMM order and only the
    grouped conv (which the JAX package sends to its integer conv whatever
    the backend) takes the bfloat16 epilogue: the JAX model's codes."""
    state, x = net_state
    got = _port(state, conv_backend="gemm", epilogue_dtype="bfloat16")(
        qt.tensor(x, device="cpu")).numpy()
    jm = _JNet(qj.QuantConfig(conv_backend="gemm", epilogue_dtype="bfloat16"))
    install_jax_state(jm, state)
    np.testing.assert_array_equal(got, jax_forward(jm, x))


def test_fp_dtype_bf16_is_accepted_and_changes_nothing(net_state):
    state, x = net_state
    np.testing.assert_array_equal(
        _port(state, fp_dtype="bfloat16")(qt.tensor(x, device="cpu")).numpy(),
        _port(state)(qt.tensor(x, device="cpu")).numpy())


# -- space-to-depth -------------------------------------------------------------

@pytest.mark.parametrize("h,ci,co,k,s,p", [
    (64, 3, 16, 11, 4, 2),    # AlexNet conv1's window at a reduced size
    (28, 3, 16, 5, 2, 1), (16, 4, 8, 3, 3, 0), (15, 2, 8, 4, 2, 2),
    (32, 8, 16, 5, 4, 0)])
def test_s2d_halves_equal_jax(h, ci, co, k, s, p):
    rng = np.random.default_rng(h + ci + k)
    x = rng.integers(0, 256, (2, h + 2 * p, h + 2 * p, ci), dtype=np.uint8)
    w = rng.integers(-127, 128, (k, k, ci, co), dtype=np.int8)
    want = np.asarray(jconv.s2d_input(jnp.asarray(x), k, k, s, 9))
    np.testing.assert_array_equal(C.s2d_input(x, k, k, s, np.uint8(9)), want)
    np.testing.assert_array_equal(
        C.s2d_weights(torch.from_numpy(w), s).numpy(),
        np.asarray(jconv.s2d_weights(jnp.asarray(w), s)))


# -- the head-split decode attention ------------------------------------------

B, H, T, D = 2, 3, 64, 16
PARAMS = dict(scale_q=0.021, zp_q=117, scale_k=0.034, zp_k=131,
              scale_v=0.027, zp_v=125, scale_s=0.19, zp_s=140,
              scale_p=0.0039, zp_p=0, scale_c=0.05, zp_c=128,
              alpha=D ** -0.5)


@pytest.mark.parametrize("rounding", ["trunc", "nearest"])
@pytest.mark.parametrize("valid", [1, 7, T, "per_slot"])
def test_headsplit_decode_attention_within_contract_of_jax(rounding, valid):
    q, k, v = (_codes(1, (B, H, 1, D)), _codes(2, (B, H, T, D)),
               _codes(3, (B, H, T, D)))
    vv = np.asarray([5, 11], np.int32) if valid == "per_slot" else valid
    jv = jnp.asarray(vv).reshape(B, 1, 1, 1) if valid == "per_slot" \
        else jnp.int32(vv)
    want = np.asarray(jattn.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jv, backend="xla",
        rounding=rounding, **PARAMS))
    tv = torch.from_numpy(vv).reshape(B, 1, 1, 1) if valid == "per_slot" \
        else vv
    got = tattn.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tv,
        rounding=rounding, **PARAMS).numpy()
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.002
    flat = tattn.decode_attention_flat(
        torch.from_numpy(q).reshape(B, H * D),
        torch.from_numpy(k).permute(0, 2, 1, 3).reshape(B, T, H * D),
        torch.from_numpy(v).permute(0, 2, 1, 3).reshape(B, T, H * D),
        torch.from_numpy(np.asarray(vv, np.int32)).reshape(-1)
        if valid == "per_slot" else vv, n_heads=H, rounding=rounding,
        **PARAMS)
    np.testing.assert_array_equal(got.reshape(B, H * D), flat.numpy())


def test_headsplit_gqa_and_refusals():
    h, hkv, d, t = 12, 2, 16, 40
    q, k, v = (_codes(4, (B, h, 1, d)), _codes(5, (B, hkv, t, d)),
               _codes(6, (B, hkv, t, d)))
    kw = dict(PARAMS, alpha=d ** -0.5)
    got = tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), 29, **kw)
    flat = tattn.decode_attention_flat(
        torch.from_numpy(q).reshape(B, h * d),
        torch.from_numpy(k).permute(0, 2, 1, 3).reshape(B, t, hkv * d),
        torch.from_numpy(v).permute(0, 2, 1, 3).reshape(B, t, hkv * d), 29,
        n_heads=h, n_kv_heads=hkv, **kw)
    assert tuple(got.shape) == (B, h, 1, d)
    np.testing.assert_array_equal(got.reshape(B, h * d).numpy(),
                                  flat.numpy())
    with pytest.raises(ValueError, match="one query row"):
        tattn.decode_attention(torch.from_numpy(_codes(7, (B, H, 2, D))),
                               torch.from_numpy(k), torch.from_numpy(v), 4,
                               **PARAMS)


# -- the knobs ------------------------------------------------------------------

@pytest.mark.parametrize("field,value", [
    ("glue_dtype", "bfloat16"), ("epilogue_dtype", "bfloat16"),
    ("fp_dtype", "bfloat16"), ("conv_backend", "xla_conv")])
def test_knobs_are_accepted(field, value):
    cfg = qt.QuantConfig(**{field: value})
    qt.Conv2d(3, 4, 3, config=cfg, device="cpu")
    qt.QuantAct("silu", config=cfg, device="cpu")


# -- on the card ------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: B1 and G1 run only there")
    return torch.device("cuda")


def _conv_operands(card, gen, b, h, c, o, k, groups=1):
    x = torch.randint(0, 256, (b, h, h, c), generator=gen, dtype=torch.uint8,
                      device=card)
    qw = torch.randint(-127, 128, (o, k * k * c // groups), generator=gen,
                       dtype=torch.int8, device=card)
    qb = torch.randint(-127, 128, (o,), generator=gen, dtype=torch.int8,
                       device=card)
    oc = G.compute_offset(qb, qw.to(torch.int32).sum(1, dtype=torch.int32),
                          0.02, 121, recentered=True)
    s_w = torch.rand((o,), generator=gen, device=card) * 0.015 + 0.005
    return x, qw, oc, s_w


@pytest.mark.cuda
@pytest.mark.parametrize("geom", [(2, 57, 48, 64, 3, 1, 0),
                                  (2, 27, 64, 96, 5, 1, 2),
                                  (2, 15, 3, 16, 11, 4, 2)])
def test_b1_bf16_epilogue_matches_plain_on_card(card, geom):
    b, h, c, o, k, stride, pad = geom
    gen = torch.Generator(device=card).manual_seed(0)
    x, qw, oc, s_w = _conv_operands(card, gen, b, h, c, o, k)
    ep = G.epilogue_vector(0.02, s_w, 0.02 * 0.01 * 74 * 74 * (k * k * c)
                           ** 0.5 / 60, o, card, "conv_bf16")
    for rounding, relu in (("trunc", True), ("nearest", False)):
        kw = dict(kh=k, kw=k, stride=stride, padding=pad, scale_a=0.02,
                  zp_a=121, scale_c=1.0, zp_c=110, relu=relu,
                  rounding=rounding, order="conv_bf16")
        before = G.qgemm.launches
        got = C.qgemm_conv(x, qw, oc, ep, **kw)
        assert G.qgemm.launches - before == 1
        want = C.conv2d_int8_gemm(x, qw, oc, ep, gemm=G.qgemm_plain, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 14, 96, 96, 96, 3, 2),
                                   (2, 9, 58, 58, 58, 3, 1),
                                   (2, 8, 32, 32, 4, 3, 1)])
def test_g1_bf16_epilogue_matches_plain_on_card(card, shape):
    b, h, c, o, groups, k, stride = shape
    gen = torch.Generator(device=card).manual_seed(1)
    x, qw, oc, s_w = _conv_operands(card, gen, b, h, c, o, k, groups)
    ep = G.epilogue_vector(0.02, s_w, 0.3, o, card, "conv_bf16")
    for rounding, relu in (("trunc", True), ("nearest", False)):
        kw = dict(groups=groups, kh=k, kw=k, stride=stride, padding=k // 2,
                  scale_a=0.02, zp_a=121, scale_c=0.3, zp_c=110, relu=relu,
                  rounding=rounding, order="conv_bf16")
        got = C.conv2d_int8_grouped(x, qw, oc, ep, **kw)
        want = C.conv2d_int8_grouped_plain(x, qw, oc, ep, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
