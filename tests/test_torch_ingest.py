"""PyTorch port vs JAX package: host ingest.

Mirrors ``tests/test_hostops.py``, ``tests/test_data.py`` and
``tests/test_serve.py::test_quantized_ingest_*`` on the same seeded numpy
inputs:

* the port's native host ops (``native``, its own copy of ``hostops.cc``
  built into ``int8inferenceengine_tpu_torch/_build/`` with the JAX
  Makefile's flags) give the JAX package's native ops' bytes, and equal
  their numpy twins (``*_plain``) within ``test_hostops.py``'s tolerance for
  each op.  Both libraries contract ``x * (1/255) - mean`` in
  ``normalize_nchw`` and ``preprocess_quantize`` into an FMA (GCC's default
  ``-ffp-contract=fast`` under ``-march=native``: ``vfmsub`` instructions in
  both builds), so the float32 results sit within an ULP of the twins'
  while the two libraries agree byte for byte.  A build that fails raises.
* ``DataLoader`` yields the JAX loader's batches, labels, errors and
  lengths in every mode (``device="cpu"``);
* ``ingest_descriptor`` gives the JAX tag under 'auto', 'xla_conv' and
  'gemm', on a stride-1 model and on a strided small-C first conv;
* on a tiny CNN whose first conv is 5 x 5 / 2 over 3 channels at 17 x 17,
  the pre-laid-out forward's codes equal the JAX package's
  ``DataLoader(layout_for=...)`` forward's (the port's converted state
  installed in the JAX model) and the port's own forward without the
  pre-layout;
* ``InferenceEngine(quantize_ingest=True)`` on the CPU equals ``model(...)``.
"""

import threading
import time

import numpy as np
import pytest
import torch

import int8inferenceengine_tpu as qj
from int8inferenceengine_tpu import native as jnative
from int8inferenceengine_tpu.data import DataLoader as JDataLoader
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch import native
from int8inferenceengine_tpu_torch.carry import export_state
from int8inferenceengine_tpu_torch.data import DataLoader
from int8inferenceengine_tpu_torch.models import zoo as tzoo
from int8inferenceengine_tpu_torch.serve import InferenceEngine
from test_torch_cnn_zoo import install_jax_state
from test_torch_threads import one_torch_thread  # noqa: F401

MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
STD = np.array([0.247, 0.243, 0.261], np.float32)
WAIT = 60


def _imgs(seed, shape=(6, 12, 12, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


def _floats(seed, shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


# -- the native host ops ------------------------------------------------------

def test_native_builds_into_the_package_build_dir():
    threads = torch.get_num_threads()
    assert native.available()
    assert native.library_path().exists()
    assert native.library_path().parent.name == "_build"
    assert native.library_path().parent.parent.name == \
        "int8inferenceengine_tpu_torch"
    # libgomp, loaded with the library, leaves torch's threads alone
    assert torch.get_num_threads() == threads


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "hostops.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.quantize_u8(np.zeros(4, np.float32), 0.1, 0)
    assert not native.available()


@pytest.mark.parametrize("scale,zp", [(0.025, 127), (0.0137, 3)])
def test_quantize_matches_jax_and_device_semantics(scale, zp):
    x = _floats(1, (3, 5, 7)) * 10
    got = native.quantize_u8(x, scale, zp)
    np.testing.assert_array_equal(got, jnative.quantize_u8(x, scale, zp))
    np.testing.assert_array_equal(got, native.quantize_u8_plain(x, scale, zp))
    # the card's quantize (ops/quant.quantize_u8) on the same floats
    from int8inferenceengine_tpu_torch.ops.quant import quantize_u8
    np.testing.assert_array_equal(
        got, quantize_u8(torch.from_numpy(x), scale, zp).numpy())


def test_quantize_extremes_clamp():
    x = np.array([1e9, -1e9, 0.0], np.float32)
    np.testing.assert_array_equal(native.quantize_u8(x, 0.025, 127),
                                  [255, 0, 127])


def test_dequantize_matches_jax():
    q = _imgs(2, (64,))
    got = native.dequantize_u8(q, 0.1, 100)
    np.testing.assert_array_equal(got, jnative.dequantize_u8(q, 0.1, 100))
    np.testing.assert_allclose(got, native.dequantize_u8_plain(q, 0.1, 100),
                               rtol=1e-6)


def test_normalize_nchw_matches_jax():
    img = _imgs(3, (2, 8, 8, 3))
    got = native.normalize_nchw(img, MEAN, STD)
    assert got.shape == (2, 3, 8, 8)
    np.testing.assert_array_equal(got, jnative.normalize_nchw(img, MEAN, STD))
    np.testing.assert_allclose(got, native.normalize_nchw_plain(img, MEAN, STD),
                               atol=1e-5)


def test_resize_bilinear_matches_jax_and_torch():
    import torch.nn.functional as F
    img = _imgs(4, (2, 16, 16, 3))
    got = native.resize_bilinear(img, 32, 32)
    np.testing.assert_array_equal(got, jnative.resize_bilinear(img, 32, 32))
    assert np.abs(got.astype(int) - native.resize_bilinear_plain(
        img, 32, 32).astype(int)).max() <= 1
    want = F.interpolate(torch.tensor(img.transpose(0, 3, 1, 2),
                                      dtype=torch.float32), size=(32, 32),
                         mode="bilinear", align_corners=False)
    want = want.numpy().transpose(0, 2, 3, 1)
    assert np.abs(got.astype(np.int32)
                  - (want + 0.5).astype(np.int32)).max() <= 1


def test_preprocess_quantize_fused_equals_two_step_and_jax():
    img = _imgs(5, (4, 8, 8, 3))
    fused = native.preprocess_quantize(img, MEAN, STD, 0.025, 127)
    np.testing.assert_array_equal(fused, native.quantize_u8(
        native.normalize_nchw(img, MEAN, STD), 0.025, 127))
    np.testing.assert_array_equal(
        fused, jnative.preprocess_quantize(img, MEAN, STD, 0.025, 127))
    assert np.abs(fused.astype(int) - native.preprocess_quantize_plain(
        img, MEAN, STD, 0.025, 127).astype(int)).max() <= 1


def test_plain_twins_match_native():
    """``test_hostops.py``'s fallback contract, here the numpy twins."""
    img = _imgs(6, (2, 9, 9, 3))
    x = _floats(7, (4, 7)) * 5
    qv = _imgs(8, (33,))
    np.testing.assert_array_equal(native.quantize_u8_plain(x, 0.025, 127),
                                  native.quantize_u8(x, 0.025, 127))
    np.testing.assert_allclose(native.dequantize_u8_plain(qv, 0.1, 90),
                               native.dequantize_u8(qv, 0.1, 90), rtol=1e-6)
    assert np.abs(native.resize_bilinear_plain(img, 18, 18).astype(int)
                  - native.resize_bilinear(img, 18, 18).astype(int)
                  ).max() <= 1


@pytest.mark.parametrize("shape,k,s,p", [
    ((4, 3, 32, 32), 11, 4, 2),     # AlexNet conv1 at a reduced size
    ((2, 3, 17, 17), 5, 3, 0),      # hp past the padded extent
    ((2, 4, 16, 16), 5, 2, 2), ((2, 3, 17, 17), 5, 2, 2)])
def test_s2d_quantized_matches_plain_and_jax(shape, k, s, p):
    q = np.random.default_rng(9).integers(0, 256, shape, dtype=np.uint8)
    got = native.s2d_quantized(q, k, s, p, 127)
    assert got.shape == native.s2d_shape(shape, k, s, p)
    np.testing.assert_array_equal(got, native.s2d_quantized_plain(
        q, k, s, p, 127))
    np.testing.assert_array_equal(got, jnative.s2d_quantized(q, k, s, p, 127))


# -- the DataLoader -----------------------------------------------------------

def _batches(loader):
    return [b.numpy() if not isinstance(b, tuple) else b for b in loader]


def test_float_batches_and_lengths_match_jax():
    x = _floats(10, (25, 1, 4, 4))
    for drop in (False, True):
        dl = DataLoader(x, batch_size=8, drop_remainder=drop, device="cpu")
        jdl = JDataLoader(x, batch_size=8, drop_remainder=drop)
        got, want = _batches(dl), _batches(jdl)
        assert len(dl) == len(jdl) == len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_u8_modes_match_jax():
    img = _imgs(11, (7, 8, 8, 3))
    kw = dict(mean=MEAN, std=STD, device="cpu")
    for extra in ({}, dict(resize_to=(16, 16)), dict(quantize_to=(0.025, 127)),
                  dict(resize_to=(16, 16), quantize_to=(0.025, 127))):
        got = list(DataLoader(img, batch_size=3, **kw, **extra))
        want = list(JDataLoader(img, batch_size=3, mean=MEAN, std=STD,
                                **extra))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.quantized == w.quantized and g.shape == w.shape
            assert (g.scale, g.zero_point) == (w.scale, w.zero_point)
            np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))


def test_labels_pairing_matches_jax():
    x = _floats(12, (10, 1, 4, 4))
    y = np.arange(10)
    got = list(DataLoader(x, batch_size=4, labels=y, device="cpu"))
    want = list(JDataLoader(x, batch_size=4, labels=y))
    assert [p[1].tolist() for p in got] == [p[1].tolist() for p in want] \
        == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]


def test_argument_errors_match_jax():
    img = np.zeros((2, 4, 4, 1), np.uint8)
    x = np.zeros((4, 1, 8, 8), np.float32)
    for args, kw, match in ((img, {}, "mean/std"),
                            (x, dict(resize_to=(16, 16)), "resize_to"),
                            (x, dict(layout_for=object()), "quantize_to")):
        with pytest.raises(ValueError, match=match):
            JDataLoader(args, batch_size=2, **kw)
        with pytest.raises(ValueError, match=match):
            DataLoader(args, batch_size=2, device="cpu", **kw)


def test_producer_error_propagates():
    class Bad:
        shape = (8, 1, 4, 4)
        dtype = np.float32

        def __getitem__(self, s):
            raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        list(DataLoader(Bad(), batch_size=4, device="cpu"))


def test_abandoned_iteration_does_not_leak_producer():
    before = threading.active_count()
    x = _floats(13, (64, 1, 4, 4))
    for _ in range(5):
        it = iter(DataLoader(x, batch_size=4, prefetch=1, device="cpu"))
        next(it)
        it.close()
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before + 1


def test_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal without a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DataLoader(np.zeros((2, 1, 4, 4), np.float32), batch_size=2)


# -- the converted models -------------------------------------------------------

class _Strided(qt.Module):
    """First conv qualifies for host space-to-depth (5 x 5 / 2, 3 channels,
    17 x 17: test_serve.py's geometry)."""

    def __init__(self, config=qt.DEFAULT_CONFIG):
        super().__init__(config, device="cpu")
        self.conv1 = qt.Conv2d(3, 16, 5, stride=2, padding=2, config=config,
                               device="cpu")
        self.fc = qt.Linear(16 * 9 * 9, 10, config=config, device="cpu")

    def forward(self, x):
        x = qt.relu(self.conv1(x))
        return self.fc(x.reshape(-1, 16 * 9 * 9))


class _JStrided(qj.Module):
    def __init__(self, config=qj.DEFAULT_CONFIG):
        super().__init__(config)
        self.conv1 = qj.Conv2d(3, 16, 5, stride=2, padding=2, config=config)
        self.fc = qj.Linear(16 * 9 * 9, 10, config=config)

    def forward(self, x):
        x = qj.relu(self.conv1(x))
        return self.fc(x.reshape(-1, 16 * 9 * 9))


def _converted(config=qt.DEFAULT_CONFIG):
    m = _Strided(config)
    rng = np.random.default_rng(3)
    m.conv1.load_weight(rng.normal(0, 0.2, (16, 3, 5, 5)).astype(np.float32))
    m.conv1.load_bias(rng.normal(0, 0.1, (16,)).astype(np.float32))
    m.fc.load_weight(rng.normal(0, 0.05, (10, 1296)).astype(np.float32))
    m.fc.load_bias(rng.normal(0, 0.05, (10,)).astype(np.float32))
    m.prepare()
    m(qt.tensor(_floats(14, (8, 3, 17, 17)), device="cpu"))
    m.convert()
    return m


@pytest.fixture(scope="module")
def strided():
    """The port's converted tiny CNN and the JAX model holding its state."""
    m = _converted()
    jm = _JStrided()
    install_jax_state(jm, export_state(m))
    return m, jm


@pytest.fixture(scope="module")
def lenet():
    m = tzoo.build("lenet", device="cpu")
    m.load(tzoo.torch_twin("lenet").state_dict())
    m.prepare()
    m(qt.tensor(_floats(15, (8, 1, 28, 28)), device="cpu"))
    m.convert()
    return m


@pytest.mark.parametrize("backend,strided_tag", [
    ("auto", ("s2d", 5, 2, 2, 3)), ("xla_conv", ("s2d", 5, 2, 2, 3)),
    ("gemm", None)])
def test_ingest_descriptor_matches_jax(backend, strided_tag):
    tm = _Strided(qt.QuantConfig(conv_backend=backend))
    jm = _JStrided(qj.QuantConfig(conv_backend=backend))
    assert tm.ingest_descriptor() == jm.ingest_descriptor() == strided_tag
    assert tm.conv1._conv_backend() == jm.conv1._conv_backend()
    cfg = qt.QuantConfig(conv_backend=backend)
    assert tzoo.build("lenet", config=cfg, device="cpu").ingest_descriptor() \
        is None
    assert tzoo.AlexNet(config=cfg, device="cpu").ingest_descriptor() == (
        None if backend == "gemm" else ("s2d", 11, 4, 2, 3))


def test_prelayout_forward_equals_jax_and_plain(strided):
    m, jm = strided
    x = _floats(16, (8, 3, 17, 17))
    s, zp = m.config.input_scale, m.config.input_zero_point
    (plain,) = list(DataLoader(x, batch_size=8, quantize_to=(s, zp),
                               device="cpu"))
    (batch,) = list(DataLoader(x, batch_size=8, quantize_to=(s, zp),
                               layout_for=m, device="cpu"))
    assert batch._ingest == ("s2d", 5, 2, 2, 3)
    assert tuple(batch.data.shape) == (8, 11, 11, 12)
    got = m(batch).numpy()
    np.testing.assert_array_equal(got, m(plain).numpy())
    np.testing.assert_array_equal(got, m(qt.tensor(x, device="cpu")).numpy())
    (jbatch,) = list(JDataLoader(x, batch_size=8, quantize_to=(s, zp),
                                 layout_for=jm))
    np.testing.assert_array_equal(batch.data.numpy(), np.asarray(jbatch.data))
    np.testing.assert_array_equal(got, jm(jbatch).numpy())


def test_prelayout_u8_image_pipeline(strided):
    m, _ = strided
    img = _imgs(17, (8, 17, 17, 3))
    q = (m.config.input_scale, m.config.input_zero_point)
    (plain,) = list(DataLoader(img, batch_size=8, mean=MEAN, std=STD,
                               quantize_to=q, device="cpu"))
    (batch,) = list(DataLoader(img, batch_size=8, mean=MEAN, std=STD,
                               quantize_to=q, layout_for=m, device="cpu"))
    np.testing.assert_array_equal(m(batch).numpy(), m(plain).numpy())


def test_prelayout_mismatch_and_guards_raise(strided, lenet):
    from int8inferenceengine_tpu_torch.ops import functional as F
    m, _ = strided
    q = (m.config.input_scale, m.config.input_zero_point)
    (batch,) = list(DataLoader(_floats(18, (4, 3, 17, 17)), batch_size=4,
                               quantize_to=q, layout_for=m, device="cpu"))
    with pytest.raises(ValueError, match="does not match"):
        lenet.conv1(batch)
    assert "pre-layout" in repr(batch)
    for op in (lambda: F.relu(batch), lambda: F.max_pool2d(batch, 2, 2),
               lambda: F.dequantize(batch), lambda: batch.reshape(-1, 4),
               lambda: batch.numpy()):
        with pytest.raises(ValueError, match="pre-layout"):
            op()


def test_layout_for_is_a_noop_on_a_stride1_model(lenet):
    x = _floats(19, (8, 1, 28, 28))
    q = (lenet.config.input_scale, lenet.config.input_zero_point)
    (batch,) = list(DataLoader(x, batch_size=8, quantize_to=q,
                               layout_for=lenet, device="cpu"))
    assert batch._ingest is None and batch.quantized
    np.testing.assert_array_equal(lenet(batch).numpy(),
                                  lenet(qt.tensor(x, device="cpu")).numpy())


def test_loader_drives_the_model_loop(lenet):
    """The reference notebook loop: loader -> model -> argmax."""
    x = _floats(20, (20, 1, 28, 28))
    want = lenet(qt.tensor(x, device="cpu")).numpy()
    got = np.concatenate([lenet(b).numpy() for b, _ in DataLoader(
        x, batch_size=8, labels=np.arange(20), device="cpu")])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("which", ["lenet", "strided"])
def test_quantized_ingest_engine_equals_model(which, lenet, strided):
    model = lenet if which == "lenet" else strided[0]
    shape = (8, 1, 28, 28) if which == "lenet" else (8, 3, 17, 17)
    x = _floats(21, shape)
    engine = InferenceEngine(model, max_batch=8, quantize_ingest=True)
    try:
        got = [engine.submit(x[:3]), engine.submit(x[3:])]
        got = np.concatenate([f.result(timeout=WAIT) for f in got])
    finally:
        engine.shutdown()
    np.testing.assert_array_equal(got, model(qt.tensor(x, device="cpu"))
                                  .numpy())


def test_quantized_ingest_requires_a_converted_model():
    with pytest.raises(ValueError, match="converted"):
        InferenceEngine(tzoo.build("lenet", device="cpu"),
                        quantize_ingest=True)
