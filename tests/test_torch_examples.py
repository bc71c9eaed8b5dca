"""PyTorch port vs JAX package: the examples.

* The port's package surface: every name of the JAX package's top-level
  ``__all__`` and of its ``models.__all__`` exists in the port.
* ``examples/accuracy_lm.py``: the JAX ``main`` on a tiny argv (vocab 16,
  dim 32, depth 2, seq 32, 40 steps; the legs engine FP32, INT8 nearest,
  INT8 trunc and W4 weight-only) and the port's ``main`` on the same argv
  with every leg train the same twin on the CPU (equal torch perplexity
  and accuracy); engine FP32 within 1e-5 relative, each of the JAX legs'
  perplexity within 0.2% and accuracy within 0.005 (the two packages' own
  calibrations land a few float32 ULPs apart; measured at most 2.7e-6
  relative and 0.0005).  The port's other legs (smooth, per-channel, W4
  + GPTQ, W4A8 g128 and g256; each held against the JAX package in its
  own test file) stay inside ``tests/test_accuracy_lm.py``'s ratios to
  the twin's perplexity.
* ``examples/accuracy_synthetic.py``: the port's ``train_torch_lenet`` and
  ``train_torch`` give the JAX helpers' nets bit for bit.  One LeNet
  trained as ``tests/test_accuracy_synthetic.py`` trains it (4,000
  images, 3 epochs); both packages' ``accuracy_report`` on it over 400
  test images (engine_int8, engine_int8_per_channel, engine_int8_nearest,
  engine_int8_cle) give the same accuracies, to within one image
  (measured: equal).  The port's ``main`` on the CPU returns its drops,
  and ``--save-net`` writes the net it trained.
* ``examples/alexnet_cifar10.py``: ``load_cifar10`` equals the JAX one on a
  generated 8-image set (u8 and float .npz, a ``cifar-10-batches-py``
  directory); the port's ``main`` at 4 images agrees with its own oracle
  and its u8-ingest leg gives the float-input leg's codes.
* ``text_generation``, ``llm_serving`` and ``serve_resnet18``: the port's
  ``main`` on the CPU passes its own checks (each runs in seconds here).
* The port's notebooks: every code cell compiles and imports the port,
  never ``jax`` or the JAX package.
"""

import ast
import json
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import int8inferenceengine_tpu as qj
from int8inferenceengine_tpu import models as jmodels
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch import models as tmodels
from int8inferenceengine_tpu_torch.examples import (accuracy_lm,
                                                    accuracy_synthetic,
                                                    alexnet_cifar10,
                                                    llm_serving,
                                                    serve_resnet18,
                                                    text_generation)
from test_torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from examples import accuracy_lm as jax_lm  # noqa: E402
from examples import accuracy_synthetic as jax_syn  # noqa: E402
from examples import alexnet_cifar10 as jax_alex  # noqa: E402

CPU = ["--device", "cpu"]
NOTEBOOKS = ("AlexNet_cifar10_resize224", "Fully_Connected_mnist",
             "Simple_Convolution_cifar10", "Text_Generation")


def test_public_surface():
    missing = [n for n in qj.__all__ if not hasattr(qt, n)]
    missing += [f"models.{n}" for n in jmodels.__all__
                if not hasattr(tmodels, n)]
    assert not missing, missing
    assert tmodels.__all__ == jmodels.__all__
    assert qt.__version__ == qj.__version__
    assert qt.QuantMoE.__module__ == "int8inferenceengine_tpu_torch.layers"
    assert type(tmodels.build("alexnet", device="cpu")).__name__ == "AlexNet"


# -- accuracy_lm --------------------------------------------------------------

LM_ARGV = ["--vocab", "16", "--dim", "32", "--depth", "2", "--heads", "4",
           "--kv-heads", "2", "--seq", "32", "--steps", "40"]
JAX_LM_LEGS = ("INT8 trunc (default)", "INT8 nearest", "W4 weight-only")
# the port's other legs and their bound on the ratio to the twin's ppl
# (tests/test_accuracy_lm.py: INT8 nearest < 1.10x, W4 < 1.5x)
PORT_LM_LEGS = {"INT8 nearest + smooth": 1.10,
                "INT8 nearest + per-channel": 1.10, "W4 + GPTQ": 1.5,
                "W4A8 static (g=128)": 1.5, "W4A8 static (g=256)": 1.5}


@pytest.fixture(scope="module")
def lm_pair():
    port = accuracy_lm.main(LM_ARGV + CPU)
    floor, torch_fp32, results = jax_lm.main(
        LM_ARGV + ["--legs", ",".join(("engine FP32",) + JAX_LM_LEGS)])
    return port, dict(floor=floor, torch=torch_fp32, results=results)


def test_lm_same_training(lm_pair):
    port, ref = lm_pair
    assert port["floor"] == ref["floor"]
    assert port["torch"] == ref["torch"]
    assert sorted(ref["results"]) == sorted(("engine FP32",) + JAX_LM_LEGS)
    assert sorted(port["results"]) == sorted(
        ("engine FP32",) + JAX_LM_LEGS + tuple(PORT_LM_LEGS))


def test_lm_engine_fp32(lm_pair):
    port, ref = lm_pair
    ppl, acc = port["results"]["engine FP32"]
    want_ppl, want_acc = ref["results"]["engine FP32"]
    assert abs(ppl / want_ppl - 1) <= 1e-5, (ppl, want_ppl)
    assert acc == want_acc


@pytest.mark.parametrize("leg", JAX_LM_LEGS)
def test_lm_leg(lm_pair, leg):
    port, ref = lm_pair
    ppl, acc = port["results"][leg]
    want_ppl, want_acc = ref["results"][leg]
    assert np.isfinite(ppl)
    assert abs(ppl / want_ppl - 1) <= 2e-3, (leg, ppl, want_ppl)
    assert abs(acc - want_acc) <= 5e-3, (leg, acc, want_acc)


@pytest.mark.parametrize("leg", sorted(PORT_LM_LEGS))
def test_lm_port_leg(lm_pair, leg):
    port, _ = lm_pair
    ppl, acc = port["results"][leg]
    t_ppl = port["torch"][0]
    assert np.isfinite(ppl) and ppl < PORT_LM_LEGS[leg] * t_ppl, (leg, ppl)
    assert 0.0 <= acc <= 1.0


# -- accuracy_synthetic ---------------------------------------------------------

SYN_TAGS = ("engine_int8", "engine_int8_per_channel", "engine_int8_nearest",
            "engine_int8_cle")
SYN_TEST = 400


@pytest.fixture(scope="module")
def syn_pair():
    rng = np.random.default_rng(0)
    x_train, y_train = accuracy_synthetic.make_shapes(4000, rng)
    x_test, y_test = accuracy_synthetic.make_shapes(SYN_TEST, rng)
    net = accuracy_synthetic.train_torch_lenet(x_train, y_train, epochs=3,
                                               log=lambda *a: None)
    calib = x_train[:100]
    port = accuracy_synthetic.accuracy_report(net, x_test, y_test, calib,
                                              tags=SYN_TAGS)
    ref = jax_syn.accuracy_report(net, x_test, y_test, calib, tags=SYN_TAGS)
    return port, ref


@pytest.mark.parametrize("train", ["lenet", "deep8"])
def test_synthetic_recipe_is_the_jax_one(train):
    """The port's training helpers give the JAX helpers' nets bit for bit
    (same initial weights, same batch order) on the CPU."""
    size = 32 if train == "deep8" else 28
    x, y = accuracy_synthetic.make_shapes(
        128 if train == "deep8" else 600, np.random.default_rng(2), size)
    quiet = dict(epochs=2, log=lambda *a: None)
    torch.manual_seed(123)       # the global RNG's state before does not matter
    if train == "lenet":
        got = accuracy_synthetic.train_torch_lenet(x, y, **quiet)
        want = jax_syn.train_torch_lenet(x, y, **quiet)
    else:
        got = accuracy_synthetic.train_torch(accuracy_synthetic.torch_deep8(1),
                                             x, y, seed=1, **quiet)
        want = jax_syn.train_torch(jax_syn.torch_deep8(1), x, y, seed=1,
                                   **quiet)
    assert all(torch.equal(a, b) for a, b in zip(
        got.state_dict().values(), want.state_dict().values()))


def test_make_shapes_is_the_jax_task():
    a = accuracy_synthetic.make_shapes(64, np.random.default_rng(3), size=32)
    b = jax_syn.make_shapes(64, np.random.default_rng(3), size=32)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


@pytest.mark.parametrize("tag", ("torch_fp32", "engine_fp32") + SYN_TAGS)
def test_synthetic_accuracy(syn_pair, tag):
    port, ref = syn_pair
    assert sorted(port) == sorted(ref)
    assert ref["torch_fp32"] > 0.8, ref       # the task is learnable
    assert abs(port[tag] - ref[tag]) <= 1 / SYN_TEST, (tag, port, ref)


def test_synthetic_main_saves_its_net(tmp_path, monkeypatch):
    """``main`` on the CPU (one INT8 leg, to keep it short) returns its
    accuracies and drops and, with ``--save-net``, writes the twin it
    trained: the recipe's net on the same images."""
    monkeypatch.setattr(accuracy_synthetic, "INT8_LEGS",
                        accuracy_synthetic.INT8_LEGS[:1])
    path = tmp_path / "lenet.pt"
    checks = accuracy_synthetic.main(
        ["--n-train", "300", "--n-test", "50", "--epochs", "1",
         "--save-net", str(path)] + CPU)
    accs = checks["accuracy"]
    assert sorted(accs) == ["engine_fp32", "engine_int8", "torch_fp32"]
    assert checks["drop_pts"]["engine_int8"] == pytest.approx(
        100 * (accs["torch_fp32"] - accs["engine_int8"]))
    rng = np.random.default_rng(0)
    x, y = accuracy_synthetic.make_shapes(300, rng)
    want = accuracy_synthetic.train_torch_lenet(x, y, epochs=1,
                                                log=lambda *a: None)
    saved = torch.load(path)
    assert all(torch.equal(saved[k], v)
               for k, v in want.state_dict().items())


def test_deep8_twins_match():
    x = np.random.default_rng(1).standard_normal((2, 1, 32, 32)).astype(
        np.float32)
    net = accuracy_synthetic.torch_deep8(0)
    assert all(torch.equal(a, b) for a, b in zip(
        net.state_dict().values(), jax_syn.torch_deep8(0).state_dict()
        .values()))
    mm = accuracy_synthetic.build_deep8(device="cpu")
    mm.load(net.state_dict())
    with torch.no_grad():
        want = net(torch.tensor(x)).numpy()
    np.testing.assert_allclose(mm(qt.tensor(x, device="cpu")).numpy(), want,
                               rtol=1e-5, atol=1e-6)


# -- alexnet_cifar10 ------------------------------------------------------------

@pytest.mark.parametrize("form", ["npz_u8", "npz_f32", "batches_dir"])
def test_load_cifar10_equals_jax(tmp_path, form):
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (8, 3, 32, 32), dtype=np.uint8)
    labels = rng.integers(0, 10, 8)
    if form == "batches_dir":
        path = tmp_path / "cifar-10-batches-py"
        path.mkdir()
        with open(path / "test_batch", "wb") as f:
            pickle.dump({b"data": images.reshape(8, -1),
                         b"labels": labels.tolist()}, f)
    else:
        path = tmp_path / "cifar.npz"
        np.savez(path, images=images if form == "npz_u8"
                 else images.astype(np.float32) / 255.0, labels=labels)
    got = alexnet_cifar10.load_cifar10(str(path), 6, 224)
    want = jax_alex.load_cifar10(str(path), 6, 224)
    assert got[0].shape == (6, 3, 224, 224) and got[0].dtype == np.float32
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


def test_alexnet_main():
    checks = alexnet_cifar10.main(["--images", "4", "--batch", "2"] + CPU)
    assert checks["images"] == 4 and checks["metric"] == "agreement"
    assert checks["engine FP32"]["agreement"] == 1.0, checks
    assert checks["engine INT8"]["agreement"] >= 0.5, checks
    assert checks["u8_ingest_codes_equal"], checks


# -- the serving examples -------------------------------------------------------

def test_text_generation_main():
    checks = text_generation.main(CPU)
    assert checks["fp32_max_abs_diff"] < 1e-4, checks
    assert checks["engine_equals_generate"], checks
    assert len(checks["engine"]) == 4


def test_llm_serving_main():
    checks = llm_serving.main(CPU)
    flags = {k: v for k, v in checks.items() if isinstance(v, bool)}
    assert len(flags) == 8 and all(flags.values()), checks
    assert checks["sharded_engine_equals_generate"], checks
    assert checks["fp32_max_abs_diff"] < 1e-4, checks


def test_serve_resnet18_main():
    checks = serve_resnet18.main(CPU)
    assert checks["requests"] == 16, checks
    assert checks["replies_equal_direct"], checks


# -- notebooks ------------------------------------------------------------------

@pytest.mark.parametrize("name", NOTEBOOKS)
def test_notebook_cells_compile_and_import_the_port(name):
    path = REPO / "int8inferenceengine_tpu_torch" / "examples" / \
        "notebooks" / f"{name}.ipynb"
    jax_nb = json.loads((REPO / "examples" / "notebooks" /
                         f"{name}.ipynb").read_text())
    cells = [c for c in json.loads(path.read_text())["cells"]
             if c["cell_type"] == "code"]
    assert len(cells) == len([c for c in jax_nb["cells"]
                              if c["cell_type"] == "code"])
    imported = set()
    for i, cell in enumerate(cells):
        src = "".join(cell["source"])
        tree = ast.parse(compile(src, f"{name}[{i}]", "exec",
                                 ast.PyCF_ONLY_AST))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                imported.update(a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                imported.add(node.module)
    roots = {m.split(".")[0] for m in imported}
    assert "int8inferenceengine_tpu_torch" in roots, imported
    assert not roots & {"jax", "jaxlib", "int8inferenceengine_tpu"}, imported
    assert 'DEVICE = "cuda"' in "".join(cells[0]["source"])
