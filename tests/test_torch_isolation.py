"""The PyTorch port stands alone and fails loudly.

* Its package and ``chip_smoke.py`` import with ``jax`` and the JAX package
  blocked.
* Without CUDA, entry points that default to the card raise instead of
  running on the CPU, the examples' ``main()`` among them.
* Misuse raises: FP32 input to a converted layer, u8 input to an
  unconverted one, a wrongly shaped weight, a configuration value the port
  does not implement, an FP32 island of an unknown layer or of one that is
  not a Linear/Conv2d, the removed prefill attention kernel.
* Converting a model deeper than the advisory depth under 'trunc' rounding
  warns (``TruncDepthWarning``).
"""

import importlib
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch.models import zoo
from test_torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = ("text_generation", "alexnet_cifar10", "serve_resnet18",
            "llm_serving", "accuracy_synthetic", "accuracy_lm",
            "multichip_tp")

BLOCKED_IMPORT = r"""
import sys
for name in list(sys.modules):
    if name.split(".")[0] in ("jax", "jaxlib", "int8inferenceengine_tpu"):
        del sys.modules[name]

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "int8inferenceengine_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import pkgutil, importlib
import int8inferenceengine_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "int8inferenceengine_tpu")]
assert not leaked, leaked
print("OK", len(names), " ".join(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", BLOCKED_IMPORT], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("OK")
    assert int(out.stdout.split()[1]) >= 12      # every module was imported
    names = set(out.stdout.split()[2:])
    for mod in ("graphs", "serve", "serve.engine", "serve.generation",
                "models.resnet", "models.mobilenet", "models.mobilenet_v3",
                "models.efficientnet", "models.shufflenet",
                "models.squeezenet", "models.googlenet", "models.densenet",
                "models.gemma", "models.vit", "models.text_transformer",
                "utils", "utils.equalize", "utils.smooth", "utils.gptq",
                "utils.adaround", "utils.hf", "data", "native",
                "parallel", "parallel.context", "parallel.mesh",
                "parallel.sharding", "parallel.overlap", "parallel.launch",
                "parallel.lockstep",
                "examples") + tuple(f"examples.{name}" for name in EXAMPLES):
        assert f"int8inferenceengine_tpu_torch.{mod}" in names, mod


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_needs_a_card_by_default(monkeypatch, name):
    """Each example's ``main()`` runs on the card unless ``--device cpu``
    names the CPU: without a card it raises before it builds anything."""
    module = importlib.import_module(
        f"int8inferenceengine_tpu_torch.examples.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        module.main([])


def test_distributed_needs_a_card_by_default(monkeypatch):
    """``initialize_distributed`` and ``make_mesh`` put the ranks on the
    card unless the CPU is named: without a card they raise."""
    from int8inferenceengine_tpu_torch import parallel
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parallel.initialize_distributed("file:///nonexistent", 1, 0)
    with pytest.raises(RuntimeError, match="initialise"):
        parallel.make_mesh((1, 1))
    assert parallel.backend_for("cpu", 4) == "gloo"


def test_every_kernel_source_is_bound_and_stands_alone():
    """Each ``csrc/*.cu`` (G1's ``conv_grouped.cu`` among them) has its C
    entry points in ``kernels.SIGNATURES`` and names no JAX code."""
    from int8inferenceengine_tpu_torch import kernels
    sources = {p.stem: p for p in kernels.CSRC.glob("*.cu")}
    assert set(sources) == set(kernels.SIGNATURES)
    assert "conv_grouped_u8s8" in kernels.SIGNATURES["conv_grouped"]
    for name, path in sources.items():
        text = path.read_text()
        for fn in kernels.SIGNATURES[name]:
            assert f'extern "C" int {fn}(' in text, (name, fn)
        assert "#include <jax" not in text and "import jax" not in text


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zoo.AlexNet()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        qt.tensor(np.zeros((1, 3), np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        qt.Linear(3, 2)
    assert zoo.LeNet(device="cpu").device.type == "cpu"


def _converted_lenet():
    m = zoo.LeNet(device="cpu")
    m.load(zoo.torch_twin("lenet").state_dict())
    x = np.random.default_rng(0).standard_normal((2, 1, 28, 28)).astype(
        np.float32)
    m.prepare()
    m(qt.tensor(x, device="cpu"))
    m.convert()
    return m


def test_misuse_raises():
    m = _converted_lenet()
    with pytest.raises(RuntimeError, match="already converted"):
        m.fc1(qt.tensor(np.zeros((2, 800), np.float32), device="cpu"))
    with pytest.raises(RuntimeError, match="already converted"):
        m.conv1(qt.tensor(np.zeros((2, 1, 28, 28), np.float32), device="cpu"))
    fresh = qt.Linear(800, 500, device="cpu")
    with pytest.raises(RuntimeError, match="not converted"):
        fresh(qt.Tensor(torch.zeros((2, 800), dtype=torch.uint8)))
    with pytest.raises(ValueError, match="load_weight"):
        fresh.load_weight(np.zeros((500, 799), np.float32))
    with pytest.raises(ValueError, match="load_weight"):
        qt.Conv2d(1, 20, 5, device="cpu").load_weight(
            np.zeros((20, 1, 3, 3), np.float32))
    m2 = zoo.LeNet(device="cpu")
    m2.prepare()
    with pytest.raises(ValueError, match="float input while preparing"):
        m2(qt.Tensor(torch.zeros((1, 1, 28, 28), dtype=torch.uint8)))


def _converted_vit(cfg):
    m = zoo.build("vit_tiny", config=qt.QuantConfig(**cfg), device="cpu",
                  img_size=16, patch=8, dim=16, depth=1, heads=2)
    m.prepare()
    m(qt.tensor(np.zeros((1, 3, 16, 16), np.float32), device="cpu"))
    m.convert()
    return m


@pytest.mark.parametrize("case", ["unknown_skip", "softmax_skip",
                                  "pallas_attention"])
def test_still_refused(case):
    """What the port still refuses, as the JAX package does: an FP32 island
    of an unknown layer (``KeyError``) or of a layer that is not a
    Linear/Conv2d (``TypeError``), and ``fused_attention='pallas'`` (the
    prefill kernel was removed), at the call."""
    if case == "pallas_attention":
        m = _converted_vit(dict(fused_attention="pallas"))
        with pytest.raises(ValueError, match="Pallas kernel was removed"):
            m(qt.tensor(np.zeros((1, 3, 16, 16), np.float32), device="cpu"))
        return
    m = zoo.build("vit_tiny", device="cpu", img_size=16, patch=8, dim=16,
                  depth=1, heads=2)
    m.prepare()
    skip, error = {"unknown_skip": (("nope",), KeyError),
                   "softmax_skip": (("smax1",), TypeError)}[case]
    with pytest.raises(error, match="convert.skip"):
        m.convert(skip=skip)
    assert not m.is_quant


@pytest.mark.parametrize("rounding,warns", [("trunc", True),
                                            ("nearest", False)])
def test_deep_trunc_model_warns_on_convert(rounding, warns):
    cfg = qt.QuantConfig(rounding=rounding)
    depth = qt.Module.TRUNC_DEPTH_ADVISORY + 1

    class Deep(qt.Module):
        def __init__(self):
            super().__init__(cfg, device="cpu")
            for i in range(depth):
                setattr(self, f"fc{i}", qt.Linear(2, 2, config=cfg,
                                                  device="cpu"))

    m = Deep()
    assert len(list(m.named_layers())) == depth
    m.prepare()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        m.convert()
    got = any(issubclass(w.category, qt.TruncDepthWarning) for w in seen)
    assert got == warns


@pytest.mark.parametrize("field,value,error", [
    ("weight_bits", 2, NotImplementedError),
    ("glue_dtype", "float16", ValueError),
    ("epilogue_dtype", "float16", ValueError),
    ("fp_dtype", "float16", ValueError),
    ("conv_backend", "cudnn", ValueError),
])
def test_unimplemented_config_fields_raise(field, value, error):
    """A value the port does not take raises at construction: a
    ``weight_bits`` it does not implement ``NotImplementedError``, a dtype
    or backend neither package knows ``ValueError`` (the bfloat16 dtypes
    and 'xla_conv' are implemented: tests/test_torch_lifecycle_dtypes.py)."""
    cfg = qt.QuantConfig(**{field: value})
    with pytest.raises(error, match=field):
        zoo.FCMnist(config=cfg, device="cpu")
    with pytest.raises(error, match=field):
        qt.Linear(4, 2, config=cfg, device="cpu")


@pytest.mark.parametrize("cfg", [
    dict(weight_only=True), dict(weight_only=True, dynamic_act=True),
    dict(dynamic_act=True)])
def test_weight_modes_are_accepted(cfg):
    """W8-float and dynamic_act build (dynamic_act without weight_only is
    the static path, as in the JAX package)."""
    config = qt.QuantConfig(**cfg)
    zoo.FCMnist(config=config, device="cpu")
    qt.Linear(4, 2, config=config, device="cpu")
    qt.Conv2d(4, 2, 3, config=config, device="cpu")


@pytest.mark.parametrize("cfg", [
    dict(weight_bits=4), dict(weight_only=True, weight_bits=4),
    dict(weight_bits=4, w4_kernel="xla")])
def test_four_bit_configs_are_accepted(cfg):
    config = qt.QuantConfig(**cfg)
    zoo.FCMnist(config=config, device="cpu")
    qt.Linear(4, 2, config=config, device="cpu")
    bad = qt.QuantConfig(**dict(cfg, w4_kernel="cuda"))
    with pytest.raises(ValueError, match="w4_kernel"):
        qt.Linear(4, 2, config=bad, device="cpu")
