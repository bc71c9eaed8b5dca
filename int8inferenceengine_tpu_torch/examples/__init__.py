"""The examples on the port: the JAX package's ``examples/`` scripts as
modules of ``int8inferenceengine_tpu_torch``.

Each runs as ``python -m int8inferenceengine_tpu_torch.examples.<name>``
and prints the JAX script's checks line for line (times apart); its
``main(argv=None)`` returns those checks as a dict, so a harness can call
it in-process.  ``--device`` picks where the models run: the CUDA card by
default (no fallback: without a card ``main()`` raises), ``cpu`` when asked
for by name.

* ``text_generation``: gpt_tiny PTQ, ``generate()`` and
  ``GenerationEngine``;
* ``alexnet_cifar10``: the reference notebook's AlexNet-224 workflow, the
  u8 host ingest, the per-layer report, ``--model`` over the zoo,
  ``--data``/``--weights`` for real CIFAR-10;
* ``serve_resnet18``: calibrate and save once, load and serve from 4
  client threads through ``InferenceEngine(quantize_ingest=True)``;
* ``llm_serving``: the llama serving tour (smoothing, speculative
  decoding, HF names, the engine, W4A8, the artifact, the MoE);
* ``accuracy_synthetic``: labelled accuracy of a trained LeNet or 8-layer
  convnet under every INT8 lever;
* ``accuracy_lm``: perplexity of a trained llama or gemma twin on an
  order-2 Markov language against its entropy floor.

``notebooks/`` holds the port's copies of the reference notebooks.
"""

import argparse

import torch


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="where the models run: 'cuda' (the default; raises "
                         "without a card) or 'cpu'")


def device_of(name: str) -> torch.device:
    """The device that ``--device`` names; 'cuda' without a card raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run on the CPU")
    return dev
