"""Utilities (counterpart of ``int8inferenceengine_tpu.utils``): the
artifact, observability, and the data-driven accuracy levers.

* ``checkpoint``: ``save`` / ``load`` a model, the quantized artifact
  included, in the JAX package's file format; ``state_dict``,
  ``read_state_dict``;
* ``observe``: ``quantization_report``, ``log_quantization_report``,
  ``trace`` (``torch.profiler``) and ``device_op_times``;
* ``roofline``: per-layer operations and bytes, the share of the card's
  peak; ``validate``: the artifact's invariants and a forward probe;
* ``hf``: Hugging Face checkpoints: ``from_hf`` (the name adapter that
  ``Module.load`` applies), ``from_hf_config``, ``build_from_hf`` and
  ``load_pretrained`` (a checkpoint directory in one call).

The levers are host algorithms over a model's float
weights and tapped calibration activations (``layers._INPUT_TAP``), run
with stock torch ops on the model's device before ``convert()``.

* ``cross_layer_equalize``: rescales producer/consumer channel pairs
  (data-free);
* ``smooth`` with ``transformer_smooth_pairs``: SmoothQuant's migration of
  activation outliers into the weights;
* ``adaround``: learned per-weight rounding;
* ``gptq``: Hessian-aware error-compensated rounding.

The last two stash integer codes on each layer (``_adaround_qw``, and
``_adaround_scales`` for 4-bit Linears) that ``convert()`` takes in place
of rounding, in every weight mode.
"""

from . import checkpoint, hf, observe, roofline, validate
from .adaround import adaround
from .checkpoint import load, read_state_dict, save, state_dict
from .equalize import cross_layer_equalize
from .gptq import gptq
from .hf import from_hf
from .observe import log_quantization_report, quantization_report, trace
from .smooth import smooth, transformer_smooth_pairs

__all__ = ["checkpoint", "observe", "roofline", "validate", "hf", "from_hf",
           "save", "load", "state_dict", "read_state_dict",
           "quantization_report", "log_quantization_report", "trace",
           "cross_layer_equalize", "smooth", "transformer_smooth_pairs",
           "adaround", "gptq"]
