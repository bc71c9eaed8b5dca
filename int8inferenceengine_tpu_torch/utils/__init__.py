"""The data-driven accuracy levers (counterpart of the levers of
``int8inferenceengine_tpu.utils``): host algorithms over a model's float
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

from .adaround import adaround
from .equalize import cross_layer_equalize
from .gptq import gptq
from .smooth import smooth, transformer_smooth_pairs

__all__ = ["cross_layer_equalize", "smooth", "transformer_smooth_pairs",
           "adaround", "gptq"]
