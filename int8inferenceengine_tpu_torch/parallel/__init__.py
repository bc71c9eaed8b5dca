"""Parallelism over ``torch.distributed``: the (data, model) mesh, param
sharding, the sharded forward (counterpart of
``int8inferenceengine_tpu.parallel``).

* **DP** — the batch split over the ``data`` mesh axis;
* **TP** — conv/fc output-channel sharding over the ``model`` axis,
  activations all-gathered; the transformer roles (col_local / row) with
  exact int32 sums, including the head-sharded KV cache of a sharded
  ``generate()``; ring overlap (``overlap.py``);
* **EP** — expert parallelism for MoE models (role 'expert').

One process per mesh position; every rank runs the same user code on the
same full input (``Module.shard``, ``parallel/sharding.py``).  Under
``torchrun`` call ``initialize_distributed()``; a script started alone
runs ``launch.run_world`` (spawned ranks).  The backend rule is
``mesh.backend_for``: gloo on the CPU, NCCL on the card when every rank
has its own card, gloo when ranks share one.  PP and SP/CP are out of
scope, as in the JAX package.
"""

from .context import ParallelAxes, axes, current_axes
from .mesh import Mesh, backend_for, initialize_distributed, make_mesh
from .overlap import ring_linear_reference, ring_qgemm
from .sharding import (gather_channels, layer_param_specs,
                       module_param_specs, shard_module, sharded_forward)

__all__ = ["make_mesh", "initialize_distributed", "Mesh", "backend_for",
           "ParallelAxes", "axes", "current_axes", "layer_param_specs",
           "module_param_specs", "shard_module", "sharded_forward",
           "gather_channels", "ring_qgemm", "ring_linear_reference"]
