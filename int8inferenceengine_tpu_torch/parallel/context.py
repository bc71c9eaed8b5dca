"""The parallel context of this rank (counterpart of
``int8inferenceengine_tpu.parallel.context``).

Layers consult it while a sharded Module runs its forward: when a
tensor-parallel axis is active, a channel-sharded layer computes its local
output-channel slice and all-gathers the result over the ``model`` axis so
the next layer sees full channels, a row-parallel Linear sums its int32
partials over it, and the data axis splits the batch.  The JAX package
reads the same context while it traces under ``shard_map``; here every
rank is a process of its own, so the context also carries this rank's
coordinates on the mesh and its two process groups.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses


@dataclasses.dataclass(frozen=True)
class ParallelAxes:
    data_axis: str = "data"
    model_axis: str = "model"
    data_size: int = 1
    model_size: int = 1
    # When True, TP-sharded Linears keep their outputs channel-sharded and
    # consumers overlap the gather with compute (ring GEMM) instead of
    # all-gathering at every layer boundary.
    overlap: bool = False
    # this rank's coordinates on the two axes (JAX's lax.axis_index)
    data_index: int = 0
    model_index: int = 0
    # the torch.distributed groups of the ranks that share this rank's
    # model coordinate (its data group) and its data coordinate (its model
    # group); None on an axis of size 1
    data_group: object = None
    model_group: object = None


_current: contextvars.ContextVar[ParallelAxes | None] = contextvars.ContextVar(
    "i8ie_torch_parallel_axes", default=None)


def current_axes() -> ParallelAxes | None:
    return _current.get()


@contextlib.contextmanager
def axes(pa: ParallelAxes):
    token = _current.set(pa)
    try:
        yield
    finally:
        _current.reset(token)
