"""The (data, model) mesh over ``torch.distributed`` (counterpart of
``int8inferenceengine_tpu.parallel.mesh``).

The JAX package runs one controller over a ``jax.sharding.Mesh`` of
devices.  The port runs one process (rank) per mesh position, all running
the same user code on the same full input: ``make_mesh`` lays the ranks of
the initialised default process group out row-major over the mesh shape
(rank = data index * model size + model index for a (data, model) mesh),
builds one process group per axis and line of the mesh, and keeps this
rank's coordinates, its groups and its device.

The backend follows one rule (``backend_for``): ``gloo`` on the CPU; on
the card ``nccl`` when every rank of the node has a card of its own, and
``gloo`` when ranks share one (NCCL refuses two ranks on one device).
gloo moves the collectives of CUDA tensors through host memory.

Beside the axis groups, every mesh holds ``control``: one world-wide gloo
group for host decisions (``parallel/lockstep.py``: the sharded engines'
control records), whatever backend the axes use, so that no control
message enters a CUDA stream.  Every group of a mesh gives up after the
``timeout_s`` that ``initialize_distributed`` was given, so a lost rank
fails every rank instead of leaving one waiting.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

# the collectives' time limit that initialize_distributed was given (None:
# torch.distributed's default), which make_mesh gives every group it makes
_timeout_s: float | None = None


def local_rank() -> int:
    """This process's rank on its node (``LOCAL_RANK``, as ``torchrun``
    sets it), else its global rank."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def backend_for(device, local_world_size: int) -> str:
    """``gloo`` on the CPU; on the card ``nccl`` when the node's
    ``local_world_size`` ranks each have a card of their own, else
    ``gloo``."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return ("nccl" if torch.cuda.device_count() >= local_world_size
            else "gloo")


def initialize_distributed(init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None, device=None,
                           timeout_s: float = 300.0) -> None:
    """Initialise the default process group, or do nothing when one is
    initialised.  ``init_method`` / ``world_size`` / ``rank`` default to
    ``torchrun``'s environment (``env://``); ``device`` (the card when
    None, or ``"cpu"``) picks the backend by ``backend_for``.  Every
    collective of the group fails after ``timeout_s`` seconds instead of
    waiting on a lost rank."""
    global _timeout_s
    if dist.is_initialized():
        return
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run the ranks on the CPU")
    backend = backend_for(dev, local_world)
    kwargs = {}
    if backend == "nccl":
        # NCCL binds each rank to its card up front (no guess from the
        # global rank, which is not the card's index beyond one node)
        card = int(os.environ.get("LOCAL_RANK", rank))
        kwargs["device_id"] = torch.device(
            "cuda", card % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    _timeout_s = float(timeout_s)


class Mesh:
    """This rank's view of a device mesh: ``shape`` (a dict by axis name,
    as ``mesh.shape[data_axis]`` reads it), ``axis_names``, ``coords``
    (this rank's index on each axis), ``groups`` (the process group of
    this rank's line along each axis; None on an axis of size 1),
    ``ranks`` (the global ranks laid out over the mesh), ``device``
    (this rank's device) and ``control`` (the world-wide gloo group of the
    host's decisions)."""

    def __init__(self, shape: dict, axis_names: tuple, coords: dict,
                 groups: dict, ranks: np.ndarray, device: torch.device,
                 control):
        self.shape = shape
        self.axis_names = axis_names
        self.coords = coords
        self.groups = groups
        self.ranks = ranks
        self.device = device
        self.control = control

    def __repr__(self):
        return (f"Mesh({self.shape}, rank {dist.get_rank()} at "
                f"{self.coords}, {self.device})")


def make_mesh(shape=None, axis_names=("data", "model"), devices=None
              ) -> Mesh:
    """Lay the default process group's ranks out over a (data, model)
    mesh.  ``shape=None`` puts every rank on the data axis — pure DP,
    always valid; ``(2, 2)`` is 2-way DP x 2-way TP.  ``devices`` is this
    rank's device: None for the card (``cuda:{local rank % cards}``), or
    a name such as ``"cpu"``.  Every rank must call it, with the same
    arguments, in the same order: it creates every group of the mesh."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh() needs torch.distributed initialised "
                           "(initialize_distributed(), or torchrun)")
    n = dist.get_world_size()
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not name {axis_names}")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "devices='cpu' to run on the CPU")
        device = torch.device("cuda", local_rank()
                              % torch.cuda.device_count())
    else:
        device = torch.device(devices)
    ranks = np.arange(n).reshape(shape)
    me = dist.get_rank()
    timeout = (None if _timeout_s is None
               else datetime.timedelta(seconds=_timeout_s))
    coords = dict(zip(axis_names,
                      (int(c) for c in np.unravel_index(me, shape))))
    groups = {}
    for ax, name in enumerate(axis_names):
        groups[name] = None
        if shape[ax] == 1:
            continue
        lines = np.moveaxis(ranks, ax, -1).reshape(-1, shape[ax])
        for line in lines:                 # every rank creates every group
            g = dist.new_group([int(r) for r in line], timeout=timeout)
            if me in line:
                groups[name] = g
    control = dist.new_group(list(range(n)), timeout=timeout,
                             backend="gloo")
    return Mesh(dict(zip(axis_names, shape)), tuple(axis_names), coords,
                groups, ranks, device, control)
