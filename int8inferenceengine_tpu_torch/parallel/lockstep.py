"""Lockstep control of the sharded engines: world rank 0 decides, every
rank follows (no counterpart file in the JAX package, whose one controller
sees global arrays and runs every device program under ``shard_map``).

Here every rank is a process with its own copy of an engine.  Requests
reach rank 0 only, and each rank must run the same device programs in the
same order, or the model group's collectives pair up wrongly.  So rank 0
broadcasts one control record before each step of its scheduler (the
admissions with their prompts and sampling settings, the freed slots, the
slots' act/rem vectors, the chunk variant and count, prefix registrations,
shutdown), and the other ranks apply each record as it comes.  The records
travel over the mesh's ``control`` group (gloo, host memory: they never
enter a CUDA stream or a graph) and give up after the mesh's time limit,
so a lost rank fails every rank.  While rank 0 idles it sends an empty
record every ``HEARTBEAT_S`` seconds, which keeps the others' waits
inside that limit.
"""

from __future__ import annotations

import time

import torch.distributed as dist

__all__ = ["Lockstep", "HEARTBEAT_S"]

# an idle leader's empty record: far inside any collective time limit
HEARTBEAT_S = 1.0


class Lockstep:
    """This rank's end of the control channel of ``mesh``: ``leader`` is
    True on world rank 0, which ``send``s; every other rank ``recv``s."""

    def __init__(self, mesh):
        self.group = mesh.control
        self.rank = dist.get_rank()
        self.leader = self.rank == 0
        self._sent = time.monotonic()

    def send(self, record: dict) -> None:
        """Rank 0: broadcast ``record`` (a picklable dict)."""
        dist.broadcast_object_list([record], src=0, group=self.group)
        self._sent = time.monotonic()

    def recv(self) -> dict:
        """Any other rank: the next record of rank 0 (raises when none
        comes within the group's time limit)."""
        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def idle(self) -> bool:
        """Rank 0: nothing was sent for ``HEARTBEAT_S`` seconds."""
        return time.monotonic() - self._sent >= HEARTBEAT_S

    def heartbeat(self) -> None:
        """Rank 0: an empty record when ``idle()``."""
        if self.idle():
            self.send({})

    def follower_error(self, what: str) -> RuntimeError:
        return RuntimeError(
            f"{what} on rank {self.rank}: a sharded engine takes requests on "
            f"world rank 0 only, and rank {self.rank} follows its decisions "
            f"(submit on rank 0, shutdown() on every rank)")
