"""A world of ranks in one call: ``run_world`` spawns one process per
rank, initialises ``torch.distributed`` in each (``mesh.initialize_
distributed``), runs the same function in every rank and returns each
rank's result.

The JAX package's single controller needs no launcher; the port's ranks
are processes, so a script that is not started by ``torchrun`` (the
examples run alone, ``chip_smoke.py``, the CPU tests) starts its own world
here.  Ranks start with the ``spawn`` method (a fork after CUDA is
initialised fails).  A rank that raises, dies or outlives ``timeout_s``
fails the call: the parent stops every rank and raises, so no caller
carries on after a lost rank.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback


def _rank_main(rank: int, world: int, store: str, device: str,
               collective_timeout_s: float, call: str, out):
    try:
        with open(call, "rb") as f:
            fn, args = pickle.load(f)
        import torch
        # ranks share the host's cores: one torch thread each
        torch.set_num_threads(1)
        # a world of its own on this node, whatever launched the parent
        os.environ["LOCAL_RANK"] = str(rank)
        os.environ["LOCAL_WORLD_SIZE"] = str(world)
        if device != "cpu":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        from .mesh import initialize_distributed
        initialize_distributed(f"file://{store}", world, rank, device=device,
                               timeout_s=collective_timeout_s)
        result = fn(*args)
        out.put((rank, True, result))
    except BaseException:               # reported to the parent, re-raised
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(fn, world_size: int, args=(), device: str = "cuda",
              timeout_s: float = 600.0, store_dir: str | None = None
              ) -> list:
    """``fn(*args)`` in each of ``world_size`` spawned ranks on ``device``
    ("cuda": every rank on the node's cards, ``cuda:{rank % cards}``; or
    "cpu"); returns the ranks' results in rank order.  ``fn`` and
    ``args`` are pickled (``fn`` by its import path) into the store
    directory once, and each rank loads them.  The ranks meet
    through a file store in ``store_dir`` (a fresh temporary directory by
    default); each collective gives up after ``timeout_s``, and the whole
    world must finish within it, or every rank is killed and this
    raises ``RuntimeError``.  On the card the kernels are built here
    first (``kernels.build_all``)."""
    if device != "cpu":
        # every kernel built here, once, before any rank starts: the ranks
        # then load the libraries and never run nvcc at the same time
        from ..kernels import build_all
        build_all()
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    own_dir = store_dir is None
    store_dir = tempfile.mkdtemp(prefix="i8ie_world_") if own_dir \
        else store_dir
    store = os.path.join(store_dir, f"store_{os.getpid()}_{time.time_ns()}")
    # the call pickled once, for every rank to load: passed to each
    # process, a large argument would hold each rank's start until the
    # one before it had read it
    call = store + ".call"
    with open(call, "wb") as f:
        pickle.dump((fn, args), f)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, store, device, timeout_s, call,
                               out))
             for r in range(world_size)]
    results, errors = {}, []
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(results) < world_size and not errors:
            left = deadline - time.monotonic()
            if left <= 0:
                errors.append(f"the world did not finish in {timeout_s} s")
                break
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    errors.append(f"ranks {dead} exited with codes "
                                  f"{[procs[r].exitcode for r in dead]}")
                continue
            if ok:
                results[rank] = value
            else:
                errors.append(f"rank {rank} failed:\n{value}")
        for p in procs:
            p.join(timeout=5 if not errors else 0.5)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        if own_dir:
            shutil.rmtree(store_dir, ignore_errors=True)
        else:
            os.remove(call)
    if errors:
        raise RuntimeError("; ".join(errors))
    return [results[r] for r in range(world_size)]
