"""Sharded inference on a mesh of ranks (DP x TP): the counterpart of the
JAX package's ``examples/multichip_tp.py``.

LeNet is calibrated and converted on every rank (the same seeds give the
same model), then sharded over a (data, model) mesh with ring overlap
where its Linears chain; the sharded forward must equal the unsharded one
bit for bit.  Under ``torchrun`` each process is one rank; started alone,
the script spawns its own world of ``RANKS`` (4) ranks.  On the card the
ranks take ``cuda:{local rank % cards}``: with a card each, the backend
is NCCL; where they share one, gloo (``parallel.backend_for``).

    torchrun --nproc-per-node 4 -m \\
        int8inferenceengine_tpu_torch.examples.multichip_tp
    python -m int8inferenceengine_tpu_torch.examples.multichip_tp \\
        [--device cpu]
"""

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

import int8inferenceengine_tpu_torch as q
from int8inferenceengine_tpu_torch import models
from int8inferenceengine_tpu_torch.examples import add_device_arg, device_of
from int8inferenceengine_tpu_torch.parallel import (initialize_distributed,
                                                    make_mesh)
from int8inferenceengine_tpu_torch.parallel.launch import run_world

# the world the script spawns when started alone, and the seconds it may
# take (each collective gives up after them too)
RANKS = 4
WORLD_S = 600.0


def run(device: str) -> dict:
    """One rank's part: returns its checks."""
    dev = device_of(device)
    n = dist.get_world_size()
    lead = dist.get_rank() == 0
    if lead:
        print(f"devices: {n} x {dev.type}")
    net = models.build("lenet", device=dev)
    net.load(models.torch_twin("lenet").state_dict())
    net.prepare()
    net(q.tensor(np.random.default_rng(0).uniform(
        -1, 1, (32, 1, 28, 28)).astype(np.float32), device=dev))
    net.convert()

    x = np.random.default_rng(1).uniform(
        -1, 1, (32, 1, 28, 28)).astype(np.float32)
    base = net(q.tensor(x, device=dev)).numpy()

    model_par = 2 if n % 2 == 0 and n >= 4 else 1
    mesh = make_mesh((n // model_par, model_par),
                     devices="cpu" if dev.type == "cpu" else None)
    if lead:
        print(f"mesh: {mesh.shape}")
    net.shard(mesh, overlap=True)   # ring TP where Linears chain

    out = net(q.tensor(x, device=dev)).numpy()
    ok = bool(np.array_equal(out, base))
    if lead:
        print(f"sharded (ring overlap) == unsharded: {'OK' if ok else 'FAIL'}")
    return {"devices": n, "mesh": dict(mesh.shape),
            "sharded_equals_unsharded": ok}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:   # torchrun
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                                  % torch.cuda.device_count())
        initialize_distributed(device=dev.type)
        try:
            return run(args.device)
        finally:
            dist.destroy_process_group()
    checks = run_world(run, RANKS, args=(args.device,), device=dev.type,
                       timeout_s=WORLD_S)
    return dict(checks[0], sharded_equals_unsharded=all(
        c["sharded_equals_unsharded"] for c in checks))


if __name__ == "__main__":
    raise SystemExit(0 if main()["sharded_equals_unsharded"] else 1)
