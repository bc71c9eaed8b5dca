"""Quantize-once, serve-forever: ResNet-18 + checkpoint + continuous batching.

The production deployment shape the reference can't do (it re-calibrates
every process and serves nothing): calibrate offline, persist the
quantized artifact, then serve concurrent variable-size requests through
the continuous-batching engine.  ``main()`` also holds every reply against
a direct forward of the loaded model on the same images.

Run:  python -m int8inferenceengine_tpu_torch.examples.serve_resnet18 \
          [--device cpu]
"""

import argparse
import functools
import os
import tempfile
import threading
import time

import numpy as np

import int8inferenceengine_tpu_torch as q
from int8inferenceengine_tpu_torch import QuantConfig, models, utils
from int8inferenceengine_tpu_torch.examples import add_device_arg, device_of
from int8inferenceengine_tpu_torch.serve import InferenceEngine

print = functools.partial(print, flush=True)

CFG = QuantConfig(weight_per_channel=True)


def quantize_offline(ckpt: str, dev) -> None:
    print("== offline: load -> calibrate -> convert -> save ==")
    tnet = models.torch_twin("resnet18")
    net = models.build("resnet18", config=CFG, device=dev)
    net.load(tnet.state_dict())
    net.prepare()
    net(q.tensor(np.random.default_rng(0).uniform(
        -1, 1, (32, 3, 64, 64)).astype(np.float32), device=dev))
    net.convert()
    utils.save(net, ckpt)
    print(f"   saved quantized artifact -> {ckpt}")


def serve(ckpt: str, dev) -> dict:
    print("== serving: load quantized artifact, no calibration ==")
    net = models.build("resnet18", config=CFG, device=dev)
    utils.load(net, ckpt)
    # quantize_ingest: batches are quantized (and first-conv space-to-depth
    # pre-laid-out) on the host — 1/4 host->device bytes per step.
    engine = InferenceEngine(net, max_batch=32, batch_timeout_s=0.005,
                             quantize_ingest=True)
    replies, errors = [], []

    def client(cid, n_requests=4):
        rng = np.random.default_rng(cid)
        try:
            for _ in range(n_requests):
                n = int(rng.integers(1, 9))
                x = rng.uniform(-1, 1, (n, 3, 64, 64)).astype(np.float32)
                out = engine.infer(x)
                if out.shape != (n, 10):
                    raise ValueError(f"reply of shape {out.shape} to {n} "
                                     f"images")
                replies.append((x, out))
        except Exception as e:   # reported by the main thread
            errors.append(e)

    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dt = time.perf_counter() - t0
    finally:
        engine.shutdown()
    if errors:
        raise errors[0]
    s = engine.stats
    pct = s.latency_percentiles()
    print(f"   {s.requests} requests / {s.images} images in {dt:.2f}s "
          f"({s.images/dt:.0f} img/s) over {s.steps} device steps; "
          f"mean batch fill {s.mean_batch_fill:.0%}; request latency "
          f"p50 {pct['p50']:.1f} / p99 {pct['p99']:.1f} ms")
    equal = all(np.array_equal(out, net(q.tensor(x, device=dev)).numpy())
                for x, out in replies)
    return {"requests": s.requests, "images": s.images, "seconds": dt,
            "img_per_s": s.images / dt, "steps": s.steps,
            "mean_batch_fill": s.mean_batch_fill, "p50_ms": pct["p50"],
            "p99_ms": pct["p99"], "replies_equal_direct": equal}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        ckpt = os.path.join(d, "resnet18_int8.npz")
        quantize_offline(ckpt, dev)
        checks = serve(ckpt, dev)
    checks["wall_s"] = time.perf_counter() - t_start
    return checks


if __name__ == "__main__":
    main()
