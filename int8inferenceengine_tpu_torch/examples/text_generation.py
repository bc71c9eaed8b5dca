"""INT8 autoregressive decoding end-to-end: PTQ a causal LM, then generate.

Mirrors the reference notebooks' cell pattern (build twin -> load -> FP32
parity -> calibrate -> convert) and then exercises the decode stack:
``generate()`` (greedy + sampled) and the continuous-batching
``GenerationEngine``.  The checks are those of the JAX package's
``examples/text_generation.py``; ``main()`` also holds every engine request
against ``generate()`` of its prompt alone.

    python -m int8inferenceengine_tpu_torch.examples.text_generation \
        [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

import int8inferenceengine_tpu_torch as q
from int8inferenceengine_tpu_torch import models
from int8inferenceengine_tpu_torch.examples import add_device_arg, device_of
from int8inferenceengine_tpu_torch.serve import GenerationEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    t_start = time.perf_counter()

    tw = models.torch_twin("gpt_tiny").to(dev)
    m = models.build("gpt_tiny", device=dev)
    m.load(tw.state_dict())
    rng = np.random.default_rng(0)

    ids = rng.integers(0, 1000, (4, 32)).astype(np.int32)
    with torch.no_grad():
        ref = tw(torch.tensor(ids, dtype=torch.long, device=dev)).cpu().numpy()
    out = m(q.tensor(ids, device=dev)).numpy()
    fp32_diff = float(np.abs(out - ref).max())
    print(f"FP32 parity: max |diff| = {fp32_diff:.2e}")

    m.prepare()
    m(q.tensor(rng.integers(0, 1000, (16, 64)).astype(np.int32), device=dev))
    m.convert()
    out8 = m(q.tensor(ids, device=dev)).numpy()
    agree = float((out8[:, -1].argmax(-1) == ref[:, -1].argmax(-1)).mean())
    print(f"INT8 next-token argmax agreement vs torch FP32: {agree:.2f}")

    prompt = rng.integers(0, 1000, (2, 12)).astype(np.int32)
    greedy = m.generate(prompt, 16)
    print("greedy tokens   :", greedy[0].tolist())
    sampled = m.generate(prompt, 16, temperature=0.9, top_k=40, seed=1)
    print("sampled (t=0.9) :", sampled[0].tolist())

    requests = [(rng.integers(0, 1000, n).astype(np.int32), {})
                for n in (5, 11, 19)]
    # per-request sampling rides the same slots as greedy requests
    requests.append((rng.integers(0, 1000, 7).astype(np.int32),
                     dict(temperature=0.9, seed=2)))
    eng = GenerationEngine(m, slots=2, chunk_steps=4)
    try:
        futs = [eng.submit(p, 8, **kw) for p, kw in requests]
        replies = []
        for k, f in enumerate(futs):
            replies.append(f.result(timeout=300))
            print(f"engine request {k}: {replies[-1].tolist()}")
    finally:
        eng.shutdown()
    alone = [m.generate(p[None], 8, **kw)[0] for p, kw in requests]
    print("OK")
    return {"fp32_max_abs_diff": fp32_diff, "int8_agreement": agree,
            "greedy": greedy.tolist(), "sampled": sampled.tolist(),
            "engine": [r.tolist() for r in replies],
            "engine_equals_generate": all(
                np.array_equal(r, a) for r, a in zip(replies, alone)),
            "wall_s": time.perf_counter() - t_start}


if __name__ == "__main__":
    main()
