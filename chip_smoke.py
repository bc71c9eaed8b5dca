#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py             # every phase; exit 0 only if all pass
    python3 chip_smoke.py --profile   # also print a torch.profiler breakdown
                                      # of the AlexNet INT8 and FP32 forwards

Phases, in order (any failure exits non-zero):

1. the card's name and power limit (nvidia-smi); a CUDA device is required;
2. build every kernel from ``int8inferenceengine_tpu_torch/csrc`` (timed);
3. on-card numerics: ``quantize_u8`` and the epilogue vectors equal the CPU's
   bit for bit; the quantized GEMM kernel equals ``qgemm_plain`` exactly on
   the eight AlexNet batch-100 GEMM shapes and on ragged shapes, over both
   epilogue orders, both roundings, relu on/off, per-tensor and per-channel
   weight scales;
4. the main path at full width: AlexNet-224 with seeded random weights —
   FP32 forward against its ``torch.nn`` twin (rtol 1e-4), prepare,
   calibrate on one batch of 100, convert, INT8 forward with exactly 8
   kernel launches, and the first two images' output codes equal to those
   of a CPU copy carrying the same converted state;
5. timing with CUDA events: the AlexNet INT8 and FP32 batch-100 forwards,
   and per GEMM shape the kernel, its plain version, the bound, and
   ``torch._int_mm`` + the eager epilogue as a library yardstick.

The last lines are the nvidia-smi line, one JSON object describing every
kernel, and ``{"ok": true, "device": {...}}``.  The script imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# H100 SXM data-sheet peaks (dense): int8 tensor cores and HBM3.
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12

# AlexNet-224 batch-100 GEMMs: (layer, M, K, N); convs through im2col.
ALEXNET_B100 = [
    ("conv1", 302_500, 363, 96),
    ("conv2", 72_900, 2_400, 256),
    ("conv3", 16_900, 2_304, 384),
    ("conv4", 16_900, 3_456, 384),
    ("conv5", 16_900, 3_456, 256),
    ("fc1", 100, 9_216, 4_096),
    ("fc2", 100, 4_096, 4_096),
    ("fc3", 100, 4_096, 10),
]
CONV_LAYERS = {"conv1", "conv2", "conv3", "conv4", "conv5"}
RAGGED = [(7, 33, 5), (1, 16, 1), (129, 48, 130), (300, 100, 17),
          (255, 257, 129), (64, 4096, 8), (1000, 64, 1)]


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(m: int, k: int, n: int):
    """Least time on the card: operands read once, output written once
    (a u8, w s8, oc s32, ep f32, out u8) vs the int8 tensor-core peak."""
    ops = 2.0 * m * n * k
    nbytes = m * k + n * k + 8 * n + m * n
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                       else "operations"), t_ops, t_bytes


def gemm_case(torch, gen, m, k, n, dev):
    """Random operands; the output scale puts the codes mid-range."""
    a = torch.randint(0, 256, (m, k), generator=gen, dtype=torch.uint8,
                      device=dev)
    w = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8,
                      device=dev)
    q_bias = torch.randint(-127, 128, (n,), generator=gen, dtype=torch.int8,
                           device=dev)
    s_w_pc = (torch.rand((n,), generator=gen, device=dev) * 0.015 + 0.005)
    acc_std = 74.0 * 73.6 * math.sqrt(k)
    return dict(a=a, w=w, q_bias=q_bias, s_w_pc=s_w_pc, s_a=0.02, zp_a=131,
                s_c=0.02 * 0.01 * acc_std / 60.0, zp_c=110)


def time_cuda(torch, fn, iters: int, flush=None) -> float:
    """Mean ms of ``fn`` over ``iters`` launches, each timed with CUDA
    events; ``flush`` (run outside the timed span) evicts the L2 cache."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    spans = []
    for _ in range(iters):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in spans) / iters


def alexnet_state(torch, twin, seed: int):
    """He-scaled random weights from numpy's default_rng(seed)."""
    rng = np.random.default_rng(seed)
    state = {}
    for key, p in twin.state_dict().items():
        shape = tuple(p.shape)
        if key.endswith("weight"):
            fan_in = int(np.prod(shape[1:]))
            v = rng.standard_normal(shape) * math.sqrt(2.0 / fan_in)
        else:
            v = rng.standard_normal(shape) * 0.05
        state[key] = torch.tensor(v.astype(np.float32))
    return state


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="print a torch.profiler breakdown of the INT8 "
                         "and FP32 forwards")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this script needs a card")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import int8inferenceengine_tpu_torch as q
    from int8inferenceengine_tpu_torch import kernels
    from int8inferenceengine_tpu_torch.carry import export_state, load_jax_state
    from int8inferenceengine_tpu_torch.models import zoo
    from int8inferenceengine_tpu_torch.ops import gemm_int8 as G
    from int8inferenceengine_tpu_torch.ops.quant import quantize_u8

    # -- 1. the card -----------------------------------------------------------
    smi = nvidia_smi()
    log(smi)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {kind}")

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    kernels.build_all()
    build_s = time.perf_counter() - t0
    log(json.dumps({"phase": "build", "seconds": round(build_s, 3)}))
    for name in kernels.SIGNATURES:
        text = (kernels.BUILD_DIR / f"{name}.log")
        if text.exists():
            for line in text.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"ptxas {name}: {line.strip()}")

    # -- 3. on-card numerics ---------------------------------------------------
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(1 << 20) * 10).astype(np.float32)
    for rounding in ("trunc", "nearest"):
        got = quantize_u8(torch.tensor(x, device=dev), 0.0237, 127,
                          rounding).cpu()
        want = quantize_u8(torch.tensor(x), 0.0237, 127, rounding)
        if not torch.equal(got, want):
            fail(f"quantize_u8({rounding}) on the card differs from the CPU "
                 f"on {int((got != want).sum())} of {x.size} values")
    sw = torch.tensor(rng.uniform(0.001, 0.02, 4096).astype(np.float32))
    qb = torch.tensor(rng.integers(-127, 128, 4096).astype(np.int8))
    rs = torch.tensor(rng.integers(-10**5, 10**5, 4096).astype(np.int32))
    for order in G.ORDERS:
        ep_gpu = G.epilogue_vector(0.0173, sw.to(dev), 0.0411, 4096, dev,
                                   order).cpu()
        ep_cpu = G.epilogue_vector(0.0173, sw, 0.0411, 4096, "cpu", order)
        if not torch.equal(ep_gpu, ep_cpu):
            fail(f"epilogue_vector({order}) on the card differs from the CPU")
    oc_gpu = G.compute_offset(qb.to(dev), rs.to(dev), 0.00713, 97,
                              recentered=True).cpu()
    if not torch.equal(oc_gpu, G.compute_offset(qb, rs, 0.00713, 97,
                                                recentered=True)):
        fail("compute_offset on the card differs from the CPU")
    log(json.dumps({"phase": "scalar_numerics", "ok": True}))

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    max_err = 0
    n_cases = 0
    for shape in [s[1:] for s in ALEXNET_B100] + RAGGED:
        m, k, n = shape
        c = gemm_case(torch, gen, m, k, n, dev)
        oc = G.compute_offset(c["q_bias"], c["w"].to(torch.int32).sum(
            1, dtype=torch.int32), c["s_a"], c["zp_a"], recentered=True)
        spread = None
        for order in G.ORDERS:
            for per_channel in (False, True):
                s_w = c["s_w_pc"] if per_channel else 0.01
                ep = G.epilogue_vector(c["s_a"], s_w, c["s_c"], n, dev, order)
                for rounding in ("trunc", "nearest"):
                    for relu in (False, True):
                        kw = dict(scale_a=c["s_a"], scale_c=c["s_c"],
                                  zp_c=c["zp_c"], relu=relu,
                                  rounding=rounding, order=order)
                        got = G.qgemm(c["a"], c["w"], oc, ep, **kw)
                        want = G.qgemm_plain(c["a"], c["w"], oc, ep, **kw)
                        torch.cuda.synchronize()
                        err = int((got.to(torch.int32) - want.to(torch.int32)
                                   ).abs().max())
                        max_err = max(max_err, err)
                        n_cases += 1
                        if err:
                            bad = int((got != want).sum())
                            fail(f"qgemm kernel != plain at M={m} K={k} N={n} "
                                 f"order={order} per_channel={per_channel} "
                                 f"rounding={rounding} relu={relu}: {bad} "
                                 f"codes differ, max {err}")
                        if spread is None:
                            spread = int(torch.unique(want).numel())
        log(json.dumps({"phase": "kernel_vs_plain", "M": m, "K": k, "N": n,
                        "cases": 16, "distinct_codes": spread,
                        "max_abs_err": 0}))
    log(json.dumps({"phase": "kernel_vs_plain", "cases": n_cases,
                    "max_abs_err": max_err}))

    # -- 4. the main path: AlexNet-224 at batch 100 ----------------------------
    batch = 100
    twin = zoo.torch_twin("alexnet")
    state = alexnet_state(torch, twin, seed=0)
    twin.load_state_dict(state)
    twin = twin.to(dev).eval()
    rng = np.random.default_rng(0)
    x_calib = rng.standard_normal((batch, 3, 224, 224)).astype(np.float32)
    x_test = rng.standard_normal((batch, 3, 224, 224)).astype(np.float32)

    # the launch count covers the whole lifecycle: load, FP32 forward,
    # calibration, convert (none of which launch the kernel) and one INT8
    # forward (one launch per layer)
    G.qgemm.launches = 0
    model = zoo.AlexNet(device="cuda")
    model.load(state)
    fp32 = model(q.tensor(x_test)).data
    with torch.no_grad():
        ref = twin(torch.tensor(x_test, device=dev))
    scale = float(ref.abs().max())
    fp_err = float((fp32 - ref).abs().max()) / scale
    if not torch.allclose(fp32, ref, rtol=1e-4, atol=1e-4 * scale):
        fail(f"FP32 AlexNet differs from its torch twin: max error "
             f"{fp_err} of max |logit|")
    log(json.dumps({"phase": "fp32_vs_twin", "max_err_rel_to_max": fp_err}))

    t0 = time.perf_counter()
    model.prepare()
    model(q.tensor(x_calib))
    model.convert()
    torch.cuda.synchronize()
    lifecycle_s = time.perf_counter() - t0

    out = model(q.tensor(x_test)).data
    torch.cuda.synchronize()
    launches = G.qgemm.launches
    if launches != 8:
        fail(f"INT8 forward launched the qgemm kernel {launches} times, "
             f"want 8")
    if tuple(out.shape) != (batch, 10) or not bool(torch.isfinite(out).all()):
        fail(f"INT8 output shape {tuple(out.shape)} or non-finite values")
    top1 = float((out.argmax(1) == ref.argmax(1)).float().mean())
    log(json.dumps({"phase": "int8_forward", "launches": launches,
                    "calibrate_convert_s": round(lifecycle_s, 3),
                    "top1_agreement_vs_fp32": top1,
                    "output_scale": model.fc3.scale,
                    "output_zero_point": model.fc3.zero_point}))

    cpu = zoo.AlexNet(device="cpu")
    load_jax_state(cpu, export_state(model))
    out_cpu = cpu(q.tensor(x_test[:2], device="cpu")).data
    if not torch.equal(out[:2].cpu(), out_cpu):
        fail("INT8 codes on the card differ from the CPU copy's")
    log(json.dumps({"phase": "gpu_vs_cpu_codes", "images": 2, "equal": True}))

    # -- 5. timing -------------------------------------------------------------
    xt = q.tensor(x_test)
    int8_ms = time_cuda(torch, lambda: model(xt), iters=20)
    fp_model = zoo.AlexNet(device="cuda")
    fp_model.load(state)
    fp32_ms = time_cuda(torch, lambda: fp_model(xt), iters=20)
    log(json.dumps({"model": "alexnet_cifar10_224", "batch": batch,
                    "int8_ms_per_batch": int8_ms,
                    "int8_images_per_s": batch * 1e3 / int8_ms,
                    "fp32_ms_per_batch": fp32_ms,
                    "fp32_images_per_s": batch * 1e3 / fp32_ms}))

    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        reps = 5
        for name, net in (("int8", model), ("fp32", fp_model)):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(reps):
                    net(xt)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6 / reps
            # device-side rows only (kernels, memcpy, memset): the aten op
            # rows repeat their kernels' time
            rows = [e for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and e.self_device_time_total > 0]
            rows.sort(key=lambda e: -e.self_device_time_total)
            busy = sum(e.self_device_time_total for e in rows) / reps
            log(json.dumps({"profile": name, "batch": batch,
                            "wall_us_per_fwd": wall_us,
                            "device_busy_us_per_fwd": busy,
                            "device_idle_share": 1 - busy / wall_us,
                            "kernels": [{
                                "name": e.key[:90],
                                "us_per_fwd": e.self_device_time_total / reps,
                                "calls_per_fwd": e.count / reps}
                                for e in rows[:30]]}))
    del fp_model, model, twin

    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    flush = flush_buf.zero_
    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                  t_ops=0.0, t_bytes=0.0)
    for layer, m, k, n in ALEXNET_B100:
        c = gemm_case(torch, gen, m, k, n, dev)
        order = "conv" if layer in CONV_LAYERS else "gemm"
        oc = G.compute_offset(c["q_bias"], c["w"].to(torch.int32).sum(
            1, dtype=torch.int32), c["s_a"], c["zp_a"], recentered=True)
        ep = G.epilogue_vector(c["s_a"], 0.01, c["s_c"], n, dev, order)
        kw = dict(scale_a=c["s_a"], scale_c=c["s_c"], zp_c=c["zp_c"],
                  relu=layer != "fc3", rounding="trunc", order=order)
        ms = time_cuda(torch, lambda: G.qgemm(c["a"], c["w"], oc, ep, **kw),
                       iters=10, flush=flush)
        plain_ms = time_cuda(
            torch, lambda: G.qgemm_plain(c["a"], c["w"], oc, ep, **kw),
            iters=3, flush=flush)
        # library yardstick: cuBLAS int8 GEMM (K, N padded to multiples of
        # 8 with zeros) + the same eager epilogue; never used by the port
        kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
        a_s8 = torch.zeros((m, kp), dtype=torch.int8, device=dev)
        a_s8[:, :k] = (c["a"].to(torch.int16) - 128).to(torch.int8)
        w_p = torch.zeros((np_, kp), dtype=torch.int8, device=dev)
        w_p[:n, :k] = c["w"]

        def library():
            acc = torch._int_mm(a_s8, w_p.t())[:, :n]
            return G._requant_epilogue(acc + oc.reshape(1, -1), ep, **kw)

        if not torch.equal(library(), G.qgemm(c["a"], c["w"], oc, ep, **kw)):
            fail(f"{layer}: torch._int_mm + epilogue disagrees with the "
                 f"kernel")
        library_ms = time_cuda(torch, library, iters=5, flush=flush)
        b_ms, b_by, t_ops, t_bytes = bound_ms(m, k, n)
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                       ("library_ms", library_ms), ("t_ops", t_ops),
                       ("t_bytes", t_bytes)):
            totals[key] += v
        log(json.dumps({"kernel": "qgemm_u8s8", "layer": layer, "M": m,
                        "K": k, "N": n, "ms": ms, "bound_ms": b_ms,
                        "bound_by": b_by, "plain_ms": plain_ms,
                        "library_ms": library_ms,
                        "share_of_bound": b_ms / ms}))
        del c, a_s8, w_p

    log(smi)
    log(json.dumps({"kernels": [{
        "name": "qgemm_u8s8", "route": "cuda",
        "source": "int8inferenceengine_tpu_torch/csrc/qgemm_int8.cu",
        "replaces": "int8inferenceengine_tpu/ops/gemm_int8.py:111",
        "launches": launches, "max_abs_err": max_err,
        "ms": totals["ms"], "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": ("bytes" if totals["t_bytes"] >= totals["t_ops"]
                     else "operations"),
        "library_ms": totals["library_ms"]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
