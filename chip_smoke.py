#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py             # every phase; exit 0 only if all pass
    python3 chip_smoke.py --profile   # also print torch.profiler breakdowns
                                      # of the AlexNet forwards, of decode
                                      # steps and of the llama prefill
    python3 chip_smoke.py --sweep     # only time B1/B2, B6 and B3 under every
                                      # candidate plan (the planners' tuning
                                      # data)

Phases, in order (any failure exits non-zero):

1. the card's name and power limit (nvidia-smi); a CUDA device is required;
2. build every kernel from ``int8inferenceengine_tpu_torch/csrc``, one nvcc
   per source, all started together (timed);
3. on-card numerics: ``quantize_u8`` and the epilogue vectors equal the CPU's
   bit for bit; the quantized GEMM kernel (B1) equals ``qgemm_plain``
   exactly on the eight AlexNet batch-100 GEMM shapes, on ragged shapes and
   on the narrow-grid shapes (M = 1, 8, 16, 100: the small tiles and the K
   split over a cluster), over both epilogue orders, both roundings, relu
   on/off, per-tensor and per-channel weight scales; B1's gathered conv
   equals im2col + ``qgemm_plain`` exactly over the same sixteen cases at
   the five AlexNet batch-100 geometries and eight ragged ones;
4. the decoder's kernels against their plain versions at its shapes: B1's
   act epilogue with each of its seven activations (exact for the
   piecewise-linear ones, the 1-code/0.2% contract for sigmoid, silu,
   gelu), the merged QKV GEMM (B2) exactly at M = 8, 512 and ragged
   shapes, and the decode attention kernel (B3/B4) within the contract at
   B=8, H=12, D=64, T=512 and 4,096 (``ATTN_CASES``) over live lengths 1,
   77, 128, 511 and 4,000 where they fit, a full cache and a per-sequence
   length vector, GQA 12/2 and 12/4, four query positions, a window and a
   softcap, under ``plan_decode_attn``'s split and, for four cases, under
   every split count;
5. the AlexNet main path at full width: AlexNet-224 with seeded random
   weights — FP32 forward against its ``torch.nn`` twin (rtol 1e-4),
   prepare, calibrate on one batch of 100, convert, INT8 forward with
   exactly 8 kernel launches, the first two images' codes equal to a CPU
   copy's;
6. the decoders' card codes against a CPU copy: a small gpt2-style and a
   small llama W4A8 decoder (depth 2, dim 256, 4 heads, llama 2 kv heads,
   vocab 4096, max_len 128; batch 4, a 16-token prompt; the main paths'
   QuantConfigs; and the legs of ``CPU_GATE_LEGS``) calibrated and
   converted on the card and carried to the CPU (``export_state`` ->
   ``load_jax_state``): the prefill's logit codes, 16 greedy steps
   teacher-forced on the card's tokens and the greedy tokens themselves,
   each leg within the reference's contract (at most 1 code off on at most
   0.2%; equal tokens);
7. the decoder main path at full width (gpt2-small-ish: 768d, 12 layers, 12
   heads, vocab 50257, max_len 512) with seeded random weights, batch 8, a
   64-token prompt: FP32 forward against its twin (rtol 1e-4), prepare,
   calibrate, convert, greedy ``generate(ids, 128)`` (the first decode step
   eager, the others replaying it as a captured CUDA graph) with exactly 12
   B2, 37 B1 and 12 B3 per decode step (the wrappers count the prefill and
   the eager step, each replay adds the kernels that the capture recorded,
   and the capture adds nothing; in a profile of 4 replays of a step
   captured the same way each replay runs what it counts), then the kernel
   path's logit codes against the
   plain path's on the card, teacher-forced on its tokens, and the captured
   decode against the eager step loop: the tokens, and 128 teacher-forced
   steps' codes through a captured step, equal;
8. the 4-bit kernels against their plain versions at every shape the llama
   legs launch: B6 (W4A8 with exact per-group integer partials) exactly at
   the decode shapes, at M = 16, 64 and 128 and at ragged shapes, under
   both roundings, ``plan_w4a8_v2``'s plan and every K split it runs; B7
   (W4A8 at every other shape)
   at the prefill shapes with scalar and per-column ``mult``, at ragged
   shapes and at groups off the 32-value k-step, bit for bit equal to B6's
   plain arithmetic (``w4a8_v2_plain``, any M) and within 1 code on 0.2%
   of its own f32 plain version; B5 (W4 weight-only) within 2e-5 of the
   largest |output| at the weight-only shapes, the same edge shapes and an
   input whose magnitudes span 2^-60 ... 2^60; and at the engines' batched
   prefill shapes (M = n x bucket for the prompt lengths of 12, n up to 8
   slots: 32 to 1,024 rows) B1 and B2 at the gpt2 Linears and B6 or B7, as
   the W4A8 dispatch picks, at the llama's, under the same contracts;
9. the llama W4A8 main path at full width (bench.py's W4A8 leg: 768d, 12
   layers, 12 heads over 2 kv heads, vocab 32000, max_len 512, group 256,
   nearest rounding) with seeded random weights, batch 8, a 64-token prompt:
   FP32 forward against its twin (1e-4 of the largest logit), prepare,
   calibrate, convert, greedy ``generate(ids, 128)`` (captured, counted as
   in 7) with exactly 49 B6 and 12 B3 per decode step and 25 single-layer +
   24 merged B7 launches in the prefill, the captured decode equal to the
   eager step loop as in 7; every W4 launch of the prefill and of 16 decode
   steps replayed through its plain versions on its own operands; from one
   shared prefill cache, 128 teacher-forced decode steps whose logit codes
   must equal those of the same model with its W4 and B3 wrappers swapped
   for their plain versions; the prefill's codes against the plain path's
   (recorded, not gated);
10. the llama W4 weight-only forward (group 128) on the same weights and
   prompt: exactly 85 B5 launches, every launch replayed, logits within
   1e-4 of the largest |logit| of the plain path's;
11. timing with CUDA events: the AlexNet INT8 and FP32 batch-100 forwards,
   decode ms/step as ``(t(128 steps) - t(16 steps)) / 112`` (best of 3) and
   the prefill for both decoders, the weight-only forward, the full-context
   forwards (8 x 512 tokens: the weight-only model, and the W4A8 model's
   causal forward, B7 at M = 4096; recorded, not gated), and per kernel
   and shape the kernel (with B1's, B2's, B6's and B3's plan), its plain
   version, the bound and a library yardstick; B3 also at a full cache
   (recorded beside the step's); beside each captured decode ms/step the
   eager step loop's by the same protocol; an empty launch through the same timer
   (the event floor); for the convs the gathered kernel beside
   im2col + B1 and the conv's own bound beside the im2col operand's
   (``bound_im2col_ms``); the yardstick for the int8 GEMMs is
   ``torch._int_mm`` (on the patch matrix, for a conv) + the eager epilogue,
   for B5 ``torch.addmm`` on the weight dequantized beforehand (f32, TF32
   off).  B3, B6 and B7 have none: no single PyTorch call computes
   attention over the u8 cache or a packed 4-bit GEMM with a requantizing
   epilogue;
12. serving the decoders (``serve.GenerationEngine``: 8 slots, chunks of
   32 captured steps, 4 chunks a host sync): the gpt2-small-ish engine
   takes 16 requests (prompts of 17-100 tokens, 64-128 new tokens; 10
   greedy, 4 sampled at temperature 0.8, top_p 0.9, top_k 40 with fixed
   seeds, 2 with an eos that their greedy run emits) twice: each greedy
   request equals ``generate()`` of its prompt alone, an eos request ends
   where that run first emits it, and the sampled ones repeat in the second
   pass; the llama W4A8 engine takes 8 greedy requests, the same gate.  Each
   then serves a saturated load (32 requests x 64 prompt tokens x 128 new
   tokens, greedy): tokens/s, time to first token p50/p99, mean slot fill;
   and a profiled replay of its greedy chunk graph must run the kernels
   that a replay counts.  The gpt2 engine also runs bench.py's engine leg
   (8 slots, 8 chunks a sync, 16 requests x 24 prompt tokens x 256 new
   tokens; tokens/s best of 2 after a warm round), the serving yardstick;
13. the small decoders of 6 served by an engine on the card and one on the
   CPU (gpt2 at 4 slots, llama W4A8 at 8 slots with a 768-wide MLP, every
   GEMM on B6): greedy tokens equal, sampled tokens recorded;
14. AlexNet-224's ``serve.InferenceEngine`` (max_batch 100, the forward
   captured per tile): requests of 1, 7, 33, 64 and 100 images equal the
   direct call exactly, and their counted launches equal the kernels that
   a profile of them saw run; images/s at a saturated load beside the
   direct call's.

The last lines are the nvidia-smi line, one JSON object describing every
kernel, and ``{"ok": true, "device": {...}}``.  The script imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# H100 SXM data-sheet peaks (dense): int8 and bf16 tensor cores, float32
# outside the tensor cores (the first port's B5 and B7 bound) and HBM3.
PEAK_INT8_OPS = 1979e12
PEAK_BF16_OPS = 989e12
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
# the device spin before each timed launch: about 0.2 ms at the H100's
# 1.98 GHz, more than a wrapper's host time (the decode attention wrapper's
# outlasted the 256 MB flush alone)
HOST_LEAD_CYCLES = 400_000

# AlexNet-224 batch-100 GEMMs: (layer, M, K, N); a conv as the GEMM over its
# patch matrix, which the kernel gathers from the NHWC input (ALEXNET_CONVS)
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
# the convs' geometries: (batch, h, w, c_in, kernel, stride, padding)
ALEXNET_CONVS = {"conv1": (100, 224, 224, 3, 11, 4, 2),
                 "conv2": (100, 27, 27, 96, 5, 1, 2),
                 "conv3": (100, 13, 13, 256, 3, 1, 1),
                 "conv4": (100, 13, 13, 384, 3, 1, 1),
                 "conv5": (100, 13, 13, 384, 3, 1, 1)}
RAGGED = [(7, 33, 5), (1, 16, 1), (129, 48, 130), (300, 100, 17),
          (255, 257, 129), (64, 4096, 8), (1000, 64, 1)]
# ragged conv geometries, (batch, h, w, c_in, kernel, stride, padding,
# c_out): batch 1-3, C = 3/16/48/96, odd H and W, stride 1/2/4, padding
# 0/1/2, kernel 1/3/5/11
RAGGED_CONVS = [(1, 9, 7, 16, 3, 2, 1, 20), (2, 11, 13, 3, 5, 2, 2, 33),
                (3, 10, 9, 48, 1, 1, 0, 40), (1, 35, 33, 3, 11, 4, 2, 16),
                (2, 15, 15, 96, 5, 1, 2, 64), (3, 7, 11, 16, 3, 1, 0, 24),
                (1, 5, 5, 96, 5, 1, 2, 8), (2, 31, 29, 48, 3, 2, 1, 130)]
# the narrow-grid path (16- and 64-row tiles, K split over a cluster):
# (M, K, N) at M = 1, 8, 16, 100
NARROW = [(1, 768, 50_257), (1, 4_096, 10), (8, 3_072, 768),
          (8, 768, 3_072), (16, 9_216, 4_096), (16, 768, 768),
          (100, 4_096, 10), (100, 9_216, 4_096), (100, 4_096, 4_096)]

# gpt2-small-ish decode (bench.py's decode leg): the geometry, the batch,
# the prompt and the two generate lengths of the ms/step protocol
GPT = dict(vocab_size=50257, max_len=512, dim=768, depth=12, heads=12)
DEC_BATCH, DEC_PROMPT, DEC_STEPS, DEC_SHORT = 8, 64, 128, 16
# one decode step's B1 launches: (layer, M, K, N, launches per step, act)
DEC_GEMMS = [("proj", 8, 768, 768, 12, None),
             ("fc1+gelu", 8, 768, 3072, 12, "gelu"),
             ("fc2", 8, 3072, 768, 12, None),
             ("head", 8, 768, 50257, 1, None)]
# its B2 launches (M, K, per-head N, launches per step)
DEC_QKV = (8, 768, 768, 12)
# its B3 launches; the live length is the mean over generate(ids, 128)
# after a 64-token prompt (65 ... 191)
DEC_ATTN = dict(b=8, t=512, h=12, d=64, valid=128, launches=12)
# B3's checks: (T, H, Hkv, mq, window, softcap, every split count) at B=8,
# D=64, over the live lengths that fit (and T - mq + 1) and a per-sequence
# vector; GQA 12/2 with 4 query positions at T = 4096 needs the split's
# shared memory (one share's scores, not all of T's)
ATTN_CASES = [(512, 12, 12, 1, None, None, True),
              (512, 12, 2, 1, None, None, True),
              (512, 12, 4, 1, None, None, False),
              (512, 12, 12, 4, None, None, False),
              (512, 12, 12, 1, 128, None, False),
              (512, 12, 12, 1, None, 30.0, False),
              (512, 12, 2, 4, 128, 30.0, True),
              (4096, 12, 2, 4, None, None, True),
              (4096, 12, 12, 1, None, None, False),
              (4096, 12, 2, 1, 1000, 30.0, False)]
ATTN_LIVE = (1, 77, 128, 511, 4000)
PIECEWISE = ("relu", "relu6", "hardsigmoid", "hardswish")
# output range of each activation over inputs in [-5, 5]: the act grid
ACT_RANGE = {"relu": (0.0, 5.0), "relu6": (0.0, 6.0),
             "hardsigmoid": (0.0, 1.0), "hardswish": (-0.375, 5.0),
             "sigmoid": (0.0, 1.0), "silu": (-0.28, 5.0),
             "gelu": (-0.17, 5.0)}
ATTN_PARAMS = dict(scale_q=0.021, zp_q=117, scale_k=0.034, zp_k=131,
                   scale_v=0.027, zp_v=125, scale_s=0.4, zp_s=140,
                   scale_p=0.0039, zp_p=0, scale_c=0.05, zp_c=128,
                   alpha=0.125)
# the decoder's codes, kernel path vs plain path, teacher-forced
MAX_CODE_DIFF, MAX_SHARE_DIFF = 2, 0.01

# bench.py's W4A8 llama leg (bench.py:258-293): geometry and config; the
# batch and prompt are the decoder's (DEC_BATCH, DEC_PROMPT)
LLAMA = dict(vocab_size=32000, max_len=512, dim=768, depth=12, heads=12,
             kv_heads=2)
LLAMA_W4A8 = dict(rounding="nearest", weight_bits=4, w4_group=256)
LLAMA_W4 = dict(weight_only=True, weight_bits=4)          # group 128
# one decode step's B6 launches: (layer, M, K, N, launches per step)
W4_DECODE = [("qkv", 8, 768, 1024, 12), ("proj", 8, 768, 768, 12),
             ("gate+up", 8, 768, 4096, 12), ("down", 8, 2048, 768, 12),
             ("head", 8, 768, 32000, 1)]
# B6 over the rest of its envelope's batch sizes (checked and swept)
W4_DECODE_M = [(f"proj M={m}", m, 768, 768, 0) for m in (16, 64, 128)]
# the prefill's B7 launches at M = 8 x 64: (layer, M, K, N, launches,
# per-column mult), the merged calls carry one mult per column
W4_PREFILL = [("qkv", 512, 768, 1024, 12, True),
              ("proj", 512, 768, 768, 12, False),
              ("gate+up", 512, 768, 4096, 12, True),
              ("down", 512, 2048, 768, 12, False),
              ("head", 512, 768, 32000, 1, False)]
# the weight-only forward's B5 launches at M = 8 x 64, group 128
W4_FORWARD = [("wq", 512, 768, 768, 12), ("wk", 512, 768, 128, 12),
              ("wv", 512, 768, 128, 12), ("proj", 512, 768, 768, 12),
              ("gate", 512, 768, 2048, 12), ("up", 512, 768, 2048, 12),
              ("down", 512, 2048, 768, 12), ("head", 512, 768, 32000, 1)]
# the llama decode's B3 launches (Hkv = 2)
LLAMA_ATTN = dict(b=8, t=512, h=12, hkv=2, d=64, valid=128, launches=12)
# B5's contract against its plain version, relative to the largest |output|
W4_RTOL = 2e-5
# the decoders on the card against a CPU copy: small models of both
# families (the llama W4A8 one with 2 kv heads), batch, prompt and steps,
# and the reference's contract (at most 1 code off on at most 0.2%)
SMALL_DEC = dict(vocab_size=4096, max_len=128, dim=256, depth=2, heads=4)
SMALL_BATCH, SMALL_PROMPT, SMALL_STEPS = 4, 16, 16
CPU_MAX_CODE, CPU_MAX_SHARE = 1, 0.002
# the legs: (family, batch, extra geometry, gated).  Batch 4 is the gate's
# own size; gpt2 at batch 8 is where a float32 LayerNorm mean and the
# card's rsqrt once moved a code (repaired: the norms' means and rsqrt, and
# every exp and erfc, run in float64 and round once); the llama at batch 8
# with a 768-wide MLP runs every W4A8 GEMM through B6 (exact on both
# sides).  At batch 4 a 768-wide MLP's decode runs B7, whose CPU path
# is its float32 plain version (B7's contract exception, not the glue's):
# recorded, not gated.
CPU_GATE_LEGS = [("gpt2", 4, {}, True), ("llama_w4a8", 4, {}, True),
                 ("gpt2", 8, {}, True),
                 ("llama_w4a8", 8, {"mlp_hidden": 768}, True),
                 ("llama_w4a8", 4, {"mlp_hidden": 768}, False)]
# the full-context forwards: the batch at the model's max_len
FULL_CONTEXT = (DEC_BATCH, LLAMA["max_len"])

KERNEL_INFO = {
    "qgemm_u8s8": dict(
        source="int8inferenceengine_tpu_torch/csrc/qgemm_int8.cu",
        replaces="int8inferenceengine_tpu/ops/gemm_int8.py:111"),
    "qgemm_u8s8_vzp": dict(
        source="int8inferenceengine_tpu_torch/csrc/qgemm_int8.cu",
        replaces="int8inferenceengine_tpu/ops/gemm_int8.py:422"),
    "decode_attn_flat": dict(
        source="int8inferenceengine_tpu_torch/csrc/decode_attn.cu",
        replaces="int8inferenceengine_tpu/ops/attention.py:417",
        also_replaces="int8inferenceengine_tpu/ops/attention.py:214"),
    "w4_gemm": dict(
        source="int8inferenceengine_tpu_torch/csrc/w4_gemm.cu",
        replaces="int8inferenceengine_tpu/ops/w4.py:116"),
    "w4a8_v2_gemm": dict(
        source="int8inferenceengine_tpu_torch/csrc/w4_gemm.cu",
        replaces="int8inferenceengine_tpu/ops/w4.py:357"),
    "w4a8_v1_gemm": dict(
        source="int8inferenceengine_tpu_torch/csrc/w4_gemm.cu",
        replaces="int8inferenceengine_tpu/ops/w4.py:247"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float, peak: float = PEAK_INT8_OPS):
    """Least time on the card (ms): the bytes at the HBM rate vs the
    operations at ``peak`` (the int8 tensor-core peak unless given), and
    which one bounds."""
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                       else "operations"), t_ops, t_bytes


def bound_ms(m: int, k: int, n: int, vectors: int = 2):
    """A GEMM's bound: operands read once, output written once (a u8, w s8,
    ``vectors`` 4-byte [N] epilogue vectors, out u8)."""
    return bound(m * k + n * k + 4 * vectors * n + m * n, 2.0 * m * n * k)


def attn_bound_ms(b, h, hkv, d, valid, mq=1):
    """Decode attention's bound: q, the live k/v rows and the output moved
    once; QK^T and P@V as int8 operations."""
    nbytes = 2 * b * mq * h * d + 2 * b * valid * hkv * d + 4 * b
    return bound(nbytes, 4.0 * b * mq * h * valid * d)


def w4_bound_ms(kernel: str, m: int, k: int, n: int, group: int,
                simt: bool = False):
    """A 4-bit GEMM's bound: the packed weight (K/2 bytes a row), its f32
    group scales, the activations (u8, or f32 for B5), two f32 [N] vectors
    (mult and zpb, or the bias for B5) and the output (u8, or f32 for B5),
    each moved once; the operations: 2MNK int8 tensor-core ones for B6 and
    B7 (their products are integers), three bf16 passes (3 x 2MNK at the
    bf16 peak) for B5.  ``simt``: the first port's bound for B5 and B7,
    2MNK true f32 operations at the non-tensor-core peak."""
    g = min(group, k)
    x_bytes, out_bytes = (4, 4) if kernel == "w4_gemm" else (1, 1)
    vectors = 1 if kernel == "w4_gemm" else 2
    nbytes = (n * k // 2 + 4 * n * -(-k // g) + x_bytes * m * k
              + 4 * vectors * n + out_bytes * m * n)
    ops = 2.0 * m * n * k
    if simt:
        return bound(nbytes, ops, PEAK_FP32_OPS)
    if kernel == "w4_gemm":
        return bound(nbytes, 3 * ops, PEAK_BF16_OPS)
    return bound(nbytes, ops, PEAK_INT8_OPS)


def contract(torch, got, want):
    """(max |code difference|, share of codes that differ)."""
    d = (got.to(torch.int32) - want.to(torch.int32)).abs()
    return int(d.max()), float((d > 0).float().mean())


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


def rowsum(torch, w):
    return w.to(torch.int32).sum(1, dtype=torch.int32)


def act_grid(fn: str):
    """(name, act_scale, act_zp) spanning ``fn``'s outputs over [-5, 5]."""
    lo, hi = ACT_RANGE[fn]
    act_scale = (hi - lo) / 255.0
    return fn, act_scale, int(round(-lo / act_scale))


def time_cuda(torch, fn, iters: int, flush=None) -> float:
    """Mean ms of ``fn`` over ``iters`` launches, each timed with CUDA
    events.  ``flush`` (run outside the timed span) evicts the L2 cache;
    a device-side spin after it keeps the card busy while the host runs the
    wrapper's Python, so that the span holds the device work alone."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    spans = []
    for _ in range(iters):
        if flush is not None:
            flush()
            torch.cuda._sleep(HOST_LEAD_CYCLES)
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


def decoder_state(torch, twin, depth: int, seed: int,
                  residual=("proj", "fc2")):
    """GPT-2-style random weights from numpy's default_rng(seed): N(0, 0.02)
    for Linear weights and embeddings (0.02/sqrt(2*depth) for the residual
    projections, proj/fc2 or the llama's proj/down), N(0, 0.01) positions
    and biases, LayerNorm and RMSNorm gains 1 + N(0, 0.02)."""
    rng = np.random.default_rng(seed)
    state = {}
    for key, p in twin.state_dict().items():
        z = rng.standard_normal(tuple(p.shape), dtype=np.float32)
        if key.startswith("ln"):
            v = 1.0 + 0.02 * z if key.endswith("weight") else 0.02 * z
        elif key.endswith("bias") or key == "pe.weight":
            v = 0.01 * z
        elif key.startswith(residual):
            v = (0.02 / math.sqrt(2 * depth)) * z
        else:
            v = 0.02 * z
        state[key] = torch.from_numpy(np.ascontiguousarray(v, np.float32))
    return state


def profile_rows(torch, prof):
    """Device-side rows (kernels, memcpy, memset), largest first: the aten
    op rows repeat their kernels' time."""
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda e: -e.self_device_time_total)
    return rows


# -- phase 3: B1 against its plain version at the AlexNet shapes -------------

def plan_of(G, m, n, k, dev, conv=None):
    """The kernel's plan for a launch, as printed in the per-shape lines."""
    p = G.plan_qgemm(m, n, k, conv=conv, sms=G.sm_count(dev))
    return dict(variant=p.variant, tile=list(p.tile), slices=p.slices,
                k_slice=p.k_slice, loader=p.loader)


def check_alexnet_kernel(torch, G, gen, dev):
    """B1 (the GEMM variant) at the AlexNet shapes, ragged shapes and the
    narrow-grid shapes (M = 1, 8, 16, 100, split over K)."""
    max_err = 0
    n_cases = 0
    for shape in [s[1:] for s in ALEXNET_B100] + RAGGED + NARROW:
        m, k, n = shape
        c = gemm_case(torch, gen, m, k, n, dev)
        oc = G.compute_offset(c["q_bias"], rowsum(torch, c["w"]), c["s_a"],
                              c["zp_a"], recentered=True)
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
                        "plan": plan_of(G, m, n, k, dev), "cases": 16,
                        "distinct_codes": spread, "max_abs_err": 0}))
    log(json.dumps({"phase": "kernel_vs_plain", "cases": n_cases,
                    "max_abs_err": max_err}))
    return max_err


def conv_case(torch, gen, geom, c_out, dev):
    """A u8 NHWC input and the conv's operands as for ``gemm_case``."""
    b, h, w, c, k = geom[:5]
    x = torch.randint(0, 256, (b, h, w, c), generator=gen, dtype=torch.uint8,
                      device=dev)
    return x, gemm_case(torch, gen, 1, k * k * c, c_out, dev)


def check_gathered_conv(torch, G, C, gen, dev):
    """The gathered conv (B1's conv variant, through ``conv2d_int8_gemm`` on
    the card) against im2col + ``qgemm_plain``, bit for bit, at the five
    AlexNet b100 geometries and ragged ones, over both orders, both
    roundings, relu on/off and per-tensor and per-channel s_w."""
    geoms = [(ALEXNET_CONVS[layer], n) for layer, _, _, n in ALEXNET_B100
             if layer in ALEXNET_CONVS]
    geoms += [(g[:7], g[7]) for g in RAGGED_CONVS]
    n_cases = 0
    for geom, n in geoms:
        b, h, w, c, k, stride, pad = geom
        x, cs = conv_case(torch, gen, geom, n, dev)
        oc = G.compute_offset(cs["q_bias"], rowsum(torch, cs["w"]),
                              cs["s_a"], cs["zp_a"], recentered=True)
        g = G.ConvGeom(b, h, w, c, k, k, stride, pad)
        m, kk = g.gemm_shape
        plan = plan_of(G, m, n, kk, dev, conv=g)
        if plan["variant"] != "conv":
            fail(f"conv {geom} is not planned as a gathered conv: {plan}")
        spread = None
        for order in G.ORDERS:
            for per_channel in (False, True):
                s_w = cs["s_w_pc"] if per_channel else 0.01
                ep = G.epilogue_vector(cs["s_a"], s_w, cs["s_c"], n, dev,
                                       order)
                for rounding in ("trunc", "nearest"):
                    for relu in (False, True):
                        kw = dict(kh=k, kw=k, stride=stride, padding=pad,
                                  scale_a=cs["s_a"], zp_a=cs["zp_a"],
                                  scale_c=cs["s_c"], zp_c=cs["zp_c"],
                                  relu=relu, rounding=rounding, order=order)
                        before = G.qgemm.launches
                        got = C.conv2d_int8_gemm(x, cs["w"], oc, ep, **kw)
                        launched = G.qgemm.launches - before
                        want = C.conv2d_int8_gemm(x, cs["w"], oc, ep,
                                                  gemm=G.qgemm_plain, **kw)
                        torch.cuda.synchronize()
                        n_cases += 1
                        if launched != 1 or not torch.equal(got, want):
                            fail(f"gathered conv != im2col + plain at {geom} "
                                 f"N={n} order={order} per_channel="
                                 f"{per_channel} rounding={rounding} relu="
                                 f"{relu}: {int((got != want).sum())} codes "
                                 f"differ, {launched} launches")
                        if spread is None:
                            spread = int(torch.unique(want).numel())
        log(json.dumps({"phase": "gathered_conv_vs_plain", "geometry": geom,
                        "N": n, "M": m, "K": kk, "plan": plan, "cases": 16,
                        "distinct_codes": spread, "max_abs_err": 0}))
        del x, cs
    log(json.dumps({"phase": "gathered_conv_vs_plain", "cases": n_cases,
                    "max_abs_err": 0}))


# -- phase 4: the decoder's kernels against their plain versions ------------

def check_decoder_kernels(torch, G, A, gen, dev):
    """Returns {kernel: max |code difference|} over every case."""
    err = {"qgemm_u8s8": 0, "qgemm_u8s8_vzp": 0, "decode_attn_flat": 0}
    for fn in G.KERNEL_ACTS:
        worst = (0, 0.0)
        for m, k, n in [(8, 768, 3072), (512, 768, 3072), (37, 100, 61)]:
            c = gemm_case(torch, gen, m, k, n, dev)
            oc = G.compute_offset(c["q_bias"], rowsum(torch, c["w"]),
                                  c["s_a"], c["zp_a"], recentered=True)
            # scale s_w and s_c alike: the same codes, dequantized to [-5, 5]
            f = 5.0 / (110 * c["s_c"])
            ep = G.epilogue_vector(c["s_a"], c["s_w_pc"] * f, c["s_c"] * f,
                                   n, dev, "gemm")
            for rounding in ("trunc", "nearest"):
                kw = dict(scale_a=c["s_a"], scale_c=c["s_c"] * f,
                          zp_c=c["zp_c"], rounding=rounding, act=act_grid(fn))
                got = G.qgemm(c["a"], c["w"], oc, ep, **kw)
                want = G.qgemm_plain(c["a"], c["w"], oc, ep, **kw)
                torch.cuda.synchronize()
                mx, share = contract(torch, got, want)
                worst = max(worst, (mx, share))
                if (fn in PIECEWISE and mx) or mx > 1 or share > 0.002:
                    fail(f"qgemm act={fn} kernel != plain at M={m} K={k} "
                         f"N={n} {rounding}: max {mx}, share {share}")
        err["qgemm_u8s8"] = max(err["qgemm_u8s8"], worst[0])
        log(json.dumps({"phase": "act_kernel_vs_plain", "act": fn,
                        "plan_at_M8": plan_of(G, 8, 3072, 768, dev),
                        "max_abs_err": worst[0], "share_differing": worst[1],
                        "contract": "exact" if fn in PIECEWISE
                        else "<=1 code on <=0.2%"}))

    for m, k, widths in [(8, 768, (768, 768, 768)), (512, 768, (768,) * 3),
                         (37, 100, (13, 50, 7)), (1, 48, (130, 1, 64))]:
        parts = []
        for i, n in enumerate(widths):
            c = gemm_case(torch, gen, m, k, n, dev)
            parts.append(dict(w_s8_nk=c["w"], q_bias=c["q_bias"],
                              rowsum=rowsum(torch, c["w"]),
                              scale_w=c["s_w_pc"] if i == 1 else 0.01,
                              scale_c=c["s_c"] * (1 + 0.3 * i),
                              zp_c=100 + 20 * i))
        merged = G.merge_parts(parts, scale_a=c["s_a"], zp_a=c["zp_a"])
        for rounding in ("trunc", "nearest"):
            got = torch.cat(G.qgemm_multi(c["a"], merged, rounding=rounding),
                            1)
            want = torch.cat(G.qgemm_multi_plain(c["a"], merged,
                                                 rounding=rounding), 1)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"qgemm_multi kernel != plain at M={m} K={k} "
                     f"N={widths} {rounding}: "
                     f"{int((got != want).sum())} codes differ")
        log(json.dumps({"phase": "vzp_kernel_vs_plain", "M": m, "K": k,
                        "N": list(widths), "max_abs_err": 0,
                        "plan": plan_of(G, m, sum(widths), k, dev),
                        "distinct_codes": int(torch.unique(got).numel())}))

    b, d = DEC_ATTN["b"], DEC_ATTN["d"]
    for t, h, kv, mq, window, softcap, every_split in ATTN_CASES:
        qshape = (b, mq, h * d) if mq > 1 else (b, h * d)
        q = torch.randint(0, 256, qshape, generator=gen, dtype=torch.uint8,
                          device=dev)
        k = torch.randint(0, 256, (b, t, kv * d), generator=gen,
                          dtype=torch.uint8, device=dev)
        v = torch.randint(0, 256, (b, t, kv * d), generator=gen,
                          dtype=torch.uint8, device=dev)
        per_seq = torch.randint(1, t - mq + 2, (b,), generator=gen,
                                dtype=torch.int32, device=dev)
        kw = dict(ATTN_PARAMS, n_heads=h, n_kv_heads=kv, window=window,
                  softcap=softcap)
        chosen = A.plan_decode_attn(b, t, h, kv, d, mq)
        rows = mq * (h // kv)
        plans = [chosen] + ([A.decode_attn_plan(sp, rows, t, d)
                             for sp in range(1, A.MAX_SPLITS + 1)
                             if sp != chosen.splits] if every_split else [])
        plans = [p for p in plans if p.smem <= A.SMEM_LIMIT]
        lives = [x for x in ATTN_LIVE if x <= t - mq + 1] + [t - mq + 1]
        worst = (0, 0.0)
        for plan in plans:
            for valid in lives + [per_seq]:
                for rounding, merged in (("trunc", True), ("nearest", False)):
                    got = A.decode_attention_flat(q, k, v, valid,
                                                  rounding=rounding,
                                                  merged=merged, plan=plan,
                                                  **kw)
                    want = A.decode_attention_flat(q, k, v, valid,
                                                   backend="xla",
                                                   rounding=rounding, **kw)
                    torch.cuda.synchronize()
                    mx, share = contract(torch, got, want)
                    worst = max(worst, (mx, share))
                    if mx > 1 or share > 0.002:
                        fail(f"decode attention kernel != plain at T={t} "
                             f"H={h} Hkv={kv} mq={mq} window={window} "
                             f"softcap={softcap} {plan} valid="
                             f"{valid if isinstance(valid, int) else 'per-seq'}"
                             f" {rounding}: max {mx}, share {share}")
        err["decode_attn_flat"] = max(err["decode_attn_flat"], worst[0])
        log(json.dumps({"phase": "attn_kernel_vs_plain", "B": b, "T": t,
                        "H": h, "Hkv": kv, "D": d, "mq": mq,
                        "window": window, "softcap": softcap,
                        "valid": lives + ["per-seq"],
                        "plan": chosen._asdict(),
                        "splits_checked": [p.splits for p in plans],
                        "max_abs_err": worst[0],
                        "share_differing": worst[1]}))
    return err


# -- phase 8: the 4-bit kernels against their plain versions ----------------

def w4_case(torch, W, gen, m, k, n, group, dev, vector_mult=False,
            weight_only=False, wide=False):
    """Random operands of a 4-bit GEMM: N(0, 0.02) weights packed with the
    MSE scale search (the config's default), f32 N(0, 1) activations for B5
    (``wide``: magnitudes 2^U(-60, 60), random signs) or u8 codes whose
    output grid puts the results mid-range for B6/B7 (``vector_mult``: one
    mult per column, as a merged call has)."""
    w = torch.randn((n, k), generator=gen, device=dev) * 0.02
    packed, scales = W.pack_w4(w, group, optimize=True)
    bias = torch.randn((n,), generator=gen, device=dev) * 0.01
    if weight_only:
        x = torch.randn((m, k), generator=gen, device=dev)
        if wide:
            e = torch.rand((m, k), generator=gen, device=dev) * 120 - 60
            x = torch.sign(x) * torch.exp2(e)
        return dict(x=x, packed=packed, scales=scales, bias=bias, k=k,
                    group=group)
    x = torch.randint(0, 256, (m, k), generator=gen, dtype=torch.uint8,
                      device=dev)
    s_x, zp_x = 0.02, 117
    s_out = float(np.float32(s_x * 74.0 * 0.02 * math.sqrt(k) / 40.0))
    mult = float(np.float32(s_x) / np.float32(s_out))
    if vector_mult:
        mult = mult * (1.0 + 0.3 * torch.rand((n,), generator=gen,
                                               device=dev))
    zpb = torch.full((), 128.0, device=dev) + bias / torch.full(
        (), s_out, device=dev)
    ops = W.w4a8_operands(packed, scales, zpb, k, group, zp_x=zp_x,
                          mult=mult)
    return dict(x=x, ops=ops)


def v2_plain(W, x, ops, rounding="trunc"):
    """B6's plain version on a wrapper's operands."""
    return W.w4a8_v2_plain(x, ops["packed"], ops["scales_t"], ops["mult_v"],
                           ops["zpb_eff"], ops["k"], ops["group"], rounding)


def v1_plain(W, x, ops, rounding="trunc"):
    """B7's plain version on a wrapper's operands."""
    return W.w4a8_v1_plain(x, ops["packed"], ops["scales"], ops["zpb"],
                           ops["k"], ops["group"], zp_x=ops["zp_x"],
                           mult=ops["mult_v"], rounding=rounding)


def rel_err(torch, got, want) -> float:
    """max |got - want| over the largest |want| (B5's contract)."""
    return float((got - want).abs().max() / want.abs().max())


def check_b7(torch, W, b7, x, ops, rounding, what):
    """B7 (the wrapper ``b7``) on the card, bit for bit B6's plain
    arithmetic and within the code contract of its own plain version;
    returns (codes, max, share) of the latter."""
    got = b7(x, ops, rounding)
    exact = v2_plain(W, x, ops, rounding)
    mx, share = contract(torch, got, v1_plain(W, x, ops, rounding))
    if not torch.equal(got, exact):
        fail(f"B7 {what} {rounding}: {int((got != exact).sum())} codes "
             f"differ from w4a8_v2_plain")
    if mx > 1 or share > 0.002:
        fail(f"B7 {what} {rounding}: max {mx}, share {share} against "
             f"w4a8_v1_plain")
    return got, mx, share


def w4_plan(plan):
    """B6's plan, as printed in the per-shape lines."""
    return dict(tile=list(plan.tile), orientation=plan.orientation,
                slices=plan.slices, k_slice=plan.k_slice)


# groups off the 32-value k-step (a boundary inside a chunk, several groups
# in one chunk, a short last group), M = 1: B5 and B7 alike
W4_EDGE = [("edge", 16, 96, 40, 48), ("edge", 5, 200, 40, 48),
           ("edge", 3, 40, 24, 10), ("edge", 1, 768, 1024, 256)]


def check_w4_kernels(torch, W, gen, dev):
    """B6 exactly, B7 exactly against B6's plain arithmetic and within the
    code contract of its own, B5 within W4_RTOL of the largest |output|, at
    every shape the llama legs launch and at ragged and edge ones; returns
    {kernel: max |difference|}."""
    err = {"w4a8_v2_gemm": 0, "w4a8_v1_gemm": 0, "w4_gemm": 0.0}
    v2_cases = [(name, m, k, n, 256, name in ("qkv", "gate+up"))
                for name, m, k, n, _ in W4_DECODE + W4_DECODE_M]
    v2_cases += [("ragged", 16, 96, 70, 32, False),
                 ("ragged", 64, 768, 768, 128, True),
                 ("ragged", 24, 256, 200, 32, True)]
    for name, m, k, n, group, vec in v2_cases:
        c = w4_case(torch, W, gen, m, k, n, group, dev, vector_mult=vec)
        chosen = W.plan_w4a8_v2(m, n, k, group, sms=W.sm_count(dev))
        # the planner's plan, and its tile at every K split the kernel runs
        plans = [chosen] + [chosen._replace(slices=sl, k_slice=k // sl)
                            for sl in W.v2_slice_counts(k, group)
                            if sl != chosen.slices]
        for plan in plans:
            for rounding in ("trunc", "nearest"):
                got = W.w4a8_v2(c["x"], c["ops"], rounding, plan=plan)
                want = v2_plain(W, c["x"], c["ops"], rounding)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"B6 kernel != plain at {name} M={m} K={k} N={n} "
                         f"group={group} {plan} {rounding}: "
                         f"{int((got != want).sum())} codes differ")
        log(json.dumps({"phase": "w4a8_v2_kernel_vs_plain", "layer": name,
                        "M": m, "K": k, "N": n, "group": group,
                        "per_column_mult": vec, "plan": w4_plan(chosen),
                        "slices_checked": sorted(p.slices for p in plans),
                        "max_abs_err": 0,
                        "distinct_codes": int(torch.unique(want).numel())}))

    v1_cases = [(name, m, k, n, 256, vec)
                for name, m, k, n, _, vec in W4_PREFILL]
    v1_cases += [(name, m, k, n, 256, not vec)
                 for name, m, k, n, _, vec in W4_PREFILL if name != "head"]
    v1_cases += [("ragged", 37, 200, 61, 128, True),
                 ("ragged", 1, 48, 130, 256, False),
                 ("ragged", 300, 768, 17, 256, True)]
    v1_cases += [(*e, True) for e in W4_EDGE]
    for name, m, k, n, group, vec in v1_cases:
        c = w4_case(torch, W, gen, m, k, n, group, dev, vector_mult=vec)
        worst = (0, 0.0)
        for rounding in ("trunc", "nearest"):
            got, mx, share = check_b7(
                torch, W, W.w4a8_v1, c["x"], c["ops"], rounding,
                f"at {name} M={m} K={k} N={n} group={group}")
            worst = max(worst, (mx, share))
        err["w4a8_v1_gemm"] = max(err["w4a8_v1_gemm"], worst[0])
        log(json.dumps({"phase": "w4a8_v1_kernel_vs_plain", "layer": name,
                        "M": m, "K": k, "N": n, "group": group,
                        "per_column_mult": vec, "equal_to_v2_plain": True,
                        "max_abs_err_vs_v1_plain": worst[0],
                        "share_differing_vs_v1_plain": worst[1],
                        "distinct_codes": int(torch.unique(got).numel())}))

    b5_cases = [(name, m, k, n, 128, False)
                for name, m, k, n, _ in W4_FORWARD]
    b5_cases += [("ragged", 37, 200, 61, 128, False),
                 ("ragged", 1, 48, 130, 128, False)]
    b5_cases += [(*e, False) for e in W4_EDGE]
    b5_cases += [("wide range", 512, 768, 768, 128, True)]
    for name, m, k, n, group, wide in b5_cases:
        c = w4_case(torch, W, gen, m, k, n, group, dev, weight_only=True,
                    wide=wide)
        args = (c["x"], c["packed"], c["scales"], c["bias"], k, group)
        got, want = W.w4_gemm(*args), W.w4_gemm_plain(*args)
        torch.cuda.synchronize()
        rel = rel_err(torch, got, want)
        err["w4_gemm"] = max(err["w4_gemm"],
                             float((got - want).abs().max()))
        if not rel <= W4_RTOL:
            fail(f"B5 kernel != plain at {name} M={m} K={k} N={n}: "
                 f"{rel} of the largest |output|")
        log(json.dumps({"phase": "w4_gemm_kernel_vs_plain", "layer": name,
                        "M": m, "K": k, "N": n, "group": group,
                        "x": "2^-60..2^60" if wide else "N(0, 1)",
                        "max_err_rel_to_max": rel}))
    return err


def engine_prefill_ms():
    """M = n x bucket of every batched prefill that the engine phases'
    GenerationEngines (8 slots) can run for their prompt lengths: each
    prompt's power-of-two bucket (``serve.generation._bucket``), n a power
    of two up to the slots (the engine's grouping)."""
    from int8inferenceengine_tpu_torch.serve.generation import _bucket
    lens = set(SERVE_PROMPTS) | {SERVE_LOAD[1], BENCH_ENGINE_LOAD[1]}
    buckets = {min(_bucket(t), GPT["max_len"]) for t in lens}
    slots = max(SERVE["slots"], BENCH_ENGINE["slots"])
    ns = [1 << i for i in range(slots.bit_length())]
    return sorted({n * b for b in buckets for n in ns})


def check_engine_prefill_kernels(torch, G, W, gen, dev):
    """The kernels at the engines' batched prefill shapes (M from
    ``engine_prefill_ms``): B1 at the gpt2 Linears (exact; the gelu
    epilogue within 1 code on 0.2%) and B2 at its merged QKV (exact); at
    the llama W4A8 Linears (group 256) the kernel that the W4A8 dispatch
    picks, B6 exactly or B7 as ``check_b7`` holds it; both roundings.
    Returns {kernel: max |code difference|}."""
    err = dict.fromkeys(("qgemm_u8s8", "qgemm_u8s8_vzp", "w4a8_v2_gemm",
                         "w4a8_v1_gemm"), 0)
    group = LLAMA_W4A8["w4_group"]
    for m in engine_prefill_ms():
        on = {"b6": [], "b7": []}
        for name, _, k, n, _, act in DEC_GEMMS:
            c = gemm_case(torch, gen, m, k, n, dev)
            oc = G.compute_offset(c["q_bias"], rowsum(torch, c["w"]),
                                  c["s_a"], c["zp_a"], recentered=True)
            # an act epilogue: scale s_w and s_c alike (act_kernel_vs_plain)
            f = 5.0 / (110 * c["s_c"]) if act else 1.0
            ep = G.epilogue_vector(c["s_a"], c["s_w_pc"] * f, c["s_c"] * f,
                                   n, dev, "gemm")
            for rounding in ("trunc", "nearest"):
                kw = dict(scale_a=c["s_a"], scale_c=c["s_c"] * f,
                          zp_c=c["zp_c"], rounding=rounding,
                          act=act_grid(act) if act else None)
                got = G.qgemm(c["a"], c["w"], oc, ep, **kw)
                want = G.qgemm_plain(c["a"], c["w"], oc, ep, **kw)
                torch.cuda.synchronize()
                mx, share = contract(torch, got, want)
                err["qgemm_u8s8"] = max(err["qgemm_u8s8"], mx)
                if (act is None and mx) or mx > 1 or share > 0.002:
                    fail(f"engine prefill B1 {name} kernel != plain at M={m} "
                         f"K={k} N={n} {rounding}: max {mx}, share {share}")
        _, k, n, _ = DEC_QKV
        parts = []
        for i in range(3):
            c = gemm_case(torch, gen, m, k, n, dev)
            parts.append(dict(w_s8_nk=c["w"], q_bias=c["q_bias"],
                              rowsum=rowsum(torch, c["w"]),
                              scale_w=c["s_w_pc"] if i == 1 else 0.01,
                              scale_c=c["s_c"] * (1 + 0.3 * i),
                              zp_c=100 + 20 * i))
        merged = G.merge_parts(parts, scale_a=c["s_a"], zp_a=c["zp_a"])
        for rounding in ("trunc", "nearest"):
            got = torch.cat(G.qgemm_multi(c["a"], merged, rounding=rounding),
                            1)
            want = torch.cat(G.qgemm_multi_plain(c["a"], merged,
                                                 rounding=rounding), 1)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"engine prefill B2 kernel != plain at M={m}: "
                     f"{int((got != want).sum())} codes differ")
        for name, _, k, n, _ in W4_DECODE:
            c = w4_case(torch, W, gen, m, k, n, group, dev,
                        vector_mult=name in ("qkv", "gate+up"))
            b6 = W.use_v2(m, k, group, k // group)
            on["b6" if b6 else "b7"].append(name)
            for rounding in ("trunc", "nearest"):
                if b6:
                    got = W.w4a8_v2(c["x"], c["ops"], rounding)
                    want = v2_plain(W, c["x"], c["ops"], rounding)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        fail(f"engine prefill B6 {name} kernel != plain at "
                             f"M={m} K={k} N={n} {rounding}: "
                             f"{int((got != want).sum())} codes differ")
                else:
                    _, mx, _ = check_b7(
                        torch, W, W.w4a8_v1, c["x"], c["ops"], rounding,
                        f"engine prefill {name} at M={m} K={k} N={n}")
                    err["w4a8_v1_gemm"] = max(err["w4a8_v1_gemm"], mx)
        log(json.dumps({"phase": "engine_prefill_kernels_vs_plain", "M": m,
                        "gpt2": {"b1": [g[0] for g in DEC_GEMMS],
                                 "b2": "qkv",
                                 "b1_plans": {g[0]: plan_of(G, m, g[3], g[2],
                                                            dev)
                                              for g in DEC_GEMMS}},
                        "llama_w4a8": on,
                        "max_abs_err_so_far": dict(err)}))
    return err


@contextlib.contextmanager
def swapped(module, **fns):
    """Replace module-level functions while the block runs (a harness swap:
    the layers call them by their module attribute).  A kernel wrapper adds
    to the counter of the name it is bound to, so while the swap lasts its
    launches go to the stand-in, never to the counts of the main path."""
    old = {name: getattr(module, name) for name in fns}
    for name, fn in fns.items():
        fn.launches = fn.merged_launches = 0
        setattr(module, name, fn)
    try:
        yield
    finally:
        for name, fn in old.items():
            setattr(module, name, fn)


def replaying(torch, W, stats):
    """Stand-ins for the three 4-bit wrappers that launch the kernel and
    then run its plain version on the same operands, holding each launch to
    its contract and adding to ``stats``."""
    v2, v1, b5 = W.w4a8_v2, W.w4a8_v1, W.w4_gemm

    def note(kernel, value, share=0.0):
        s = stats.setdefault(kernel, {"launches": 0, "max_abs_err": 0,
                                      "max_share_differing": 0.0})
        s["launches"] += 1
        s["max_abs_err"] = max(s["max_abs_err"], value)
        s["max_share_differing"] = max(s["max_share_differing"], share)

    def r_v2(x, ops, rounding="trunc"):
        got = v2(x, ops, rounding)
        want = v2_plain(W, x, ops, rounding)
        mx, share = contract(torch, got, want)
        note("w4a8_v2_gemm", mx, share)
        if mx:
            fail(f"replayed B6 launch at M={x.shape[0]} K={ops['k']} N="
                 f"{got.shape[1]}: {share} of the codes differ, max {mx}")
        return got

    def r_v1(x, ops, rounding="trunc"):
        got, mx, share = check_b7(
            torch, W, v1, x, ops, rounding,
            f"replayed launch at M={x.shape[0]} K={ops['k']} N="
            f"{ops['packed'].shape[0]}")
        note("w4a8_v1_gemm", mx, share)
        return got

    def r_b5(x, packed, scales, bias, k, group=128):
        got = b5(x, packed, scales, bias, k, group)
        rel = rel_err(torch, got, W.w4_gemm_plain(x, packed, scales, bias, k,
                                                  group))
        note("w4_gemm", rel)
        if not rel <= W4_RTOL:
            fail(f"replayed B5 launch at M={x.shape[0]} K={k} N="
                 f"{got.shape[1]}: {rel} of the largest |output|")
        return got

    return dict(w4a8_v2=r_v2, w4a8_v1=r_v1, w4_gemm=r_b5)


def plain_w4(W):
    """Stand-ins for the three 4-bit wrappers that run their plain versions
    on the card."""
    return dict(w4a8_v2=lambda x, ops, rounding="trunc":
                v2_plain(W, x, ops, rounding),
                w4a8_v1=lambda x, ops, rounding="trunc":
                v1_plain(W, x, ops, rounding),
                w4_gemm=lambda *args: W.w4_gemm_plain(*args))


def plain_attn(A):
    """A stand-in for the decode attention wrapper that runs its plain
    version on the card."""
    attn = A.decode_attention_flat

    def p_attn(*args, **kw):
        return attn(*args, **dict(kw, backend="xla"))

    return dict(decode_attention_flat=p_attn)


# -- phase 5: the AlexNet main path -----------------------------------------

def alexnet_main_path(torch, q, zoo, kernel_fns, dev):
    """The AlexNet-224 b100 lifecycle; returns (INT8 model, FP32 input,
    state, launches by kernel)."""
    from int8inferenceengine_tpu_torch.carry import (export_state,
                                                     load_jax_state)
    batch = 100
    twin = zoo.torch_twin("alexnet")
    state = alexnet_state(torch, twin, seed=0)
    twin.load_state_dict(state)
    twin = twin.to(dev).eval()
    rng = np.random.default_rng(0)
    x_calib = rng.standard_normal((batch, 3, 224, 224)).astype(np.float32)
    x_test = rng.standard_normal((batch, 3, 224, 224)).astype(np.float32)

    # the launch count covers the whole lifecycle: load, FP32 forward,
    # calibration, convert (none of which launch a kernel) and one INT8
    # forward (one launch per layer)
    reset_counts(kernel_fns)
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
    counts = read_counts(kernel_fns)
    if counts != dict.fromkeys(kernel_fns, 0) | {"qgemm_u8s8": 8}:
        fail(f"INT8 AlexNet forward launched {counts}, want 8 qgemm_u8s8 "
             f"and nothing else")
    if tuple(out.shape) != (batch, 10) or not bool(torch.isfinite(out).all()):
        fail(f"INT8 output shape {tuple(out.shape)} or non-finite values")
    top1 = float((out.argmax(1) == ref.argmax(1)).float().mean())
    log(json.dumps({"phase": "int8_forward", "launches": counts,
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
    return model, x_test, state, counts


def alexnet_timing(torch, q, zoo, model, x_test, state, profile):
    xt = q.tensor(x_test)
    batch = x_test.shape[0]
    int8_ms = time_cuda(torch, lambda: model(xt), iters=20)
    fp_model = zoo.AlexNet(device="cuda")
    fp_model.load(state)
    fp32_ms = time_cuda(torch, lambda: fp_model(xt), iters=20)
    log(json.dumps({"model": "alexnet_cifar10_224", "batch": batch,
                    "int8_ms_per_batch": int8_ms,
                    "int8_images_per_s": batch * 1e3 / int8_ms,
                    "fp32_ms_per_batch": fp32_ms,
                    "fp32_images_per_s": batch * 1e3 / fp32_ms}))
    if not profile:
        return
    from torch.profiler import ProfilerActivity, profile as torch_profile
    reps = 5
    for name, net in (("int8", model), ("fp32", fp_model)):
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                net(xt)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6 / reps
        rows = profile_rows(torch, prof)
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


# -- phase 6: the decoders on the card against a CPU copy --------------------

def decoder_vs_cpu(torch, q, zoo, TD, LL, family: str, dev, batch=SMALL_BATCH,
                   **geo):
    """One small decoder of ``family`` ('gpt2' or 'llama_w4a8', with its
    main path's QuantConfig) calibrated and converted on ``dev``, and a CPU
    copy of its converted state (``export_state`` -> ``load_jax_state``):
    the prefill's logit codes at every prompt position, greedy tokens, and
    ``SMALL_STEPS`` decode steps teacher-forced on the card's tokens.
    Returns one result dict per leg, each with ``ok`` under the contract
    (at most CPU_MAX_CODE codes off on at most CPU_MAX_SHARE of them)."""
    from int8inferenceengine_tpu_torch.carry import (export_state,
                                                     load_jax_state)
    from int8inferenceengine_tpu_torch.tensor import Tensor
    geo = dict(SMALL_DEC, **geo)
    if family == "gpt2":
        name, cfg, residual = "gpt_tiny", {}, ("proj", "fc2")
        twin = TD.torch_text_decoder(**geo, seed=0)
    else:
        geo.setdefault("kv_heads", 2)
        name, cfg, residual = "llama_tiny", LLAMA_W4A8, ("proj", "down")
        twin = LL.torch_llama(**geo, seed=0)
    state = decoder_state(torch, twin, geo["depth"], seed=2,
                          residual=residual)
    ids = np.random.default_rng(2).integers(
        0, geo["vocab_size"], (batch, SMALL_PROMPT)).astype(np.int32)
    model = zoo.build(name, config=q.QuantConfig(**cfg), device=dev, **geo)
    model.load(state)
    model.prepare()
    model(q.tensor(ids, device=dev))
    model.convert()
    cpu = zoo.build(name, config=q.QuantConfig(**cfg), device="cpu", **geo)
    load_jax_state(cpu, export_state(model))

    legs = []

    def leg(what, got, want):
        mx, share = contract(torch, got.cpu(), want.cpu())
        legs.append({"phase": "decoder_card_vs_cpu", "family": family,
                     "leg": what, "batch": batch, **geo,
                     "codes": int(want.numel()), "max_abs_err": mx,
                     "share_differing": share,
                     "ok": mx <= CPU_MAX_CODE and share <= CPU_MAX_SHARE})

    prompt = torch.tensor(ids, dtype=torch.int64)
    with torch.no_grad():
        leg("prefill", model.forward(Tensor(prompt.to(dev))).data,
            cpu.forward(Tensor(prompt)).data)
    tokens = model.generate(ids, SMALL_STEPS)
    tokens_cpu = cpu.generate(ids, SMALL_STEPS)
    toks = torch.tensor(tokens, dtype=torch.int64)
    leg("teacher_forced_decode",
        teacher_forced(torch, model, prompt.to(dev), toks.to(dev)),
        teacher_forced(torch, cpu, prompt, toks))
    same = bool(np.array_equal(tokens, tokens_cpu))
    legs.append({"phase": "decoder_card_vs_cpu", "family": family,
                 "leg": "greedy_tokens", "batch": batch,
                 "steps": SMALL_STEPS, "equal": same,
                 "first_step_apart": None if same else int(
                     np.argwhere((tokens != tokens_cpu).any(0))[0, 0]),
                 "ok": same})
    return legs


def decoders_vs_cpu(torch, q, zoo, TD, LL, dev):
    """The gate of the decoders' card codes against the CPU: both families
    at their small size (``CPU_GATE_LEGS``); every leg is printed before any
    failure."""
    legs = []
    for family, batch, extra, gated in CPU_GATE_LEGS:
        for r in decoder_vs_cpu(torch, q, zoo, TD, LL, family, dev,
                                batch=batch, **extra):
            legs.append(dict(r, gated=gated))
    for r in legs:
        log(json.dumps(r))
    bad = [f"{r['family']} b{r['batch']} {r['leg']}" for r in legs
           if r["gated"] and not r["ok"]]
    if bad:
        fail(f"decoder codes on the card differ from a CPU copy's beyond "
             f"the contract: {bad}")
    return legs


# -- phase 7: the decoder main path -----------------------------------------

def decode_from(torch, model, cache, t0: int, tokens):
    """The u8 logit codes [B, S, V] of decode steps fed ``tokens`` [B, S] one
    at a time from position ``t0`` through ``cache`` (updated in place)."""
    out = []
    with torch.no_grad():
        pos = torch.full((), t0, dtype=torch.int64, device=tokens.device)
        for s in range(tokens.shape[1]):
            codes, cache = model._decode_step(cache, pos, tokens[:, s])
            out.append(codes)
            pos = pos + 1
    return torch.stack(out, 1)


def teacher_forced(torch, model, prompt, tokens):
    """The u8 logit codes [B, steps, V] of ``model`` fed the prompt and then
    ``tokens`` [B, steps] one step at a time through its KV cache."""
    from int8inferenceengine_tpu_torch.tensor import Tensor
    with torch.no_grad():
        codes, cache = model._prefill(Tensor(prompt))
    return torch.cat([codes[:, None],
                      decode_from(torch, model, cache, prompt.shape[1],
                                  tokens[:, :-1])], 1)


def decoder_main_path(torch, q, zoo, TD, kernel_fns, dev):
    """The gpt2-small-ish lifecycle and greedy generate; returns (INT8
    model, prompt ids, launches by kernel)."""
    from int8inferenceengine_tpu_torch.carry import (export_state,
                                                     load_jax_state)
    twin = TD.torch_text_decoder(**GPT, seed=0)
    state = decoder_state(torch, twin, GPT["depth"], seed=0)
    twin.load_state_dict(state)
    twin = twin.to(dev).eval()
    ids = np.random.default_rng(0).integers(
        0, GPT["vocab_size"], (DEC_BATCH, DEC_PROMPT)).astype(np.int32)

    reset_counts(kernel_fns)
    t0 = time.perf_counter()
    model = zoo.build("gpt_tiny", **GPT)
    model.load(state)
    fp32 = model(q.tensor(ids)).data
    with torch.no_grad():
        ref = twin(torch.tensor(ids, dtype=torch.int64, device=dev))
    scale = float(ref.abs().max())
    fp_err = float((fp32 - ref).abs().max()) / scale
    if tuple(fp32.shape) != (DEC_BATCH, DEC_PROMPT, GPT["vocab_size"]) or \
            not torch.allclose(fp32, ref, rtol=1e-4, atol=1e-4 * scale):
        fail(f"FP32 decoder differs from its torch twin: shape "
             f"{tuple(fp32.shape)}, max error {fp_err} of max |logit|")
    log(json.dumps({"phase": "decoder_fp32_vs_twin",
                    "max_err_rel_to_max": fp_err}))
    del twin, ref, fp32

    model.prepare()
    model(q.tensor(ids))
    model.convert()
    torch.cuda.synchronize()
    lifecycle_s = time.perf_counter() - t0
    tokens = model.generate(ids, DEC_STEPS)
    torch.cuda.synchronize()
    counts = read_counts(kernel_fns)
    # the prefill runs 37 B1 and one B2 per block; it takes the first
    # token, and each of the DEC_STEPS - 1 decode steps after it runs 37
    # B1, one B2 and one B3 per block
    depth = GPT["depth"]
    per_step = dict.fromkeys(kernel_fns, 0) | {
        "qgemm_u8s8": 3 * depth + 1, "qgemm_u8s8_vzp": depth,
        "decode_attn_flat": depth}
    prefill = dict(per_step, decode_attn_flat=0)
    check_captured_launches(torch, "decoder", counts, model, ids, prefill,
                            per_step, kernel_fns)
    if tokens.shape != (DEC_BATCH, DEC_STEPS) or tokens.dtype != np.int32 \
            or tokens.min() < 0 or tokens.max() >= GPT["vocab_size"]:
        fail(f"generate returned {tokens.dtype} {tokens.shape} in "
             f"[{tokens.min()}, {tokens.max()}]")
    log(json.dumps({"phase": "decoder_generate", "steps": DEC_STEPS,
                    "launches": counts,
                    "launches_per_decode_step": per_step,
                    "prepare_calibrate_convert_s": round(lifecycle_s, 3),
                    "distinct_tokens": int(np.unique(tokens).size)}))

    # the same converted state on the plain path (every kernel's plain
    # version), on the card, teacher-forced on the kernel path's tokens
    plain_cfg = q.QuantConfig(kernel_backend="xla", fuse_qkv="xla",
                              decode_attention="xla")
    plain = zoo.build("gpt_tiny", config=plain_cfg, **GPT)
    load_jax_state(plain, export_state(model))
    prompt = torch.tensor(ids, dtype=torch.int64, device=dev)
    toks = torch.tensor(tokens, dtype=torch.int64, device=dev)
    got = teacher_forced(torch, model, prompt, toks)
    want_codes = teacher_forced(torch, plain, prompt, toks)
    if not torch.equal(got.argmax(-1), toks):
        fail("the kernel path's teacher-forced argmax differs from the "
             "tokens its generate() returned")
    mx, share = contract(torch, got, want_codes)
    differs = (want_codes.argmax(-1) != toks).any(0).nonzero()
    first = int(differs[0]) if differs.numel() else None
    log(json.dumps({"phase": "decoder_kernel_vs_plain_path",
                    "codes": int(got.numel()), "max_abs_err": mx,
                    "share_differing": share,
                    "first_step_with_other_greedy_token": first,
                    "limits": {"max": MAX_CODE_DIFF,
                               "share": MAX_SHARE_DIFF}}))
    if mx > MAX_CODE_DIFF or share > MAX_SHARE_DIFF:
        fail(f"decoder codes, kernel path vs plain path: max {mx}, share "
             f"{share}")
    del plain, got, want_codes
    captured_vs_eager(torch, model, ids, tokens, "decoder")
    return model, ids, counts


# -- phases 9 and 10: the llama legs ------------------------------------------

def llama_w4a8_main_path(torch, q, zoo, LL, W, A, kernel_fns, dev):
    """bench.py's W4A8 llama lifecycle and greedy generate; returns (INT8
    model, prompt ids, FP32 state, launches by kernel)."""
    from int8inferenceengine_tpu_torch.tensor import Tensor
    depth = LLAMA["depth"]
    twin = LL.torch_llama(**LLAMA, seed=0)
    state = decoder_state(torch, twin, depth, seed=0,
                          residual=("proj", "down"))
    twin.load_state_dict(state)
    twin = twin.to(dev).eval()
    ids = np.random.default_rng(0).integers(
        0, LLAMA["vocab_size"], (DEC_BATCH, DEC_PROMPT)).astype(np.int32)

    reset_counts(kernel_fns)
    t0 = time.perf_counter()
    model = zoo.build("llama_tiny", config=q.QuantConfig(**LLAMA_W4A8),
                      **LLAMA)
    model.load(state)
    fp32 = model(q.tensor(ids)).data
    with torch.no_grad():
        ref = twin(torch.tensor(ids, dtype=torch.int64, device=dev))
    fp_err = float((fp32 - ref).abs().max() / ref.abs().max())
    if tuple(fp32.shape) != (DEC_BATCH, DEC_PROMPT, LLAMA["vocab_size"]) \
            or not fp_err <= 1e-4:
        fail(f"FP32 llama differs from its torch twin: shape "
             f"{tuple(fp32.shape)}, max error {fp_err} of max |logit|")
    log(json.dumps({"phase": "llama_fp32_vs_twin",
                    "max_err_rel_to_max": fp_err}))
    del twin, ref, fp32

    model.prepare()
    model(q.tensor(ids))
    model.convert()
    torch.cuda.synchronize()
    lifecycle_s = time.perf_counter() - t0
    tokens = model.generate(ids, DEC_STEPS)
    torch.cuda.synchronize()
    counts = read_counts(kernel_fns)
    merged = W.w4a8_v1.merged_launches
    # the prefill (M = 512, over B6's envelope) runs B7: proj, down and
    # the head alone, qkv and gate+up merged; each of the DEC_STEPS - 1
    # decode steps runs B6 at all 4 * depth + 1 Linears and B3 per block
    per_step = dict.fromkeys(kernel_fns, 0) | {
        "w4a8_v2_gemm": 4 * depth + 1, "decode_attn_flat": depth}
    prefill = dict.fromkeys(kernel_fns, 0) | {"w4a8_v1_gemm": 4 * depth + 1}
    check_captured_launches(torch, "llama W4A8", counts, model, ids,
                            prefill, per_step, kernel_fns)
    if merged != 2 * depth:
        fail(f"llama W4A8 prefill: {merged} merged B7, want {2 * depth}")
    if tokens.shape != (DEC_BATCH, DEC_STEPS) or tokens.dtype != np.int32 \
            or tokens.min() < 0 or tokens.max() >= LLAMA["vocab_size"]:
        fail(f"generate returned {tokens.dtype} {tokens.shape} in "
             f"[{tokens.min()}, {tokens.max()}]")
    log(json.dumps({"phase": "llama_w4a8_generate", "steps": DEC_STEPS,
                    "launches": counts,
                    "launches_per_decode_step": {
                        k: v for k, v in per_step.items() if v},
                    "prefill_launches": {
                        "w4a8_v1_gemm single-layer": 4 * depth + 1 - merged,
                        "w4a8_v1_gemm merged": merged},
                    "prepare_calibrate_convert_s": round(lifecycle_s, 3),
                    "distinct_tokens": int(np.unique(tokens).size)}))

    # (b) every W4 launch of the prefill and of 16 decode steps, replayed
    prompt = torch.tensor(ids, dtype=torch.int64, device=dev)
    toks = torch.tensor(tokens, dtype=torch.int64, device=dev)
    stats = {}
    with swapped(W, **replaying(torch, W, stats)):
        teacher_forced(torch, model, prompt, toks[:, :DEC_SHORT + 1])
    replayed = {"w4a8_v1_gemm": 4 * depth + 1,
                "w4a8_v2_gemm": DEC_SHORT * (4 * depth + 1)}
    if {k: s["launches"] for k, s in stats.items()} != replayed:
        fail(f"replayed {stats}, want {replayed} launches")
    log(json.dumps({"phase": "llama_w4a8_replayed_launches", "stats": stats,
                    "contract": {"w4a8_v2_gemm": "exact",
                                 "w4a8_v1_gemm": "equal to w4a8_v2_plain; "
                                 "<=1 code on <=0.2% of w4a8_v1_plain"}}))

    # (c) one shared prefill cache, 128 teacher-forced decode steps on the
    # kernel path and on the plain path (harness swap, same model)
    with torch.no_grad():
        codes0, cache = model._prefill(Tensor(prompt))
    cache_plain = {i: (k.clone(), v.clone()) for i, (k, v) in cache.items()}
    got = decode_from(torch, model, cache, DEC_PROMPT, toks)
    if not torch.equal(codes0.argmax(-1), toks[:, 0]) or \
            not torch.equal(got[:, :-1].argmax(-1), toks[:, 1:]):
        fail("the kernel path's teacher-forced argmax differs from the "
             "tokens its generate() returned")
    with swapped(W, **plain_w4(W)), swapped(A, **plain_attn(A)):
        want_codes = decode_from(torch, model, cache_plain, DEC_PROMPT, toks)
        with torch.no_grad():
            prefill_plain = model.forward(Tensor(prompt)).data
    mx, share = contract(torch, got, want_codes)
    log(json.dumps({"phase": "llama_w4a8_kernel_vs_plain_path",
                    "shared_prefill_cache": True,
                    "decode_steps": DEC_STEPS, "codes": int(got.numel()),
                    "max_abs_err": mx, "share_differing": share,
                    "limit": "equal"}))
    if mx:
        fail(f"llama W4A8 teacher-forced codes, kernel path vs plain path: "
             f"max {mx}, share {share}")
    # (d) the prefill run apart on each path: B7 sums in another order than
    # its f32 plain version and may move a code, which the plain path's
    # cache would carry on (recorded)
    with torch.no_grad():
        prefill_kernel = model.forward(Tensor(prompt)).data
    mx, share = contract(torch, prefill_kernel, prefill_plain)
    log(json.dumps({"phase": "llama_w4a8_prefill_kernel_vs_plain",
                    "codes": int(prefill_kernel.numel()), "max_abs_err": mx,
                    "share_differing": share, "gated": False}))
    del got, want_codes, prefill_plain, prefill_kernel, cache, cache_plain
    captured_vs_eager(torch, model, ids, tokens, "llama_w4a8")
    return model, ids, state, counts


def llama_w4_forward_path(torch, q, zoo, W, kernel_fns, state, ids):
    """The W4 weight-only llama forward on the same weights and prompt;
    returns (model, launches by kernel)."""
    depth = LLAMA["depth"]
    reset_counts(kernel_fns)
    model = zoo.build("llama_tiny", config=q.QuantConfig(**LLAMA_W4),
                      **LLAMA)
    model.load(state)
    model.convert()                    # weight-only: no calibration pass
    xt = q.tensor(ids)
    out = model(xt).data
    torch.cuda.synchronize()
    counts = read_counts(kernel_fns)
    want = dict.fromkeys(kernel_fns, 0) | {"w4_gemm": 7 * depth + 1}
    if counts != want:
        fail(f"weight-only llama forward launched {counts}, want {want}")
    if tuple(out.shape) != (DEC_BATCH, DEC_PROMPT, LLAMA["vocab_size"]) or \
            out.dtype != torch.float32 or not bool(torch.isfinite(out).all()):
        fail(f"weight-only output {out.dtype} {tuple(out.shape)} or "
             f"non-finite values")
    stats = {}
    with swapped(W, **replaying(torch, W, stats)):
        model(xt)
    if stats["w4_gemm"]["launches"] != 7 * depth + 1:
        fail(f"replayed {stats}, want {7 * depth + 1} B5 launches")
    with swapped(W, **plain_w4(W)):
        plain = model(xt).data
    rel = rel_err(torch, out, plain)
    log(json.dumps({"phase": "llama_w4_forward", "launches": counts,
                    "replayed": stats, "max_err_rel_to_max_vs_plain": rel,
                    "limit": 1e-4}))
    if not rel <= 1e-4:
        fail(f"weight-only logits, kernel path vs plain path: {rel} of the "
             f"largest |logit|")
    return model, counts


def llama_w4_timing(torch, q, model, ids, profile):
    xt = q.tensor(ids)
    ms = time_cuda(torch, lambda: model(xt), iters=5)
    log(json.dumps({"model": "llama_w4_weight_only_forward",
                    "batch": DEC_BATCH, "prompt": DEC_PROMPT,
                    "ms_per_forward": ms,
                    "tokens_per_s": DEC_BATCH * DEC_PROMPT * 1e3 / ms}))
    if profile:
        profile_forward(torch, lambda: model(xt),
                        "llama_w4_weight_only_forward")


def full_context_timing(torch, q, model, label, kernel_fns):
    """One forward over FULL_CONTEXT tokens (the model's max_len): its
    launches by kernel and its ms (CUDA events, 3 runs); recorded, not
    gated."""
    ids = np.random.default_rng(1).integers(
        0, model.vocab_size, FULL_CONTEXT).astype(np.int32)
    xt = q.tensor(ids)
    reset_counts(kernel_fns)
    out = model(xt).data
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_counts(kernel_fns).items() if v}
    if tuple(out.shape) != (*FULL_CONTEXT, model.vocab_size) or \
            not bool(torch.isfinite(out.to(torch.float32)).all()):
        fail(f"{label}: output {out.dtype} {tuple(out.shape)} or "
             f"non-finite values")
    del out
    ms = time_cuda(torch, lambda: model(xt), iters=3)
    tokens = FULL_CONTEXT[0] * FULL_CONTEXT[1]
    log(json.dumps({"model": label, "batch": FULL_CONTEXT[0],
                    "tokens_per_sequence": FULL_CONTEXT[1],
                    "ms_per_forward": ms, "tokens_per_s": tokens * 1e3 / ms,
                    "launches_per_forward": launches, "gated": False}))


def decoder_timing(torch, model, ids, profile, label="gpt2_small_ish_decode"):
    """Decode ms/step by bench.py's protocol, the prefill, and under
    ``profile`` the device time of decode steps by kernel."""
    from int8inferenceengine_tpu_torch.tensor import Tensor
    vocab = model.vocab_size
    times = {}
    for steps in (DEC_SHORT, DEC_STEPS):
        model.generate(ids, steps)
        best = float("inf")
        for trial in range(3):
            p2 = (ids + trial + 1) % vocab
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.generate(p2, steps)
            best = min(best, time.perf_counter() - t0)
        times[steps] = best
    per_step = (times[DEC_STEPS] - times[DEC_SHORT]) / (DEC_STEPS - DEC_SHORT)
    prompt = Tensor(torch.tensor(ids, dtype=torch.int64, device=model.device))
    with torch.no_grad():
        prefill_ms = time_cuda(torch, lambda: model._prefill(prompt), iters=5)
    eager_ms = time_eager_steps(torch, model, ids)
    res = {"model": label, "batch": DEC_BATCH,
           "prompt": DEC_PROMPT, "decode_ms_per_step": per_step * 1e3,
           "tokens_per_s": DEC_BATCH / per_step, "prefill_ms": prefill_ms,
           "eager_step_loop_ms_per_step": eager_ms,
           "generate_s": {str(k): v for k, v in times.items()},
           "protocol": f"(t(generate {DEC_STEPS}) - t(generate {DEC_SHORT}))"
                       f" / {DEC_STEPS - DEC_SHORT}, best of 3; generate() "
                       f"replays a captured step, the eager loop launches "
                       f"every kernel from Python"}
    log(json.dumps(res))
    if profile:
        profile_captured(torch, model, ids, label)
        profile_decode(torch, model, prompt, eager_ms * 1e3, label)
        profile_forward(torch, lambda: model._prefill(prompt),
                        f"{label}: prefill")
    return res


def kernel_of(name: str):
    """The port's kernel a profiler row belongs to, or None."""
    if "decode_attn_kernel" in name:
        return "decode_attn_flat"
    if "qgemm_kernel<" in name:
        # the template's last argument is the epilogue mode; 2 is B2's
        vzp = re.search(r"qgemm_kernel<[^>]*,\s*2>", name)
        return "qgemm_u8s8_vzp" if vzp else "qgemm_u8s8"
    if "w4a8_v2_kernel" in name:
        return "w4a8_v2_gemm"
    if "w4_tc_kernel" in name:
        # the first template argument is true for B7 (W4A8), false for B5
        b7 = re.search(r"w4_tc_kernel<(true|\(bool\)1)", name)
        return "w4a8_v1_gemm" if b7 else "w4_gemm"
    return None


def by_kernel(rows, reps):
    """{kernel: (us per rep, launches per rep)} of profiler rows."""
    out = {}
    for e in rows:
        k = kernel_of(e.key) or "other (eager glue)"
        us, n = out.get(k, (0.0, 0.0))
        out[k] = (us + e.self_device_time_total / reps, n + e.count / reps)
    return {k: {"us": us, "launches": n} for k, (us, n) in out.items()}


def profile_forward(torch, fn, label, reps=3):
    """The device time of ``fn`` by kernel under torch.profiler, and the
    device's idle share of the profiled wall time."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6 / reps
    rows = profile_rows(torch, prof)
    busy = sum(e.self_device_time_total for e in rows) / reps
    log(json.dumps({"profile": label, "wall_us_profiled": wall_us,
                    "device_busy_us": busy,
                    "device_idle_share_profiled": 1 - busy / wall_us,
                    "by_kernel": by_kernel(rows, reps),
                    "rows": [{"name": e.key[:90],
                              "us": e.self_device_time_total / reps,
                              "calls": e.count / reps} for e in rows[:20]]}))


def profile_decode(torch, model, prompt, step_us, label):
    from torch.profiler import ProfilerActivity, profile as torch_profile
    reps = 8
    with torch.no_grad():
        codes, cache = model._prefill(prompt)
        tok = codes.argmax(-1)
        pos = torch.full((), prompt.shape[1], dtype=torch.int64,
                         device=model.device)
        for _ in range(2):                       # warm
            codes, cache = model._decode_step(cache, pos, tok)
            tok, pos = codes.argmax(-1), pos + 1
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                codes, cache = model._decode_step(cache, pos, tok)
                tok, pos = codes.argmax(-1), pos + 1
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6 / reps
    rows = profile_rows(torch, prof)
    busy = sum(e.self_device_time_total for e in rows) / reps
    log(json.dumps({"profile": f"{label}: decode_step", "batch": DEC_BATCH,
                    "wall_us_per_step_profiled": wall_us,
                    "wall_us_per_step_unprofiled": step_us,
                    "device_busy_us_per_step": busy,
                    "device_idle_share": 1 - busy / step_us,
                    "device_idle_share_profiled": 1 - busy / wall_us,
                    "by_kernel": by_kernel(rows, reps),
                    "rows": [{"name": e.key[:90],
                              "us_per_step": e.self_device_time_total / reps,
                              "calls_per_step": e.count / reps}
                             for e in rows[:30]]}))


# -- captured steps and serving on the card --------------------------------

# the serving engines' defaults (the JAX package's): slots, decode steps a
# chunk, chunks a host sync
SERVE = dict(slots=8, chunk_steps=32, sync_chunks=4)
# the gpt2 engine's 16 requests: prompt lengths cycle through these, 64-128
# new tokens each; 10 greedy, 4 sampled with these knobs and fixed seeds, 2
# with an eos that the greedy run of their prompt emits
SERVE_PROMPTS = (17, 24, 40, 64, 100)
SERVE_SAMPLED = dict(temperature=0.8, top_p=0.9, top_k=40)
# saturated load: requests x prompt tokens x new tokens, greedy
SERVE_LOAD = (32, 64, 128)
# bench.py's engine leg (bench.py:295-323), the serving yardstick that the
# JAX package's own benchmark pins: the gpt2-small-ish engine at 8 slots,
# chunks of 32 steps, 8 chunks a sync; 16 greedy requests x 24 prompt
# tokens x 256 new tokens (prompts from default_rng(7)); one warm round,
# then tokens/s best of 2
BENCH_ENGINE = dict(slots=8, chunk_steps=32, sync_chunks=8)
BENCH_ENGINE_LOAD = (16, 24, 256)
# the small decoders' engines on the card and on the CPU: (family, slots,
# extra geometry); 8 requests of up to 30 prompt tokens, 16 new tokens
SMALL_SERVE = [("gpt2", 4, {}), ("llama_w4a8", 8, {"mlp_hidden": 768})]
SMALL_SERVE_PROMPTS = (5, 9, 16, 30)
# the AlexNet engine's requests (images each) and its saturated load
# (batches of 100)
ALEX_REQUESTS = (1, 7, 33, 64, 100)
ALEX_LOAD = 30
WAIT_S = 600


# replays profiled to check a captured step's kernels
REPLAYS_PROFILED = 4


def per_replay(program, kernel_fns):
    """{kernel: launches} that each replay of a ``graphs.Captured`` program
    adds to the counts: what its capture recorded."""
    return {name: program.launches.get((fn, "launches"), 0)
            for name, fn in kernel_fns.items()}


def check_replays(label, program, kernel_fns, ran, reps, want=None):
    """A captured program's kernels, two ways: ``ran`` ({kernel:
    executions} of ``reps`` profiled replays) must equal ``reps`` times
    what each replay adds to the counts, and that must equal ``want`` (a
    step's kernels, where it is known)."""
    adds = per_replay(program, kernel_fns)
    got = {k: n // reps for k, n in ran.items()}
    if any(n % reps for n in ran.values()) or \
            got != {k: n for k, n in adds.items() if n} or \
            (want is not None and adds != want):
        fail(f"{label}: {reps} profiled replays ran {ran}; each replay "
             f"counts {adds}" + (f", want {want}" if want else ""))
    return adds


def check_captured_launches(torch, label, counts, model, ids, prefill,
                            per_step, kernel_fns):
    """The launch gate of a captured ``generate(ids, DEC_STEPS)``: the
    counts (the wrappers' for the prefill and the eager first decode step,
    ``graphs.Captured``'s for each of the DEC_STEPS - 2 replays) equal
    ``prefill`` plus DEC_STEPS - 1 steps of ``per_step`` exactly; and a
    step captured the same way (``replay_profile``) runs, in each of
    REPLAYS_PROFILED profiled replays, the kernels that a replay counts."""
    want = {k: prefill[k] + (DEC_STEPS - 1) * per_step[k] for k in per_step}
    if counts != want:
        fail(f"{label} launches {counts}, want {want}")
    rows, _, program = replay_profile(torch, model, ids, REPLAYS_PROFILED)
    check_replays(f"{label} captured step", program, kernel_fns,
                  executions(rows), REPLAYS_PROFILED, per_step)


def executions(rows):
    """{kernel: executions} of the port's kernels in a profile's device
    rows (eager launches and graph replays alike)."""
    out = {}
    for e in rows:
        k = kernel_of(e.key)
        if k is not None:
            out[k] = out.get(k, 0) + e.count
    return out


@contextlib.contextmanager
def kernel_profile(torch):
    """Profile the card while the block runs; yields a dict that holds
    ``executions`` when the block ends."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    res = {}
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        yield res
        torch.cuda.synchronize()
    res.update(executions(profile_rows(torch, prof)))


def eager_generate(torch, model, ids, steps):
    """Greedy decoding as a Python loop of eager ``_decode_step`` calls (the
    parent's ``generate()``): int32 [B, steps]."""
    from int8inferenceengine_tpu_torch.tensor import Tensor
    dev = model.device
    with torch.no_grad():
        codes, cache = model._prefill(Tensor(torch.tensor(
            ids.astype(np.int64), device=dev)))
        tok = codes.argmax(-1)
        out = [tok]
        pos = torch.full((), ids.shape[1], dtype=torch.int64, device=dev)
        for _ in range(1, steps):
            codes, cache = model._decode_step(cache, pos, tok)
            tok = codes.argmax(-1)
            out.append(tok)
            pos = pos + 1
    return torch.stack(out, 1).cpu().numpy().astype(np.int32)


def teacher_forced_captured(torch, model, prompt, tokens):
    """``teacher_forced`` with the decode step captured as a CUDA graph
    (``graphs.run_steps``, as ``generate()`` runs it): the step reads its
    token from ``tokens`` at a column held on the card."""
    from int8inferenceengine_tpu_torch import graphs
    from int8inferenceengine_tpu_torch.tensor import Tensor
    b, steps = tokens.shape
    with torch.no_grad():
        codes0, cache = model._prefill(Tensor(prompt))
        out = torch.empty((b, steps, codes0.shape[-1]), dtype=torch.uint8,
                          device=prompt.device)
        out[:, 0] = codes0
        pos = torch.full((), prompt.shape[1], dtype=torch.int64,
                         device=prompt.device)
        col = torch.ones((1,), dtype=torch.int64, device=prompt.device)
        tok = tokens[:, 0].clone()

        def step():
            codes, _ = model._decode_step(cache, pos, tok)
            out.index_copy_(1, col, codes[:, None])
            tok.copy_(tokens.index_select(1, col).reshape(-1))
            pos.add_(1)
            col.add_(1)

        program = graphs.run_steps(step, steps - 1, prompt.device)
        torch.cuda.synchronize()
    del program
    return out


def captured_vs_eager(torch, model, ids, tokens, label):
    """The captured ``generate()``'s tokens against the eager step loop's,
    and DEC_STEPS teacher-forced steps' codes through a captured step
    against the eager step's: both equal."""
    eager = eager_generate(torch, model, ids, DEC_STEPS)
    prompt = torch.tensor(ids, dtype=torch.int64, device=model.device)
    toks = torch.tensor(tokens, dtype=torch.int64, device=model.device)
    got = teacher_forced_captured(torch, model, prompt, toks)
    want = teacher_forced(torch, model, prompt, toks)
    mx, share = contract(torch, got, want)
    same = bool(np.array_equal(tokens, eager))
    log(json.dumps({"phase": f"{label}_captured_vs_eager",
                    "tokens_equal": same, "teacher_forced_steps": DEC_STEPS,
                    "codes": int(got.numel()), "max_abs_err": mx,
                    "share_differing": share, "limit": "equal"}))
    if not same or mx:
        fail(f"{label}: the captured decode differs from the eager step "
             f"loop (tokens equal: {same}; codes max {mx}, share {share})")


def time_eager_steps(torch, model, ids):
    """The eager step loop's ms/step by the decoders' protocol (best of
    3)."""
    times = {}
    for steps in (DEC_SHORT, DEC_STEPS):
        best = float("inf")
        for trial in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eager_generate(torch, model, (ids + trial + 1) % model.vocab_size,
                           steps)
            best = min(best, time.perf_counter() - t0)
        times[steps] = best
    return 1e3 * (times[DEC_STEPS] - times[DEC_SHORT]) / (DEC_STEPS
                                                          - DEC_SHORT)


def replay_profile(torch, model, ids, reps):
    """A decode step of ``ids`` captured as ``generate()`` captures it (one
    eager step, then the capture), and ``reps`` replays profiled: (device
    rows, wall µs a replay, the ``graphs.Captured`` program)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from int8inferenceengine_tpu_torch import graphs
    from int8inferenceengine_tpu_torch.tensor import Tensor
    dev = model.device
    with torch.no_grad():
        codes, cache = model._prefill(Tensor(torch.tensor(
            ids.astype(np.int64), device=dev)))
        tok = codes.argmax(-1)
        pos = torch.full((), ids.shape[1], dtype=torch.int64, device=dev)

        def step():
            codes, _ = model._decode_step(cache, pos, tok)
            tok.copy_(codes.argmax(-1))
            pos.add_(1)

        program = graphs.run_steps(step, 1, dev)
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                program()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6 / reps
    return profile_rows(torch, prof), wall_us, program


def profile_captured(torch, model, ids, label, reps=16):
    """Device time and idle share while a captured decode step replays."""
    rows, wall_us, _ = replay_profile(torch, model, ids, reps)
    busy = sum(e.self_device_time_total for e in rows) / reps
    log(json.dumps({"profile": f"{label}: captured decode_step replay",
                    "batch": ids.shape[0], "wall_us_per_step": wall_us,
                    "device_busy_us_per_step": busy,
                    "device_idle_share": 1 - busy / wall_us,
                    "by_kernel": by_kernel(rows, reps),
                    "rows": [{"name": e.key[:90],
                              "us_per_step": e.self_device_time_total / reps,
                              "calls_per_step": e.count / reps}
                             for e in rows[:20]]}))


def results(futs):
    return [f.result(timeout=WAIT_S) for f in futs]


def first_new(full, lo):
    """The first index from ``lo`` whose token does not occur before it."""
    return next(j for j in range(lo, len(full))
                if int(full[j]) not in full[:j].tolist())


def saturated_load(torch, eng, vocab, label):
    """SERVE_LOAD greedy requests submitted at once to a warm engine, each
    through ``submit_stream`` on its own thread: tokens/s over the whole
    load, time to first token (TTFT) p50/p99 and the mean slot fill."""
    import threading
    from int8inferenceengine_tpu_torch.serve import GenerationStats
    n, t_prompt, new = SERVE_LOAD
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, vocab, t_prompt).astype(np.int32)
               for _ in range(n)]
    first = [None] * n
    counts = [0] * n

    def consume(i, it, t0):
        for tok in it:
            if counts[i] == 0:
                first[i] = time.perf_counter() - t0
            counts[i] += 1

    eng.stats = GenerationStats()
    t0 = time.perf_counter()
    streams = [(eng.submit_stream(p, new), time.perf_counter())
               for p in prompts]
    threads = [threading.Thread(target=consume, args=(i, it, ts))
               for i, (it, ts) in enumerate(streams)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    wall = time.perf_counter() - t0
    if any(c != new for c in counts):
        fail(f"{label}: saturated load delivered {counts}, want {new} each")
    res = {"phase": f"{label}_saturated_load", "requests": n,
           "prompt_tokens": t_prompt, "new_tokens": new, **SERVE,
           "wall_s": wall, "tokens_per_s": n * new / wall,
           "ttft_ms_p50": float(np.percentile(first, 50) * 1e3),
           "ttft_ms_p99": float(np.percentile(first, 99) * 1e3),
           "mean_slot_fill": eng.stats.mean_slot_fill,
           "chunks": eng.stats.chunks, "prefills": eng.stats.prefills,
           "latency_ms": eng.stats.latency_percentiles()}
    log(json.dumps(res))
    return res


def bench_engine_load(torch, model):
    """bench.py's engine leg (BENCH_ENGINE, BENCH_ENGINE_LOAD) on a new
    engine: delivered tokens / wall seconds of a round of requests
    submitted at once, best of 2 after one warm round."""
    from int8inferenceengine_tpu_torch.serve import GenerationEngine
    n, t_prompt, new = BENCH_ENGINE_LOAD
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, model.vocab_size, (t_prompt,)).astype(np.int32)
               for _ in range(n)]
    eng = GenerationEngine(model, **BENCH_ENGINE)
    try:
        def round_once():
            t0 = time.perf_counter()
            futs = [eng.submit(p, new) for p in prompts]
            ntok = sum(len(x) for x in results(futs))
            return ntok / (time.perf_counter() - t0)

        warm = round_once()
        rates = [round_once() for _ in range(2)]
    finally:
        eng.shutdown()
    log(json.dumps({"phase": "gpt2_engine_bench_protocol", "requests": n,
                    "prompt_tokens": t_prompt, "new_tokens": new,
                    **BENCH_ENGINE, "warm_round_tokens_per_s": warm,
                    "rounds_tokens_per_s": rates,
                    "tokens_per_s": max(rates)}))


def serve_decoder(torch, model, label, kernel_fns, sampled_and_eos=True,
                  profile=False):
    """A decoder's GenerationEngine at SERVE: 16 requests (gpt2: 10 greedy,
    4 sampled, 2 with an eos) or 8 greedy ones, twice through one engine
    (the second pass replays the captured chunks).  Gates: each greedy
    request equals ``generate()`` of its prompt alone; an eos request ends
    where that greedy run first emits its eos; sampled requests give the
    same tokens in both passes.  Then the saturated load, and the greedy
    chunk graph's kernels checked in a profiled replay (``check_replays``).
    Returns the launches of the first pass: its prefills, each variant's
    eager first chunk and every chunk replay (``graphs.Captured`` adds a
    replay's kernels to the counts)."""
    from int8inferenceengine_tpu_torch.serve import GenerationEngine
    vocab = model.vocab_size
    rng = np.random.default_rng(7)
    n_req = 16 if sampled_and_eos else 8
    reqs = []
    for i in range(n_req):
        p = rng.integers(0, vocab, SERVE_PROMPTS[i % len(SERVE_PROMPTS)])
        reqs.append(dict(prompt=p.astype(np.int32),
                         new=int(rng.integers(64, 129)), kw={}))
    if sampled_and_eos:
        for i in range(10, 14):
            reqs[i]["kw"] = dict(SERVE_SAMPLED, seed=100 + i)
        for i in (14, 15):
            full = model.generate(reqs[i]["prompt"][None], reqs[i]["new"])[0]
            j = first_new(full, 12)
            reqs[i]["kw"] = dict(eos_id=int(full[j]))
            reqs[i]["want"] = full[:j + 1]
    for r in reqs:
        if "want" not in r and not r["kw"]:
            r["want"] = model.generate(r["prompt"][None], r["new"])[0]
    eng = GenerationEngine(model, **SERVE)
    try:
        reset_counts(kernel_fns)
        t0 = time.perf_counter()
        passes = [results([eng.submit(r["prompt"], r["new"], **r["kw"])
                           for r in reqs])]
        first_s = time.perf_counter() - t0
        counts = read_counts(kernel_fns)
        stats1 = dataclass_stats(eng.stats)
        t0 = time.perf_counter()
        passes.append(results([eng.submit(r["prompt"], r["new"], **r["kw"])
                               for r in reqs]))
        second_s = time.perf_counter() - t0
        bad = []
        for i, r in enumerate(reqs):
            a, b = passes[0][i], passes[1][i]
            if not np.array_equal(a, b):
                bad.append(f"request {i} differs between passes")
            if "want" in r and not np.array_equal(a, r["want"]):
                bad.append(f"request {i} ({r['kw'] or 'greedy'}) differs "
                           f"from generate()")
        sampled_vs_generate = [
            bool(np.array_equal(passes[0][i], model.generate(
                r["prompt"][None], r["new"], **r["kw"])[0]))
            for i, r in enumerate(reqs) if "temperature" in r["kw"]]
        log(json.dumps({"phase": f"{label}_engine", "requests": n_req,
                        **SERVE, "greedy": sum("want" in r and not r["kw"]
                                               for r in reqs),
                        "sampled": sum("temperature" in r["kw"]
                                       for r in reqs),
                        "eos": sum("eos_id" in r["kw"] for r in reqs),
                        "tokens": int(sum(len(x) for x in passes[0])),
                        "first_pass_s": first_s, "second_pass_s": second_s,
                        "first_pass_stats": stats1,
                        "launches_first_pass": counts,
                        "sampled_equal_to_generate_row0":
                            sampled_vs_generate,
                        "problems": bad}))
        if bad:
            fail(f"{label} engine: {bad}")
        saturated_load(torch, eng, vocab, label)
        profile_engine_chunk(torch, eng, label, kernel_fns, 1, show=False)
        if profile:
            profile_engine_chunk(torch, eng, label, kernel_fns)
    finally:
        eng.shutdown()
    return counts


def profile_engine_chunk(torch, eng, label, kernel_fns, reps=4, show=True):
    """Device time and idle share while the engine's greedy chunk graph
    replays with every slot active (run after the engine's last request:
    the replays only move its idle state); the kernels that the replays
    ran must be what each replay counts (``check_replays``)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    chunk = eng._chunk_fns[(False, False, False)]
    with torch.cuda.stream(eng._stream):
        eng._act.fill_(True)
        eng._rem.fill_(1 << 30)
        eng._pos.fill_(SERVE_LOAD[1])
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                eng._col.zero_()
                chunk()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6 / reps
    rows = profile_rows(torch, prof)
    adds = check_replays(f"{label} engine chunk", chunk, kernel_fns,
                         executions(rows), reps)
    if not show:
        log(json.dumps({"phase": f"{label}_engine_chunk_replay",
                        "replays_profiled": reps, "kernels_each": adds}))
        return
    busy = sum(e.self_device_time_total for e in rows) / reps
    steps = eng.chunk_steps
    log(json.dumps({"profile": f"{label}: engine chunk replay",
                    "slots": eng.slots, "chunk_steps": steps,
                    "wall_us_per_step": wall_us / steps,
                    "device_busy_us_per_step": busy / steps,
                    "device_idle_share": 1 - busy / wall_us,
                    "by_kernel": by_kernel(rows, reps * steps),
                    "rows": [{"name": e.key[:90],
                              "us_per_step": e.self_device_time_total
                              / (reps * steps),
                              "calls_per_step": e.count / (reps * steps)}
                             for e in rows[:20]]}))


def dataclass_stats(stats):
    return {"requests": stats.requests, "tokens": stats.tokens,
            "prefills": stats.prefills, "chunks": stats.chunks,
            "mean_slot_fill": stats.mean_slot_fill}


def small_engines_vs_cpu(torch, q, zoo, TD, LL, dev):
    """The small decoders of the card-vs-CPU gate served by an engine on
    the card and by one on the CPU (its copy of the converted state): the
    greedy tokens equal (gated where every prefill dispatches as on the
    card), the sampled ones recorded."""
    from int8inferenceengine_tpu_torch.carry import (export_state,
                                                     load_jax_state)
    from int8inferenceengine_tpu_torch.ops.w4 import use_v2
    from int8inferenceengine_tpu_torch.serve import GenerationEngine
    bad = []
    for family, slots, extra in SMALL_SERVE:
        geo = dict(SMALL_DEC, **extra)
        if family == "gpt2":
            name, cfg, residual = "gpt_tiny", {}, ("proj", "fc2")
            twin = TD.torch_text_decoder(**geo, seed=0)
        else:
            geo.setdefault("kv_heads", 2)
            name, cfg, residual = "llama_tiny", LLAMA_W4A8, ("proj", "down")
            twin = LL.torch_llama(**geo, seed=0)
        state = decoder_state(torch, twin, geo["depth"], seed=2,
                              residual=residual)
        ids = np.random.default_rng(2).integers(
            0, geo["vocab_size"], (SMALL_BATCH, SMALL_PROMPT)).astype(np.int32)
        model = zoo.build(name, config=q.QuantConfig(**cfg), device=dev,
                          **geo)
        model.load(state)
        model.prepare()
        model(q.tensor(ids, device=dev))
        model.convert()
        cpu = zoo.build(name, config=q.QuantConfig(**cfg), device="cpu",
                        **geo)
        load_jax_state(cpu, export_state(model))
        rng = np.random.default_rng(5)
        reqs = [(rng.integers(0, geo["vocab_size"], SMALL_SERVE_PROMPTS[
            i % len(SMALL_SERVE_PROMPTS)]).astype(np.int32),
            {} if i < 6 else dict(SERVE_SAMPLED, seed=i)) for i in range(8)]
        outs = {}
        for where, m in (("card", model), ("cpu", cpu)):
            eng = GenerationEngine(m, slots=slots, chunk_steps=8,
                                   sync_chunks=2)
            try:
                outs[where] = results([eng.submit(p, SMALL_STEPS, **kw)
                                       for p, kw in reqs])
            finally:
                eng.shutdown()
        # the W4A8 prefill dispatches B6's function (exact on both sides)
        # where M = n x bucket is in its envelope at every K
        ks = {geo["dim"], model.mlp_hidden}
        group = cfg.get("w4_group", 128)
        on_b6 = family == "gpt2" or all(
            use_v2(n * bucket, k, group, -(-k // group))
            for k in ks for bucket in {8, 16, 32}
            for n in (1, 2, 4, 8) if n <= slots)
        greedy = [bool(np.array_equal(outs["card"][i], outs["cpu"][i]))
                  for i in range(6)]
        sampled = [bool(np.array_equal(outs["card"][i], outs["cpu"][i]))
                   for i in range(6, 8)]
        log(json.dumps({"phase": "engine_card_vs_cpu", "family": family,
                        "slots": slots, **geo, "new_tokens": SMALL_STEPS,
                        "greedy_equal": greedy, "sampled_equal": sampled,
                        "prefill_on_b6_only": on_b6, "gated": on_b6,
                        "sampled_gated": False}))
        if on_b6 and not all(greedy):
            bad.append(family)
    if bad:
        fail(f"engine greedy tokens on the card differ from the CPU's: {bad}")


def serve_alexnet(torch, q, model, kernel_fns):
    """AlexNet-224's InferenceEngine (max_batch 100, one captured forward
    per tile): requests of ALEX_REQUESTS images equal the direct call on
    the same images exactly, and their launches (eager first batches and
    replays) equal the kernels that a profile of them saw run; then
    ALEX_LOAD batches of 100 at once, images/s beside the direct calls'
    (host input and output both ways).  Returns the requests' launches."""
    from int8inferenceengine_tpu_torch.serve import InferenceEngine
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((n, 3, 224, 224)).astype(np.float32)
          for n in ALEX_REQUESTS]
    eng = InferenceEngine(model, max_batch=100)
    try:
        reset_counts(kernel_fns)
        with kernel_profile(torch) as executed:
            got = results([eng.submit(x) for x in xs])
        counts = read_counts(kernel_fns)
        if counts != {k: executed.get(k, 0) for k in counts}:
            fail(f"AlexNet engine: the counts {counts} differ from the "
                 f"kernels that the profile saw run {executed}")
        equal = [bool(np.array_equal(g, model(q.tensor(x)).numpy()))
                 for g, x in zip(got, xs)]
        log(json.dumps({"phase": "alexnet_engine", "requests":
                        list(ALEX_REQUESTS), "equal_to_direct": equal,
                        "steps": eng.stats.steps,
                        "padded_rows": eng.stats.padded_rows,
                        "launches": counts, "kernel_executions": executed}))
        if not all(equal):
            fail(f"AlexNet engine results differ from the direct call: "
                 f"{equal}")
        batch = xs[-1]
        rates = {}
        for trial in range(2):
            t0 = time.perf_counter()
            results([eng.submit(batch) for _ in range(ALEX_LOAD)])
            rates.setdefault("engine", []).append(
                ALEX_LOAD * 100 / (time.perf_counter() - t0))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(ALEX_LOAD):
                model(q.tensor(batch)).numpy()
            rates.setdefault("direct", []).append(
                ALEX_LOAD * 100 / (time.perf_counter() - t0))
        log(json.dumps({"phase": "alexnet_engine_saturated_load",
                        "batches": ALEX_LOAD, "images_per_batch": 100,
                        "engine_images_per_s": rates["engine"],
                        "direct_images_per_s": rates["direct"],
                        "latency_ms": eng.stats.latency_percentiles()}))
    finally:
        eng.shutdown()
    return counts


# -- phase 11: per-kernel times -----------------------------------------------

def int_mm_operands(torch, a_u8, w_s8_nk):
    """cuBLAS int8 operands: a recentered to s8, M padded to 32 and K, N to
    multiples of 8 with zeros (a zero tap adds nothing)."""
    m, k = a_u8.shape
    n = w_s8_nk.shape[0]
    mp, kp, np_ = max(32, -(-m // 8) * 8), -(-k // 8) * 8, -(-n // 8) * 8
    a = torch.zeros((mp, kp), dtype=torch.int8, device=a_u8.device)
    a[:m, :k] = (a_u8.to(torch.int16) - 128).to(torch.int8)
    w = torch.zeros((np_, kp), dtype=torch.int8, device=a_u8.device)
    w[:n, :k] = w_s8_nk
    return a, w


def conv_bound_ms(geom, n: int):
    """A conv's own bound: the NHWC input, the weights and two 4-byte [N]
    epilogue vectors read once, the output written once, 2MNK operations."""
    b, h, w, c, k, stride, pad = geom
    oh = (h + 2 * pad - k) // stride + 1
    ow = (w + 2 * pad - k) // stride + 1
    m, kk = b * oh * ow, k * k * c
    return bound(b * h * w * c + n * kk + 8 * n + m * n, 2.0 * m * n * kk)


def time_alexnet_gemms(torch, G, C, gen, dev, flush):
    """B1 at one AlexNet b100 forward's shapes: the Linears as GEMMs, the
    convs through the gathered kernel (the forward's route) and, beside it,
    through im2col + B1's GEMM variant (the parent's route)."""
    rows = []
    for layer, m, k, n in ALEXNET_B100:
        c = gemm_case(torch, gen, m, k, n, dev)
        conv = ALEXNET_CONVS.get(layer)
        order = "conv" if conv else "gemm"
        oc = G.compute_offset(c["q_bias"], rowsum(torch, c["w"]), c["s_a"],
                              c["zp_a"], recentered=True)
        ep = G.epilogue_vector(c["s_a"], 0.01, c["s_c"], n, dev, order)
        kw = dict(scale_a=c["s_a"], scale_c=c["s_c"], zp_c=c["zp_c"],
                  relu=layer != "fc3", rounding="trunc", order=order)
        row = dict(kernel="qgemm_u8s8", path="alexnet_b100", layer=layer,
                   M=m, K=k, N=n, launches_per_unit=1)
        if conv:
            b, h, w, ci, kk, stride, pad = conv
            g = G.ConvGeom(b, h, w, ci, kk, kk, stride, pad)
            x = torch.randint(0, 256, (b, h, w, ci), generator=gen,
                              dtype=torch.uint8, device=dev)
            ckw = dict(kw, kh=kk, kw=kk, stride=stride, padding=pad,
                       zp_a=c["zp_a"])
            a = C.im2col_nhwc(x, kk, kk, stride, pad,
                              pad_value=c["zp_a"]).reshape(m, k)
            c["a"] = a

            def fn():
                return C.qgemm_conv(x, c["w"], oc, ep, **ckw)

            def plain():
                return C.conv2d_int8_gemm(x, c["w"], oc, ep,
                                          gemm=G.qgemm_plain, **ckw)

            def im2col_b1():
                return G.qgemm(C.im2col_nhwc(x, kk, kk, stride, pad,
                                             pad_value=c["zp_a"]
                                             ).reshape(m, k), c["w"], oc,
                               ep, **kw)

            if not torch.equal(fn().reshape(m, n), im2col_b1()):
                fail(f"{layer}: the gathered conv and im2col + B1 disagree")
            row["im2col_b1_ms"] = time_cuda(torch, im2col_b1, iters=10,
                                            flush=flush)
            row["plan"] = plan_of(G, m, n, k, dev, conv=g)
            row["plan_im2col"] = plan_of(G, m, n, k, dev)
            b_ms, b_by, t_ops, t_bytes = conv_bound_ms(conv, n)
            row["bound_im2col_ms"] = bound_ms(m, k, n)[0]
        else:
            def fn():
                return G.qgemm(c["a"], c["w"], oc, ep, **kw)

            def plain():
                return G.qgemm_plain(c["a"], c["w"], oc, ep, **kw)

            row["plan"] = plan_of(G, m, n, k, dev)
            b_ms, b_by, t_ops, t_bytes = bound_ms(m, k, n)
            row["bound_im2col_ms"] = b_ms
        ms = time_cuda(torch, fn, iters=10, flush=flush)
        plain_ms = time_cuda(torch, plain, iters=3, flush=flush)
        # the yardstick: cuBLAS int8 on the GEMM operand (for a conv, the
        # patch matrix written beforehand) and the eager epilogue
        a_s8, w_p = int_mm_operands(torch, c["a"], c["w"])

        def library():
            acc = torch._int_mm(a_s8, w_p.t())[:m, :n]
            return G._requant_epilogue(acc + oc.reshape(1, -1), ep, **kw)

        if not torch.equal(library(), fn().reshape(m, n)):
            fail(f"{layer}: torch._int_mm + epilogue disagrees with the "
                 f"kernel")
        library_ms = time_cuda(torch, library, iters=5, flush=flush)
        row.update(ms=ms, bound_ms=b_ms, bound_by=b_by, plain_ms=plain_ms,
                   library_ms=library_ms, t_ops=t_ops, t_bytes=t_bytes)
        rows.append(row)
        log(json.dumps({k_: v for k_, v in row.items()
                        if k_ not in ("t_ops", "t_bytes")}
                       | {"share_of_bound": b_ms / ms,
                          "vs_library": ms / library_ms}))
        del c, a_s8, w_p
    tot = {key: sum(r[key] for r in rows)
           for key in ("ms", "bound_ms", "bound_im2col_ms", "plain_ms",
                       "library_ms")}
    tot["im2col_route_ms"] = sum(r.get("im2col_b1_ms", r["ms"])
                                 for r in rows)
    log(json.dumps({"kernels_per_unit": "alexnet_b100"} | tot
                   | {"share_of_bound": tot["bound_ms"] / tot["ms"]}))
    return rows


def time_decode_kernels(torch, G, A, gen, dev, flush):
    """Each kernel at one decode step's shapes; a row per shape with its
    launches per step."""
    rows = []
    for layer, m, k, n, per_step, act_name in DEC_GEMMS:
        c = gemm_case(torch, gen, m, k, n, dev)
        oc = G.compute_offset(c["q_bias"], rowsum(torch, c["w"]), c["s_a"],
                              c["zp_a"], recentered=True)
        ep = G.epilogue_vector(c["s_a"], c["s_w_pc"], c["s_c"], n, dev)
        kw = dict(scale_a=c["s_a"], scale_c=c["s_c"], zp_c=c["zp_c"],
                  rounding="trunc",
                  act=act_grid(act_name) if act_name else None)
        ms = time_cuda(torch, lambda: G.qgemm(c["a"], c["w"], oc, ep, **kw),
                       iters=20, flush=flush)
        plain_ms = time_cuda(
            torch, lambda: G.qgemm_plain(c["a"], c["w"], oc, ep, **kw),
            iters=5, flush=flush)
        a_s8, w_p = int_mm_operands(torch, c["a"], c["w"])

        def library():
            acc = torch._int_mm(a_s8, w_p.t())[:m, :n]
            return G._requant_epilogue(acc + oc.reshape(1, -1), ep, **kw)

        if not torch.equal(library(),
                           G.qgemm_plain(c["a"], c["w"], oc, ep, **kw)):
            fail(f"{layer}: torch._int_mm + epilogue disagrees with the "
                 f"plain version")
        library_ms = time_cuda(torch, library, iters=10, flush=flush)
        b_ms, b_by, t_ops, t_bytes = bound_ms(m, k, n)
        rows.append(dict(kernel="qgemm_u8s8", path="decode_step",
                         layer=layer, M=m, K=k, N=n,
                         plan=plan_of(G, m, n, k, dev),
                         launches_per_unit=per_step, ms=ms, bound_ms=b_ms,
                         bound_im2col_ms=b_ms, bound_by=b_by,
                         plain_ms=plain_ms, library_ms=library_ms,
                         t_ops=t_ops, t_bytes=t_bytes))
        del c, a_s8, w_p

    m, k, n, per_step = DEC_QKV
    parts, cases = [], []
    for i in range(3):
        c = gemm_case(torch, gen, m, k, n, dev)
        cases.append(c)
        parts.append(dict(w_s8_nk=c["w"], q_bias=c["q_bias"],
                          rowsum=rowsum(torch, c["w"]), scale_w=c["s_w_pc"],
                          scale_c=c["s_c"] * (1 + 0.3 * i), zp_c=110 + 9 * i))
    a = cases[0]["a"]
    merged = G.merge_parts(parts, scale_a=cases[0]["s_a"],
                           zp_a=cases[0]["zp_a"])
    ms = time_cuda(torch, lambda: G.qgemm_multi(a, merged), iters=20,
                   flush=flush)
    plain_ms = time_cuda(torch, lambda: G.qgemm_multi_plain(a, merged),
                         iters=5, flush=flush)
    a_s8, w_p = int_mm_operands(torch, a, merged["w"])

    def library_multi():
        acc = torch._int_mm(a_s8, w_p.t())[:m, :3 * n]
        return G.vzp_epilogue(acc + merged["oc"].reshape(1, -1), merged)

    if not torch.equal(library_multi(),
                       torch.cat(G.qgemm_multi(a, merged), 1)):
        fail("merged QKV: torch._int_mm + epilogue disagrees with the kernel")
    library_ms = time_cuda(torch, library_multi, iters=10, flush=flush)
    b_ms, b_by, t_ops, t_bytes = bound_ms(m, k, 3 * n, vectors=3)
    rows.append(dict(kernel="qgemm_u8s8_vzp", path="decode_step",
                     layer="qkv", M=m, K=k, N=3 * n,
                     plan=plan_of(G, m, 3 * n, k, dev),
                     launches_per_unit=per_step, ms=ms, bound_ms=b_ms,
                     bound_by=b_by, plain_ms=plain_ms, library_ms=library_ms,
                     t_ops=t_ops, t_bytes=t_bytes))

    rows += time_attention(torch, A, gen, dev, flush, DEC_ATTN,
                           "decode_step", "attention")
    for r in rows:
        log(json.dumps({k_: v for k_, v in r.items()
                        if k_ not in ("t_ops", "t_bytes")}
                       | {"share_of_bound": r["bound_ms"] / r["ms"]}
                       | ({"vs_library": r["ms"] / r["library_ms"]}
                          if r["library_ms"] else {})))
    step = {key: sum(r[key] * r["launches_per_unit"] for r in rows)
            for key in ("ms", "bound_ms", "plain_ms")}
    for kernel in ("qgemm_u8s8", "qgemm_u8s8_vzp"):
        mine = [r for r in rows if r["kernel"] == kernel]
        step[kernel] = {key: sum(r[key] * r["launches_per_unit"]
                                 for r in mine)
                        for key in ("ms", "bound_ms", "library_ms")}
    log(json.dumps({"decode_step_kernels": step,
                    "launches_per_step": {
                        "qgemm_u8s8": 37, "qgemm_u8s8_vzp": 12,
                        "decode_attn_flat": 12}}))
    return rows


def time_attention(torch, A, gen, dev, flush, cfg, path, label,
                   rounding="trunc"):
    """B3 at one decode step's shapes under its plan: at the step's mean
    live length (``cfg['valid']``, counted per step) and at T - 1 (a full
    cache, recorded beside it)."""
    b, t, h, d = (cfg[x] for x in ("b", "t", "h", "d"))
    hkv = cfg.get("hkv", h)
    q = torch.randint(0, 256, (b, h * d), generator=gen, dtype=torch.uint8,
                      device=dev)
    k_, v_ = (torch.randint(0, 256, (b, t, hkv * d), generator=gen,
                            dtype=torch.uint8, device=dev) for _ in range(2))
    kw = dict(ATTN_PARAMS, n_heads=h, n_kv_heads=hkv, rounding=rounding)
    plan = A.plan_decode_attn(b, t, h, hkv, d)
    rows = []
    for valid, per in ((cfg["valid"], cfg["launches"]), (t - 1, 0)):
        valid_t = torch.full((), valid, dtype=torch.int32, device=dev)
        ms = time_cuda(torch, lambda: A.decode_attention_flat(
            q, k_, v_, valid_t, **kw), iters=20, flush=flush)
        plain_ms = time_cuda(torch, lambda: A.decode_attention_flat(
            q, k_, v_, valid_t, backend="xla", **kw), iters=5, flush=flush)
        b_ms, b_by, t_ops, t_bytes = attn_bound_ms(b, h, hkv, d, valid)
        rows.append(dict(kernel="decode_attn_flat", path=path,
                         layer=f"{label} (live length {valid} of {t})", B=b,
                         T=t, H=h, Hkv=hkv, D=d, plan=plan._asdict(),
                         launches_per_unit=per, ms=ms, bound_ms=b_ms,
                         bound_by=b_by, plain_ms=plain_ms, library_ms=None,
                         t_ops=t_ops, t_bytes=t_bytes))
    return rows


def time_launch_floor(torch, flush):
    """An empty launch (``torch.cuda._sleep(1)``) through ``time_cuda``: the
    event floor every per-launch time sits on."""
    ms = time_cuda(torch, lambda: torch.cuda._sleep(1), iters=50, flush=flush)
    log(json.dumps({"launch_floor": "torch.cuda._sleep(1)", "ms": ms}))
    return ms


def time_w4_kernels(torch, W, A, gen, dev, flush):
    """B6 at the llama decode step's shapes, B7 at the prefill's, B5 at the
    weight-only forward's, and B3 at the llama decode (Hkv = 2); a row per
    shape with its launches per unit of work."""
    rows = []
    shapes = ([("w4a8_v2_gemm", "llama_w4a8_decode_step", name, m, k, n, 256,
                per, name in ("qkv", "gate+up"))
               for name, m, k, n, per in W4_DECODE]
              + [("w4a8_v1_gemm", "llama_w4a8_prefill", name, m, k, n, 256,
                  per, vec) for name, m, k, n, per, vec in W4_PREFILL]
              + [("w4_gemm", "llama_w4_forward", name, m, k, n, 128, per,
                  False) for name, m, k, n, per in W4_FORWARD])
    for kernel, path, name, m, k, n, group, per, vec in shapes:
        c = w4_case(torch, W, gen, m, k, n, group, dev, vector_mult=vec,
                    weight_only=kernel == "w4_gemm")
        library_ms = None
        if kernel == "w4_gemm":
            args = (c["x"], c["packed"], c["scales"], c["bias"], k, group)
            fn, plain = (lambda: W.w4_gemm(*args),
                         lambda: W.w4_gemm_plain(*args))
            # the yardstick: one f32 GEMM (TF32 off) on the weight
            # dequantized before the timed window
            w_deq = W.dequant_w4(c["packed"], c["scales"], k, group)

            def library():
                return torch.addmm(c["bias"], c["x"], w_deq.t())

            if torch.backends.cuda.matmul.allow_tf32:
                fail("TF32 is on: the B5 yardstick must be true f32")
            rel = rel_err(torch, library(), fn())
            if not rel <= W4_RTOL:
                fail(f"B5 yardstick torch.addmm differs from the kernel at "
                     f"{name}: {rel} of the largest |output|")
            library_ms = time_cuda(torch, library, iters=10, flush=flush)
        elif kernel == "w4a8_v2_gemm":
            fn, plain = (lambda: W.w4a8_v2(c["x"], c["ops"], "nearest"),
                         lambda: v2_plain(W, c["x"], c["ops"], "nearest"))
            plan = w4_plan(W.plan_w4a8_v2(m, n, k, group,
                                          sms=W.sm_count(dev)))
        else:
            fn, plain = (lambda: W.w4a8_v1(c["x"], c["ops"], "nearest"),
                         lambda: v1_plain(W, c["x"], c["ops"], "nearest"))
        ms = time_cuda(torch, fn, iters=20, flush=flush)
        plain_ms = time_cuda(torch, plain, iters=3, flush=flush)
        b_ms, b_by, t_ops, t_bytes = w4_bound_ms(kernel, m, k, n, group)
        row = dict(kernel=kernel, path=path, layer=name, M=m, K=k, N=n,
                   group=group, **({"plan": plan} if kernel == "w4a8_v2_gemm"
                                   else {}),
                   launches_per_unit=per, ms=ms, bound_ms=b_ms,
                   bound_by=b_by, plain_ms=plain_ms, library_ms=library_ms,
                   t_ops=t_ops, t_bytes=t_bytes)
        if kernel != "w4a8_v2_gemm":
            row["bound_f32_simt_ms"] = w4_bound_ms(kernel, m, k, n, group,
                                                   simt=True)[0]
        rows.append(row)
        del c

    rows += time_attention(torch, A, gen, dev, flush, LLAMA_ATTN,
                           "llama_w4a8_decode_step", "attention GQA 12/2",
                           rounding="nearest")
    for r in rows:
        log(json.dumps({k_: v for k_, v in r.items()
                        if k_ not in ("t_ops", "t_bytes")}
                       | {"share_of_bound": r["bound_ms"] / r["ms"]}))
    for path in ("llama_w4a8_decode_step", "llama_w4a8_prefill",
                 "llama_w4_forward"):
        mine = [r for r in rows if r["path"] == path]
        keys = [key for key in ("ms", "bound_ms", "bound_f32_simt_ms",
                                "plain_ms", "library_ms")
                if all(r.get(key) is not None for r in mine)]
        tot = {key: sum(r[key] * r["launches_per_unit"] for r in mine)
               for key in keys}
        log(json.dumps({"kernels_per_unit": path} | tot
                       | {"share_of_bound": tot["bound_ms"] / tot["ms"]}))
    return rows


def sweep_plans(torch, G, C, W, A, gen, dev, flush):
    """``--sweep``: B1 and B2 at the main paths' shapes under every
    candidate plan (tile x K slices), B6 at the llama decode shapes and at
    M = 16, 64 and 128 under every K split it runs, and B3 at both
    decoders' shapes under every split count, at the step's mean live
    length and at a full cache; one line per shape and plan, the numbers
    ``plan_qgemm``, ``plan_w4a8_v2`` and ``plan_decode_attn`` are tuned
    from."""
    def plans(chosen, m, k):
        """The chosen plan and each tile at 1, 2, 4 and 8 K slices (one
        slice only for large M)."""
        out = [chosen]
        for tile in G.QGEMM_TILES:
            if tile[0] == 16 and m > 100:
                continue
            for want in (1, 2, 4, 8):
                k_slice = -(-(-(-k // want)) // G.QGEMM_KSTEP) * G.QGEMM_KSTEP
                slices = -(-k // k_slice)
                plan = chosen._replace(tile=tile, slices=slices,
                                       k_slice=k if slices == 1 else k_slice)
                if plan not in out and (slices == 1 or m <= 512):
                    out.append(plan)
        return out

    def report(what, shape, plan, fn):
        ms = time_cuda(torch, fn, iters=10, flush=flush)
        log(json.dumps({"sweep": what, "shape": shape, "tile": plan.tile,
                        "slices": plan.slices, "ms": ms,
                        "chosen": plan == chosen}))

    for layer, m, k, n in ALEXNET_B100:
        c = gemm_case(torch, gen, 1 if layer in ALEXNET_CONVS else m, k, n,
                      dev)
        order = "conv" if layer in ALEXNET_CONVS else "gemm"
        oc = G.compute_offset(c["q_bias"], rowsum(torch, c["w"]), c["s_a"],
                              c["zp_a"], recentered=True)
        ep = G.epilogue_vector(c["s_a"], 0.01, c["s_c"], n, dev, order)
        kw = dict(scale_a=c["s_a"], scale_c=c["s_c"], zp_c=c["zp_c"],
                  relu=True, order=order)
        if layer in ALEXNET_CONVS:
            b, h, w, ci, kk, stride, pad = ALEXNET_CONVS[layer]
            g = G.ConvGeom(b, h, w, ci, kk, kk, stride, pad)
            x = torch.randint(0, 256, (b, h, w, ci), generator=gen,
                              dtype=torch.uint8, device=dev)
            chosen = G.plan_qgemm(m, n, k, conv=g, sms=G.sm_count(dev))
            for plan in plans(chosen, m, chosen.k_slice):
                if plan.slices == 1:
                    report(layer, [m, k, n], plan, lambda: C.qgemm_conv(
                        x, c["w"], oc, ep, kh=kk, kw=kk, stride=stride,
                        padding=pad, zp_a=c["zp_a"], plan=plan, **kw))
            continue
        chosen = G.plan_qgemm(m, n, k, sms=G.sm_count(dev))
        for plan in plans(chosen, m, k):
            report(layer, [m, k, n], plan,
                   lambda: G.qgemm(c["a"], c["w"], oc, ep, plan=plan, **kw))
    for layer, m, k, n, _, act_name in DEC_GEMMS:
        c = gemm_case(torch, gen, m, k, n, dev)
        oc = G.compute_offset(c["q_bias"], rowsum(torch, c["w"]), c["s_a"],
                              c["zp_a"], recentered=True)
        ep = G.epilogue_vector(c["s_a"], c["s_w_pc"], c["s_c"], n, dev)
        kw = dict(scale_a=c["s_a"], scale_c=c["s_c"], zp_c=c["zp_c"],
                  act=act_grid(act_name) if act_name else None)
        chosen = G.plan_qgemm(m, n, k, sms=G.sm_count(dev))
        for plan in plans(chosen, m, k):
            report(f"decode {layer}", [m, k, n], plan,
                   lambda: G.qgemm(c["a"], c["w"], oc, ep, plan=plan, **kw))
    m, k, n, _ = DEC_QKV
    c = gemm_case(torch, gen, m, k, 3 * n, dev)
    merged = G.merge_parts([dict(w_s8_nk=c["w"], q_bias=c["q_bias"],
                                 rowsum=rowsum(torch, c["w"]), scale_w=0.01,
                                 scale_c=c["s_c"], zp_c=110)],
                           scale_a=c["s_a"], zp_a=c["zp_a"])
    chosen = G.plan_qgemm(m, 3 * n, k, sms=G.sm_count(dev))
    for plan in plans(chosen, m, k):
        report("decode qkv (B2)", [m, k, 3 * n], plan,
               lambda: G.qgemm_multi(c["a"], merged, plan=plan))

    sms = G.sm_count(dev)
    for name, m, k, n, _ in W4_DECODE + W4_DECODE_M:
        c = w4_case(torch, W, gen, m, k, n, 256, dev)
        chosen = W.plan_w4a8_v2(m, n, k, 256, sms=sms)
        for sl in W.v2_slice_counts(k, 256):
            plan = chosen._replace(slices=sl, k_slice=k // sl)
            if W.v2_smem_bytes(plan, 256) > W.SMEM_LIMIT:
                continue
            ms = time_cuda(torch, lambda: W.w4a8_v2(
                c["x"], c["ops"], "nearest", plan=plan), iters=20,
                flush=flush)
            log(json.dumps({"sweep": f"B6 {name}", "shape": [m, k, n],
                            "slices": sl, "ms": ms,
                            "chosen": plan == chosen}))
    for cfg, label in ((DEC_ATTN, "B3 gpt2"), (LLAMA_ATTN, "B3 llama")):
        b, t, h, d = (cfg[x] for x in ("b", "t", "h", "d"))
        hkv = cfg.get("hkv", h)
        q = torch.randint(0, 256, (b, h * d), generator=gen,
                          dtype=torch.uint8, device=dev)
        k_, v_ = (torch.randint(0, 256, (b, t, hkv * d), generator=gen,
                                dtype=torch.uint8, device=dev)
                  for _ in range(2))
        kw = dict(ATTN_PARAMS, n_heads=h, n_kv_heads=hkv)
        chosen = A.plan_decode_attn(b, t, h, hkv, d)
        for valid in (cfg["valid"], t - 1):
            valid_t = torch.full((), valid, dtype=torch.int32, device=dev)
            for sp in range(1, A.MAX_SPLITS + 1):
                plan = A.decode_attn_plan(sp, h // hkv, t, d)
                ms = time_cuda(torch, lambda: A.decode_attention_flat(
                    q, k_, v_, valid_t, plan=plan, **kw), iters=20,
                    flush=flush)
                log(json.dumps({"sweep": label, "shape": [b, t, h, hkv, d],
                                "live": valid, "splits": sp, "ms": ms,
                                "chosen": plan == chosen}))


def kernels_line(rows, counts_by_path, max_err):
    """One entry per kernel.  ``ms``, ``plain_ms``, ``bound_ms`` and
    ``library_ms`` are sums over the ``work`` named in the entry: every
    launch of one AlexNet b100 forward and of one decode step, at their
    shapes.  ``launches`` adds each path's counts, read just after the
    path ran with the counts set to 0 just before it: the wrappers' eager
    launches and, for every replay of a captured graph, the kernels that
    its capture recorded (``graphs.Captured``)."""
    out = []
    for name, info in KERNEL_INFO.items():
        mine = [r for r in rows if r["kernel"] == name]
        tot = {key: sum(r[key] * r["launches_per_unit"] for r in mine)
               for key in ("ms", "plain_ms", "bound_ms", "t_ops", "t_bytes")}
        libs = [r["library_ms"] for r in mine]
        paths = sorted({r["path"] for r in mine})
        out.append(dict(
            name=name, route="cuda", source=info["source"],
            replaces=info["replaces"],
            **({"also_replaces": info["also_replaces"]}
               if "also_replaces" in info else {}),
            launches=sum(c[name] for c in counts_by_path.values()),
            launches_by_path={p: c[name] for p, c in counts_by_path.items()},
            max_abs_err=max_err[name], ms=tot["ms"],
            plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
            bound_by=("bytes" if tot["t_bytes"] >= tot["t_ops"]
                      else "operations"),
            library_ms=(None if any(x is None for x in libs) else
                        sum(r["library_ms"] * r["launches_per_unit"]
                            for r in mine)),
            **({key: sum(r[key] * r["launches_per_unit"] for r in mine)
                for key in ("bound_f32_simt_ms", "bound_im2col_ms")
                if all(key in r for r in mine)}),
            work=" + ".join(f"one {p.replace('_', ' ')}" for p in paths)))
    return out


def reset_counts(kernel_fns):
    for fn in kernel_fns.values():
        fn.launches = 0
        if hasattr(fn, "merged_launches"):
            fn.merged_launches = 0


def read_counts(kernel_fns):
    return {name: fn.launches for name, fn in kernel_fns.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="print torch.profiler breakdowns of the AlexNet "
                         "forwards and of decode steps")
    ap.add_argument("--sweep", action="store_true",
                    help="only build and time B1/B2, B6 and B3 under every "
                         "candidate plan at the main paths' shapes (no "
                         "checks, no result line)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this script needs a card")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import int8inferenceengine_tpu_torch as q
    from int8inferenceengine_tpu_torch import kernels
    from int8inferenceengine_tpu_torch.models import llama as LL
    from int8inferenceengine_tpu_torch.models import text_decoder as TD
    from int8inferenceengine_tpu_torch.models import zoo
    from int8inferenceengine_tpu_torch.ops import attention as A
    from int8inferenceengine_tpu_torch.ops import conv as C
    from int8inferenceengine_tpu_torch.ops import gemm_int8 as G
    from int8inferenceengine_tpu_torch.ops import w4 as W
    from int8inferenceengine_tpu_torch.ops.quant import quantize_u8
    kernel_fns = {"qgemm_u8s8": G.qgemm, "qgemm_u8s8_vzp": G.qgemm_multi,
                  "decode_attn_flat": A.decode_attention_flat,
                  "w4_gemm": W.w4_gemm, "w4a8_v2_gemm": W.w4a8_v2,
                  "w4a8_v1_gemm": W.w4a8_v1}
    t_start = time.perf_counter()

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

    if args.sweep:
        flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
        sweep_plans(torch, G, C, W, A,
                    torch.Generator(device=dev).manual_seed(0), dev,
                    flush_buf.zero_)
        return 0

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
    max_err = {"qgemm_u8s8": check_alexnet_kernel(torch, G, gen, dev)}
    check_gathered_conv(torch, G, C, gen, dev)

    # -- 4. the decoder's kernels against their plain versions ----------------
    for name, err in check_decoder_kernels(torch, G, A, gen, dev).items():
        max_err[name] = max(max_err.get(name, 0), err)

    # -- 8. the 4-bit kernels against their plain versions --------------------
    max_err.update(check_w4_kernels(torch, W, gen, dev))
    for name, err in check_engine_prefill_kernels(torch, G, W, gen,
                                                  dev).items():
        max_err[name] = max(max_err.get(name, 0), err)

    # -- 5. the AlexNet main path ---------------------------------------------
    counts_by_path = {}
    model, x_test, state, counts_by_path["alexnet_b100"] = alexnet_main_path(
        torch, q, zoo, kernel_fns, dev)
    alexnet_timing(torch, q, zoo, model, x_test, state, args.profile)

    # -- 14. the AlexNet engine -----------------------------------------------
    counts_by_path["alexnet_engine"] = serve_alexnet(torch, q, model,
                                                     kernel_fns)
    del model, state

    # -- 6. the decoders on the card against a CPU copy ----------------------
    decoders_vs_cpu(torch, q, zoo, TD, LL, dev)

    # -- 13. the small decoders' engines, card against CPU ---------------------
    small_engines_vs_cpu(torch, q, zoo, TD, LL, dev)

    # -- 7. the decoder main path ---------------------------------------------
    dec, ids, counts_by_path["gpt2_small_ish_decode"] = decoder_main_path(
        torch, q, zoo, TD, kernel_fns, dev)
    decoder_timing(torch, dec, ids, args.profile)

    # -- 12. the gpt2 engine ---------------------------------------------------
    counts_by_path["gpt2_engine"] = serve_decoder(
        torch, dec, "gpt2", kernel_fns, profile=args.profile)
    bench_engine_load(torch, dec)
    del dec
    torch.cuda.empty_cache()

    # -- 9. the llama W4A8 main path ------------------------------------------
    (dec, ids, state,
     counts_by_path["llama_w4a8_generate"]) = llama_w4a8_main_path(
        torch, q, zoo, LL, W, A, kernel_fns, dev)
    decoder_timing(torch, dec, ids, args.profile, label="llama_w4a8_decode")
    counts_by_path["llama_w4a8_engine"] = serve_decoder(
        torch, dec, "llama_w4a8", kernel_fns, sampled_and_eos=False,
        profile=args.profile)
    full_context_timing(torch, q, dec,
                        "llama_w4a8_causal_forward_full_context", kernel_fns)
    del dec
    torch.cuda.empty_cache()

    # -- 10. the llama W4 weight-only forward ----------------------------------
    wo, counts_by_path["llama_w4_forward"] = llama_w4_forward_path(
        torch, q, zoo, W, kernel_fns, state, ids)
    llama_w4_timing(torch, q, wo, ids, args.profile)
    full_context_timing(torch, q, wo,
                        "llama_w4_weight_only_forward_full_context",
                        kernel_fns)
    del wo, state
    torch.cuda.empty_cache()

    # -- 11. per-kernel times --------------------------------------------------
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    flush = flush_buf.zero_
    time_launch_floor(torch, flush)
    rows = time_alexnet_gemms(torch, G, C, gen, dev, flush)
    rows += time_decode_kernels(torch, G, A, gen, dev, flush)
    rows += time_w4_kernels(torch, W, A, gen, dev, flush)
    log(json.dumps({"phase": "done", "seconds": time.perf_counter() - t_start}))

    log(smi)
    log(json.dumps({"kernels": kernels_line(rows, counts_by_path,
                                            max_err)}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
