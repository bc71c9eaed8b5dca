"""INT4 grouped weights: packed nibbles + per-group scales, weight-only (W4)
and on the static u8 activation path (W4A8)
(counterpart of ``int8inferenceengine_tpu.ops.w4``).

Storage (Linear weight [N, K], K even), as the JAX package stores it:

    codes  = clip(round(w / s_g), -7, 7) + 8     in [1, 15], 0 unused
    packed = codes[:, 0::2] << 4 | codes[:, 1::2]      u8 [N, K//2]
    scales = max|w_group| / 7  (or the MSE-searched)   f32 [N, ceil(K/g)]

so the high nibble holds the even k, the low nibble the odd k, and the signed
code is nibble - 8 (widened first: u8 arithmetic wraps).

Three functions, each with a plain PyTorch version and a hand-written CUDA
kernel (``csrc/w4_gemm.cu``) behind one wrapper:

* **B5** ``w4_gemm`` (plain: ``w4_gemm_plain`` = ``w4_matmul_xla``): f32
  ``x @ dequant(W)^T + bias``, the weight-only Linear.  The kernel factors
  the group scale out, ``sum_g s_g * (sum_{k in g} x * code) + bias``, and
  forms every product exactly on bf16 tensor cores from three bf16 pieces
  of x (``split_bf16x3``); held to 2e-5 of the largest |output|.
* **B7** ``w4a8_v1`` (plain: ``w4a8_v1_plain`` = ``w4a8_matmul_xla``):
  ``acc = (x - zp_x) @ dequant(W)^T`` in f32, then
  ``floor(clip(acc * mult[n] + zpb[n], 0, 255) + rb)``.  The f32 sum order
  is free (the JAX package's kernel and its XLA twin differ in it): against
  its plain version it is held to at most 1 code off on at most 0.2%.  The
  kernel computes B6's arithmetic below on every shape, so it also equals
  ``w4a8_v2_plain`` bit for bit.
* **B6** ``w4a8_v2`` (plain: ``w4a8_v2_plain``): exact per-group integer
  partials ``I_g = sum_{k in g} (x - 128) * code``, folded in group order
  ``acc = I_0 * s_0; acc = acc + I_g * s_g`` in f32 (no FMA), then
  ``floor(clip(acc * mult[n] + zpb_eff[n], 0, 255) + rb)`` with
  ``zpb_eff = zpb + (mult * f32(128 - zp_x)) * wsum``.  Exact against its
  plain version.  ``plan_w4a8_v2`` decides each launch's K split over a
  thread block cluster, whose slice 0 adds a group's s32 partials over the
  slices before the fold; ``w4a8_v2_split_plain`` is the split's plain
  twin.

A wrapper takes the plain version for a CPU tensor only; for a CUDA tensor
it launches its kernel or raises, and adds one to its ``launches`` count.

Dispatch (``w4a8_matmul``/``w4a8_apply``, ``w4_matmul``), with the JAX
package's meaning of ``QuantConfig.w4_kernel``: ``'auto'`` and ``'pallas'``
run B6's function where ``M % 8 == 0``, ``M * groups <= 1024``, ``M <= 512``
and ``K % group == 0`` (the JAX v2 envelope) and the group is a multiple of
32 (the CUDA kernel's k-step; the JAX envelope takes any even group), B7's
function everywhere else -- the per-column ``mult`` of merged calls and
``M > 512`` included, which the JAX package sends to its XLA twin of the
same function.  ``'xla'`` runs B7's plain version on every shape and
device, as the JAX package's twin.  Weight-only ``w4_matmul`` runs B5
(``'xla'``: its plain version).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .gemm_int8 import H100_SMS, sm_count
from .quant import f32

__all__ = ["pack_w4", "dequant_w4", "unpack_codes", "split_bf16x3",
           "w4_gemm_plain", "w4_gemm", "w4a8_v1_plain", "w4a8_v1",
           "w4a8_v2_plain", "w4a8_v2_split_plain", "w4a8_v2",
           "plan_w4a8_v2", "W4A8Plan", "w4a8_operands", "merge_operands",
           "w4a8_apply", "w4a8_matmul", "w4a8_matmul_multi", "w4_matmul",
           "use_v2"]

BACKENDS = ("auto", "pallas", "xla")

# jnp.linspace(0.55, 1.0, 10) in float32, bit for bit (numpy's float64
# linspace rounds its third value one ULP lower)
_MSE_CANDIDATES = np.array(
    [0x3F0CCCCD, 0x3F19999A, 0x3F266667, 0x3F333333, 0x3F400000, 0x3F4CCCCD,
     0x3F59999A, 0x3F666666, 0x3F733333, 0x3F800000],
    dtype=np.uint32).view(np.float32)

# B6's k-step (csrc/w4_gemm.cu): a group boundary must fall on one
V2_GROUP_MULTIPLE = 32
# B6's block tile (rows of M, columns of N; csrc/w4_gemm.cu BM x BN), its
# ring (stages of V2_BK k values) and its K split: at most 8 slices (a
# portable cluster)
V2_TILE = (16, 64)
V2_BK, V2_STAGES = 256, 4
V2_MAX_SLICES = 8
# K values a block walks at most before K is split: a cluster's barriers
# cost about as much as a block's walk over 768 (PERF.md, the sweep), so
# K = 768 runs unsplit and K = 2,048 in 8 slices of 256
V2_SPLIT_K = 1024
SMEM_LIMIT = 227 * 1024


# the MSE scale search's largest candidate tensor, in values
MSE_SEARCH_VALUES = 1 << 28


def _mse_best(wg: torch.Tensor, scales: torch.Tensor, cands: torch.Tensor
              ) -> torch.Tensor:
    """Each group's index into ``cands`` with the least squared
    reconstruction error (``wg`` [N, G, g], ``scales`` [N, G]); the first
    of equal minima, as ``jnp.argmin``."""
    s_c = scales[None, :, :, None] * cands[:, None, None, None]
    q = torch.clamp(torch.round(wg[None] / s_c), -7.0, 7.0)
    err = torch.square(q * s_c - wg[None]).sum(dim=3)          # [C, N, G]
    return torch.argmin(err, dim=0)


def pack_w4(w: torch.Tensor, group: int = 128, optimize: bool = False):
    """Float [N, K] -> (packed u8 [N, K//2], scales f32 [N, ceil(K/g)]),
    g = min(group, K).  The last group may be short; odd K raises.
    ``optimize=True`` picks each group's scale among ten multiples of
    max/7 (0.55 ... 1.0) by least squared reconstruction error."""
    w = torch.as_tensor(w, dtype=torch.float32)
    n, k = w.shape
    if k % 2:
        raise ValueError(f"W4 packing needs even K, got {k}")
    g = min(group, k)
    n_groups = -(-k // g)
    pad = n_groups * g - k
    wg = torch.nn.functional.pad(w, (0, pad)).reshape(n, n_groups, g)
    dev = w.device
    scales = torch.clamp_min(wg.abs().amax(dim=2), 1e-8) / f32(7.0, dev)
    if optimize:
        cands = torch.tensor(_MSE_CANDIDATES, device=dev)
        # rows a pass: the [C, rows, G, g] candidate tensors stay within
        # MSE_SEARCH_VALUES (a 256,000-row head would need ~22 GB a tensor)
        rows = max(1, MSE_SEARCH_VALUES // (len(_MSE_CANDIDATES) * n_groups
                                            * g))
        best = torch.cat([_mse_best(wg[r:r + rows], scales[r:r + rows], cands)
                          for r in range(0, n, rows)])
        scales = scales * cands[best]
    codes = torch.clamp(torch.round(wg / scales[:, :, None]), -7.0, 7.0) + 8
    codes = codes.reshape(n, n_groups * g)[:, :k].to(torch.uint8)
    packed = (codes[:, 0::2] << 4) | codes[:, 1::2]
    return packed.contiguous(), scales.contiguous()


def unpack_codes(packed: torch.Tensor, k: int) -> torch.Tensor:
    """Packed u8 [N, K//2] -> signed int32 codes [N, K] (nibble - 8)."""
    p = packed.to(torch.int32)                  # widen before subtracting
    hi = (p >> 4) - 8
    lo = (p & 0x0F) - 8
    return torch.stack([hi, lo], dim=2).reshape(packed.shape[0], -1)[:, :k]


def dequant_w4(packed: torch.Tensor, scales: torch.Tensor, k: int,
               group: int = 128) -> torch.Tensor:
    """(packed, scales) -> float32 [N, K]: code * its group's scale."""
    n = packed.shape[0]
    g = min(group, k)
    n_groups = scales.shape[1]
    codes = torch.nn.functional.pad(unpack_codes(packed, k),
                                    (0, n_groups * g - k))
    w = codes.reshape(n, n_groups, g).to(torch.float32) * scales[:, :, None]
    return w.reshape(n, n_groups * g)[:, :k]


def weight_rowsum(packed, scales, k: int, group: int) -> torch.Tensor:
    """Row sums of the dequantized weight, f32 [N] (B6's zero-point fold):
    accumulated in float64 and rounded once, so that the card and the CPU
    give the same value whatever order their reductions add in."""
    w = dequant_w4(packed, scales, k, group)
    return w.to(torch.float64).sum(dim=1).to(torch.float32)


# -- B5: W4 weight-only -------------------------------------------------------

def split_bf16x3(x: torch.Tensor):
    """f32 -> bf16 (hi, mid, lo) with ``hi + mid + lo == x`` exactly, B5's
    in-kernel split: each piece is the top 16 bits of what is left of x.
    Both subtractions are exact, and the last remainder has at most 8
    significant bits, so it is a bf16 too.  Exact wherever the remainders
    stay normal floats (|x| >= 2^-110 or x a bf16); FLT_MAX included."""
    # 0xFFFF0000 as an int32
    top = torch.tensor(-65536, dtype=torch.int32, device=x.device)
    x = x.to(torch.float32).contiguous()
    hi = (x.view(torch.int32) & top).view(torch.float32)
    rest = x - hi
    mid = (rest.view(torch.int32) & top).view(torch.float32)
    lo = rest - mid
    return tuple(p.to(torch.bfloat16) for p in (hi, mid, lo))


def w4_gemm_plain(x, packed, scales, bias, k: int, group: int = 128):
    """f32 ``x [M, K] @ dequant(W)^T + bias`` (``w4_matmul_xla``)."""
    w = dequant_w4(packed, scales, k, group)
    return torch.matmul(x, w.t()) + bias.reshape(1, -1)


# -- B7: W4A8 over f32-dequantized weights ------------------------------------

def w4a8_v1_plain(x_u8, packed, scales, zpb, k: int, group: int = 128, *,
                  zp_x: int, mult, rounding: str = "trunc"):
    """u8 [M, K] codes @ W4^T -> u8 [M, N] (``w4a8_matmul_xla``): ``mult``
    is an f32 scalar or an [N] vector, ``zpb`` f32 [N]."""
    dev = x_u8.device
    w = dequant_w4(packed, scales, k, group)
    xf = x_u8.to(torch.float32) - f32(float(zp_x), dev)
    acc = torch.matmul(xf, w.t())
    m = f32(mult if isinstance(mult, torch.Tensor) else float(mult), dev)
    if m.dim():
        m = m.reshape(1, -1)
    codes = torch.clamp(acc * m + zpb.reshape(1, -1), 0.0, 255.0)
    rb = f32(0.5 if rounding == "nearest" else 0.0, dev)
    return torch.floor(codes + rb).to(torch.uint8)


# -- B6: W4A8 with exact per-group integer partials ---------------------------

def w4a8_v2_plain(x_u8, packed, scales_t, mult_v, zpb_eff, k: int,
                  group: int, rounding: str = "trunc"):
    """B6's function: ``scales_t`` f32 [G, N] (the group scales transposed),
    ``mult_v`` and ``zpb_eff`` f32 [N].  Any M, any group g = min(group,
    K): a short last group is zero-padded (padding adds nothing)."""
    m, n = x_u8.shape[0], packed.shape[0]
    g = min(group, k)
    n_groups = -(-k // g)
    pad = (0, n_groups * g - k)
    xg = torch.nn.functional.pad(x_u8.to(torch.float64) - 128.0,
                                 pad).reshape(m, n_groups, g)
    cg = torch.nn.functional.pad(unpack_codes(packed, k).to(torch.float64),
                                 pad).reshape(n, n_groups, g)
    # exact integers in float64: |I_g| <= 128 * 8 * group
    ints = torch.bmm(xg.permute(1, 0, 2), cg.permute(1, 2, 0)).to(
        torch.float32)                                       # [G, M, N]
    return _v2_epilogue(ints, scales_t, mult_v, zpb_eff, rounding)


def _v2_epilogue(ints, scales_t, mult_v, zpb_eff, rounding):
    """B6's fold of the exact group partials ``ints`` f32 [G, M, N] in group
    order, then its requantization."""
    acc = ints[0] * scales_t[0].reshape(1, -1)
    for gi in range(1, ints.shape[0]):
        acc = acc + ints[gi] * scales_t[gi].reshape(1, -1)
    codes = torch.clamp(acc * mult_v.reshape(1, -1) + zpb_eff.reshape(1, -1),
                        0.0, 255.0)
    rb = f32(0.5 if rounding == "nearest" else 0.0, ints.device)
    return torch.floor(codes + rb).to(torch.uint8)


class W4A8Plan(NamedTuple):
    """One launch of B6: ``tile`` the kernel's block tile ``V2_TILE`` (rows of
    M, columns of N); ``orientation`` 'swapped', the kernel's one: out^T =
    W x^T, the weight codes the MMA's 16-row A operand and the batch rows
    its n8 B operand; ``slices`` K slices of ``k_slice`` values each, run
    as one thread block cluster."""
    tile: tuple
    orientation: str
    slices: int
    k_slice: int


def v2_slice_counts(k: int, group: int) -> list:
    """The K splits B6 can run: the slices divide K evenly, each a multiple
    of the k-step and either a whole number of groups or a whole fraction of
    one, so that every slice keeps exact partials of whole groups or of one
    group's part."""
    out = []
    for s in range(1, V2_MAX_SLICES + 1):
        ks = k // s
        if k % s == 0 and ks % V2_GROUP_MULTIPLE == 0 and (
                group % ks == 0 or ks % group == 0):
            out.append(s)
    return out


def v2_smem_bytes(plan: W4A8Plan, group: int) -> int:
    """B6's dynamic shared memory (``csrc/w4_gemm.cu`` ``smem_bytes``): the
    ring (x rows padded to BK + 32 bytes, packed rows to BK/2 + 16) and,
    for a K split, the tile's mult, zpb_eff and every group's scales and
    each slice's s32 partials of the groups it touches."""
    rows, cols = plan.tile
    ring = V2_STAGES * (rows * (V2_BK + 32) + cols * (V2_BK // 2 + 16))
    if plan.slices == 1:
        return ring
    n_groups = plan.k_slice * plan.slices // group
    part_groups = max(1, plan.k_slice // group)
    return ring + (2 + n_groups) * cols * 4 + part_groups * rows * cols * 4


def check_w4a8_plan(plan: W4A8Plan, m: int, n: int, k: int, group: int):
    """Raise ValueError for a plan the kernel cannot run."""
    if plan.tile != V2_TILE or plan.orientation != "swapped" or \
            plan.slices not in v2_slice_counts(k, group) or \
            plan.k_slice * plan.slices != k or \
            v2_smem_bytes(plan, group) > SMEM_LIMIT:
        raise ValueError(f"B6 cannot run {plan} at M={m} N={n} K={k} "
                         f"group={group}")


def plan_w4a8_v2(m: int, n: int, k: int, group: int,
                 sms: int = H100_SMS) -> W4A8Plan:
    """B6's plan for an [M, K] x [N, K] launch on a card of ``sms`` SMs:
    K unsplit up to ``V2_SPLIT_K``, longer K split into the most slices
    ``v2_slice_counts`` allows that keep tiles x slices within two blocks
    an SM."""
    if min(m, n, k) <= 0 or k % group or group % V2_GROUP_MULTIPLE:
        raise ValueError(f"plan_w4a8_v2: M={m} N={n} K={k} group={group} "
                         f"is outside B6's envelope")
    tile = V2_TILE
    tiles = -(-m // tile[0]) * -(-n // tile[1])
    slices = 1
    if k > V2_SPLIT_K:
        for s in v2_slice_counts(k, group):
            plan = W4A8Plan(tile, "swapped", s, k // s)
            if tiles * s <= 2 * sms and \
                    v2_smem_bytes(plan, group) <= SMEM_LIMIT:
                slices = s
    return W4A8Plan(tile, "swapped", slices, k // slices)


def w4a8_v2_split_plain(x_u8, packed, scales_t, mult_v, zpb_eff, k: int,
                        group: int, rounding: str = "trunc",
                        slices: int = 1):
    """The plain twin of B6's K split: each of ``slices`` equal K slices
    forms the exact s32 partials of the groups it touches, a group's
    partials add over the slices in s32, and the f32 fold runs over the
    groups in order (``_v2_epilogue``).  Equal bit for bit to
    ``w4a8_v2_plain`` at every split ``v2_slice_counts`` allows."""
    if slices not in v2_slice_counts(k, group):
        raise ValueError(f"no B6 split of K={k} into {slices} slices at "
                         f"group {group}")
    m, n = x_u8.shape[0], packed.shape[0]
    ks = k // slices
    xs = x_u8.to(torch.float64) - 128.0
    codes = unpack_codes(packed, k).to(torch.float64)
    ints = torch.zeros((k // group, m, n), dtype=torch.int64,
                       device=x_u8.device)
    for r in range(slices):
        for lo in range(r * ks, (r + 1) * ks, min(ks, group)):
            hi = lo + min(ks, group)
            # exact in float64: |partial| <= 128 * 8 * group
            part = torch.matmul(xs[:, lo:hi], codes[:, lo:hi].t())
            ints[lo // group] += part.to(torch.int64)
    return _v2_epilogue(ints.to(torch.float32), scales_t, mult_v, zpb_eff,
                        rounding)


# -- operands -----------------------------------------------------------------

def w4a8_operands(packed, scales, zpb, k: int, group: int, *, zp_x: int,
                  mult, wsum=None, widths=None) -> dict:
    """Everything a W4A8 call reads for one input grid, built once: the
    caller caches it (in the JAX package these are hoisted out of the
    decode scan).  ``mult`` is f32 scalar or [N]; ``wsum`` defaults to the
    weight's row sums."""
    dev = packed.device
    n = packed.shape[0]
    m = f32(mult if isinstance(mult, torch.Tensor) else float(mult), dev)
    mult_v = m.reshape(-1).expand(n).contiguous()
    if wsum is None:
        wsum = weight_rowsum(packed, scales, k, group)
    # the JAX wrapper's order: (mult * f32(128 - zp_x)) * wsum, then + zpb
    zpb_eff = zpb + mult_v * f32(float(128 - int(zp_x)), dev) * wsum
    return dict(packed=packed.contiguous(), scales=scales.contiguous(),
                scales_t=scales.t().contiguous(), zpb=zpb.contiguous(),
                mult_v=mult_v, zpb_eff=zpb_eff.contiguous(), k=int(k),
                group=int(group), zp_x=int(zp_x),
                widths=[n] if widths is None else list(widths))


def merge_operands(ops_list) -> dict:
    """The operands of several layers sharing one input, concatenated along
    N: each column keeps its own layer's arithmetic (per-column mult and
    zpb), so the merged call equals the per-layer calls."""
    first = ops_list[0]
    for o in ops_list[1:]:
        if (o["k"], o["group"], o["zp_x"]) != (first["k"], first["group"],
                                               first["zp_x"]):
            raise ValueError("merged W4A8 layers must share K, group and "
                             "the input grid")
    out = dict(k=first["k"], group=first["group"], zp_x=first["zp_x"],
               widths=[w for o in ops_list for w in o["widths"]])
    for key in ("packed", "scales", "zpb", "mult_v", "zpb_eff"):
        out[key] = torch.cat([o[key] for o in ops_list], dim=0).contiguous()
    out["scales_t"] = torch.cat([o["scales_t"] for o in ops_list],
                                dim=1).contiguous()
    return out


def use_v2(m: int, k: int, group: int, n_groups: int) -> bool:
    """The JAX package's v2 envelope (M <= 512 and K % group == 0 from its
    dispatch, M % 8 == 0 and M * groups <= 1024 from its wrapper), with the
    group a multiple of B6's k-step."""
    return (k % group == 0 and group % V2_GROUP_MULTIPLE == 0 and m <= 512
            and m % 8 == 0 and m * n_groups <= 1024)


# -- the kernel wrappers --------------------------------------------------------

def _card(fn: str, *tensors):
    """The CUDA device of a launch (None for CPU tensors), after checking
    that every operand lies on it and is contiguous."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"{fn} runs on CUDA or CPU tensors, got {dev}")
    for i, t in enumerate(tensors):
        if t.device != dev:
            raise ValueError(f"{fn}: operand {i} is on {t.device}, not {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: operand {i} must be contiguous")
    return dev


def _check_w4(fn, x, packed, scales, k, group, x_dtype):
    if x.dtype != x_dtype:
        raise TypeError(f"{fn} takes {x_dtype} activations, got {x.dtype}")
    if packed.dtype != torch.uint8 or scales.dtype != torch.float32:
        raise TypeError(f"{fn} takes u8 packed weights and f32 scales")
    if x.dim() != 2 or x.shape[1] != k or k % 2 or \
            tuple(packed.shape[1:]) != (k // 2,):
        raise ValueError(f"{fn} shapes: x {tuple(x.shape)}, packed "
                         f"{tuple(packed.shape)}, K={k}")
    g = min(group, k)
    if scales.shape != (packed.shape[0], -(-k // g)):
        raise ValueError(f"{fn}: scales {tuple(scales.shape)} do not match "
                         f"N={packed.shape[0]}, K={k}, group={group}")
    if max(x.shape[0], packed.shape[0], k) >= 2 ** 31 or \
            x.shape[0] * k >= 2 ** 31 or packed.shape[0] * k >= 2 ** 31:
        raise ValueError(f"{fn}: shape too large for int32 offsets")
    return g


def _launch(name: str, *args):
    from ..kernels import load
    lib = load("w4_gemm")
    rc = getattr(lib, name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def w4_gemm(x, packed, scales, bias, k: int, group: int = 128):
    """B5: f32 [M, K] x packed W4 [N, K/2] + bias -> f32 [M, N].  On CUDA
    tensors this launches ``w4_gemm`` (``csrc/w4_gemm.cu``) and adds one to
    ``w4_gemm.launches``; on CPU tensors it is ``w4_gemm_plain``."""
    g = _check_w4("w4_gemm", x, packed, scales, k, group, torch.float32)
    n = packed.shape[0]
    if bias.dtype != torch.float32 or tuple(bias.shape) != (n,):
        raise ValueError(f"w4_gemm: bias must be f32 [{n}]")
    dev = _card("w4_gemm", x, packed, scales, bias)
    if dev is None:
        return w4_gemm_plain(x, packed, scales, bias, k, group)
    out = torch.empty((x.shape[0], n), dtype=torch.float32, device=dev)
    if x.shape[0] == 0 or n == 0:
        return out
    with torch.cuda.device(dev):
        _launch("w4_gemm", x.data_ptr(), packed.data_ptr(),
                scales.data_ptr(), bias.data_ptr(), out.data_ptr(),
                x.shape[0], n, k, g, _stream(dev))
    w4_gemm.launches += 1
    return out


w4_gemm.launches = 0


def w4a8_v1(x_u8, ops: dict, rounding: str = "trunc"):
    """B7 on the operands ``ops`` (``w4a8_operands``): u8 [M, K] -> u8
    [M, N].  On CUDA tensors this launches ``w4a8_v1_gemm``, which computes
    ``w4a8_v2_plain``'s arithmetic on ``scales_t``, ``mult_v`` and
    ``zpb_eff``, and adds one to ``w4a8_v1.launches`` (and to
    ``w4a8_v1.merged_launches`` for a merged call); on CPU tensors it is
    ``w4a8_v1_plain``."""
    k, group = ops["k"], ops["group"]
    packed, scales, scales_t = ops["packed"], ops["scales"], ops["scales_t"]
    g = _check_w4("w4a8_v1", x_u8, packed, scales, k, group, torch.uint8)
    dev = _card("w4a8_v1", x_u8, packed, scales_t, ops["mult_v"],
                ops["zpb_eff"])
    if dev is None:
        return w4a8_v1_plain(x_u8, packed, scales, ops["zpb"], k, group,
                             zp_x=ops["zp_x"], mult=ops["mult_v"],
                             rounding=rounding)
    n = packed.shape[0]
    if tuple(scales_t.shape) != (scales.shape[1], n):
        raise ValueError(f"w4a8_v1: scales_t {tuple(scales_t.shape)} is "
                         f"not the transpose of scales "
                         f"{tuple(scales.shape)}")
    out = torch.empty((x_u8.shape[0], n), dtype=torch.uint8, device=dev)
    if x_u8.shape[0] == 0 or n == 0:
        return out
    with torch.cuda.device(dev):
        _launch("w4a8_v1_gemm", x_u8.data_ptr(), packed.data_ptr(),
                scales_t.data_ptr(), ops["mult_v"].data_ptr(),
                ops["zpb_eff"].data_ptr(), out.data_ptr(), x_u8.shape[0], n,
                k, g, int(rounding == "nearest"), _stream(dev))
    w4a8_v1.launches += 1
    if len(ops["widths"]) > 1:
        w4a8_v1.merged_launches += 1
    return out


w4a8_v1.launches = 0
w4a8_v1.merged_launches = 0


def w4a8_v2(x_u8, ops: dict, rounding: str = "trunc",
            plan: W4A8Plan | None = None):
    """B6 on the operands ``ops``: u8 [M, K] -> u8 [M, N], K % group == 0
    and group % 32 == 0.  On CUDA tensors this launches ``w4a8_v2_gemm``
    with ``plan`` (by default ``plan_w4a8_v2``'s; one it cannot run raises)
    and adds one to ``w4a8_v2.launches``; on CPU tensors it is
    ``w4a8_v2_plain``."""
    k, group = ops["k"], ops["group"]
    packed, scales_t = ops["packed"], ops["scales_t"]
    if x_u8.dtype != torch.uint8 or packed.dtype != torch.uint8:
        raise TypeError("w4a8_v2 takes u8 activations and packed weights")
    n = packed.shape[0]
    if x_u8.dim() != 2 or x_u8.shape[1] != k or \
            tuple(packed.shape) != (n, k // 2) or \
            tuple(scales_t.shape) != (k // max(group, 1), n) or \
            k % group or group % V2_GROUP_MULTIPLE:
        raise ValueError(f"w4a8_v2 shapes: x {tuple(x_u8.shape)}, packed "
                         f"{tuple(packed.shape)}, scales_t "
                         f"{tuple(scales_t.shape)}, K={k}, group={group}")
    dev = _card("w4a8_v2", x_u8, packed, scales_t, ops["mult_v"],
                ops["zpb_eff"])
    if dev is None:
        return w4a8_v2_plain(x_u8, packed, scales_t, ops["mult_v"],
                             ops["zpb_eff"], k, group, rounding)
    m = x_u8.shape[0]
    if m * k >= 2 ** 31 or n * k >= 2 ** 31:
        raise ValueError("w4a8_v2: shape too large for int32 offsets")
    # 16-byte cp.async rows
    if x_u8.data_ptr() % 16:
        x_u8 = x_u8.clone()
    if packed.data_ptr() % 16:
        packed = packed.clone()
    out = torch.empty((m, n), dtype=torch.uint8, device=dev)
    if m == 0 or n == 0:
        return out
    plan = plan or plan_w4a8_v2(m, n, k, group, sms=sm_count(dev))
    check_w4a8_plan(plan, m, n, k, group)
    with torch.cuda.device(dev):
        _launch("w4a8_v2_gemm", x_u8.data_ptr(), packed.data_ptr(),
                scales_t.data_ptr(), ops["mult_v"].data_ptr(),
                ops["zpb_eff"].data_ptr(), out.data_ptr(), m, n, k, group,
                int(rounding == "nearest"), plan.slices, plan.k_slice,
                _stream(dev))
    w4a8_v2.launches += 1
    return out


w4a8_v2.launches = 0


# -- dispatch -------------------------------------------------------------------

def w4a8_apply(x_u8, ops: dict, *, backend: str = "auto",
               rounding: str = "trunc") -> torch.Tensor:
    """The W4A8 GEMM on prepared operands, dispatched as the module
    docstring says; u8 [M, sum(widths)]."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown w4_kernel {backend!r}; one of {BACKENDS}")
    if backend == "xla":
        return w4a8_v1_plain(x_u8, ops["packed"], ops["scales"], ops["zpb"],
                             ops["k"], ops["group"], zp_x=ops["zp_x"],
                             mult=ops["mult_v"], rounding=rounding)
    if use_v2(x_u8.shape[0], ops["k"], ops["group"],
              ops["scales"].shape[1]):
        return w4a8_v2(x_u8, ops, rounding)
    return w4a8_v1(x_u8, ops, rounding)


def w4a8_matmul(x_u8, packed, scales, zpb, k: int, group: int = 128,
                backend: str = "auto", *, zp_x: int, mult,
                rounding: str = "trunc", wsum=None) -> torch.Tensor:
    """u8 [M, K] codes @ W4^T -> u8 [M, N] codes at (zpb = zp_out + bias /
    s_out, mult = s_x / s_out); the JAX package's signature."""
    ops = w4a8_operands(packed, scales, zpb, k, group, zp_x=zp_x, mult=mult,
                        wsum=wsum)
    return w4a8_apply(x_u8, ops, backend=backend, rounding=rounding)


def w4a8_matmul_multi(x_u8, parts, k: int, group: int = 128, *, zp_x: int,
                      rounding: str = "trunc", backend: str = "auto"):
    """Several W4A8 Linears sharing ``x_u8`` as one call; ``parts`` are
    dicts with packed, scales, zpb, mult, wsum.  One u8 output per part,
    each equal to that part's own call."""
    ops = merge_operands([
        w4a8_operands(p["packed"], p["scales"], p["zpb"], k, group,
                      zp_x=zp_x, mult=p["mult"], wsum=p.get("wsum"))
        for p in parts])
    out = w4a8_apply(x_u8, ops, backend=backend, rounding=rounding)
    return list(torch.split(out, ops["widths"], dim=1))


def w4_matmul(x, packed, scales, bias, k: int, group: int = 128,
              backend: str = "auto") -> torch.Tensor:
    """Weight-only dispatch: 'auto'/'pallas' run B5 (its kernel on a CUDA
    tensor), 'xla' its plain version on any device."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown w4_kernel {backend!r}; one of {BACKENDS}")
    if backend == "xla":
        return w4_gemm_plain(x, packed, scales, bias, k, group)
    return w4_gemm(x, packed, scales, bias, k, group)
