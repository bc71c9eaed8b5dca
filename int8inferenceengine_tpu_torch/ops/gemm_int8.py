"""Quantized GEMM: u8 activations x s8 weights -> u8 outputs
(counterpart of ``int8inferenceengine_tpu.ops.gemm_int8``).

Activations are *unsigned* u8; the int8 tensor cores multiply s8 x s8.  The
kernel recenters them on the fly, ``a' = a - 128``, and the recentering term
folds into the per-output-channel offset the reference already computes for
zero-point correction:

    C[m,n] = sum_k (a[m,k]-128) * w[n,k]  +  (128 - zp_a) * rowsum_w[n]
             + trunc(q_bias[n] / s_a)                      <- bias in s32

Everything after the s32 accumulator is the reference's requant epilogue in
one of two float orders (``order``):

* ``"gemm"`` (Linear): ``q = f32(C) * mult[n] + zp_c`` with
  ``mult = s_a * s_w[n] / s_c`` computed once in float32 (``_mult_vector``);
* ``"conv"`` (Conv2d): ``q = f32(C) * s_a * s_w[n] / s_c + zp_c`` — the
  reference's ``down_scale`` association, which the JAX package's native
  integer conv uses.

then clip to [0, 255], +0.5 under 'nearest', truncate, optional ReLU at the
zero point.  ``epilogue_vector`` gives the f32 [N] vector each order reads
(``mult`` or ``s_w``), so the kernel and ``qgemm_plain`` share it as they
share ``oc``.

``act=(name, act_scale, act_zp)`` (gemm order only) folds a following
``QuantAct`` into the epilogue, as ``qgemm_xla`` does: the truncated code is
dequantized at (s_c, zp_c), ``ACTIVATIONS[name]`` is applied and the result
is requantized to (act_scale, act_zp) with a true division.

``qgemm_multi`` runs several weight heads that share one input (the
attention Q/K/V projections) as one GEMM over the merged ``[N_total, K]``
weight, with a per-column zero point: ``q = f32(acc + oc)*mult[n] + zp[n]``,
no relu, no act.  ``merge_parts`` builds its operands once.

``qgemm`` and ``qgemm_multi`` wrap the hand-written CUDA kernels
(``csrc/qgemm_int8.cu``: ``qgemm_u8s8`` and ``qgemm_u8s8_vzp``; its third
entry point, the gathered conv ``qgemm_u8s8_conv``, is wrapped by
``ops/conv.qgemm_conv``); ``qgemm_plain`` and ``qgemm_multi_plain`` are the
plain PyTorch versions of the same functions.  A wrapper takes the plain
version for a CPU tensor only; for a CUDA tensor it launches its kernel or
raises.  ``plan_qgemm`` decides each launch's tile and K split; the
launcher runs that plan or refuses it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .quant import down_scale, f32, quantize_u8

ORDERS = ("gemm", "conv")

# The kernel's output tiles (rows, columns), by the index the launcher takes
# (csrc/qgemm_int8.cu Tile<0..2>)
QGEMM_TILES = ((128, 128), (64, 64), (16, 64))
QGEMM_KSTEP = 32          # the MMA's k: every K slice is a multiple of it
QGEMM_MAX_SLICES = 8      # the slices of one tile form a portable cluster
# K values a slice keeps at least (three stages): shorter slices lose more
# to the cluster's reduction than they win (PERF.md)
QGEMM_MIN_SLICE = 384
H100_SMS = 132
# The loaders by the index the launcher takes, and the bytes each moves at
# once: a launch takes the widest that divides K (for a gathered conv also
# C) and every operand's base address
QGEMM_LOADERS = ("byte", "word", "cp.async")
_LOADER_BYTES = (1, 4, 16)


class ConvGeom(NamedTuple):
    """A convolution's u8 NHWC input [batch, h, w, c] and its kh x kw
    window, stride and padding."""
    batch: int
    h: int
    w: int
    c: int
    kh: int
    kw: int
    stride: int
    padding: int

    @property
    def out_hw(self) -> tuple[int, int]:
        return ((self.h + 2 * self.padding - self.kh) // self.stride + 1,
                (self.w + 2 * self.padding - self.kw) // self.stride + 1)

    @property
    def gemm_shape(self) -> tuple[int, int]:
        """(M, K) of the conv's patch GEMM."""
        oh, ow = self.out_hw
        return self.batch * oh * ow, self.kh * self.kw * self.c


def conv_gathered(geom: ConvGeom) -> bool:
    """Whether a conv's kernel launch gathers its patches from the NHWC
    input (the kernel's conv variant) rather than through im2col: every
    geometry, AlexNet conv1 (C = 3, padded to 4 channels) included, which
    the gathered kernel runs in half the time of im2col + B1 (PERF.md)."""
    return geom.c > 0


class QgemmPlan(NamedTuple):
    """One launch of the quantized GEMM kernel: ``variant`` 'gemm' (A is a
    u8 [M, K] matrix) or 'conv' (A gathered from the NHWC input); ``tile``
    one of ``QGEMM_TILES``; ``slices`` K slices of ``k_slice`` values each
    (the last one shorter), run as one thread block cluster; ``loader`` one
    of ``QGEMM_LOADERS``."""
    variant: str
    tile: tuple
    slices: int
    k_slice: int
    loader: str


def _loader(*units: int) -> int:
    """The index of the widest loader whose width divides all ``units``."""
    return max(i for i, width in enumerate(_LOADER_BYTES)
               if all(u % width == 0 for u in units))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan_qgemm(m: int, n: int, k: int, conv: ConvGeom | None = None,
               sms: int = H100_SMS) -> QgemmPlan:
    """The kernel's plan for an [M, K] x [N, K] launch on a card of ``sms``
    SMs.  The 16 x 64 tile (one m16 fragment) where M <= 16, or where even
    8 K slices of 64 x 64 tiles would not fill the SMs (M = 100, N = 10);
    the 128 x 128 tile where its grid fills the SMs; the 64 x 64 tile
    between.  A grid of fewer tiles than SMs splits K into as many slices
    as keep tiles x slices within two blocks an SM, at most
    ``QGEMM_MAX_SLICES``, each at least ``QGEMM_MIN_SLICE`` values and a
    multiple of ``QGEMM_KSTEP``.  ``conv``: the geometry whose patch matrix
    A is, gathered in the kernel where ``conv_gathered`` says so (planned
    with C padded to a multiple of 4, as ``ops/conv.qgemm_conv`` launches
    it)."""
    if min(m, n, k) <= 0:
        raise ValueError(f"plan_qgemm: empty GEMM M={m} N={n} K={k}")
    variant = "conv" if conv is not None and conv_gathered(conv) else "gemm"
    if variant == "conv":
        # the launch qgemm_conv makes: C padded to a multiple of 4
        conv = conv._replace(c=conv.c + -conv.c % 4)
        k = conv.gemm_shape[1]
    loader = _loader(k, conv.c) if variant == "conv" else _loader(k)
    loader = QGEMM_LOADERS[loader]
    if m <= 16 or _cdiv(m, 64) * _cdiv(n, 64) * QGEMM_MAX_SLICES < sms:
        tile = QGEMM_TILES[2]
    elif _cdiv(m, 128) * _cdiv(n, 128) >= sms:
        tile = QGEMM_TILES[0]
    else:
        tile = QGEMM_TILES[1]
    tiles = _cdiv(m, tile[0]) * _cdiv(n, tile[1])
    want = 1
    if tiles < sms:
        want = max(1, min(QGEMM_MAX_SLICES, k // QGEMM_MIN_SLICE,
                          2 * sms // tiles))
    k_slice = _cdiv(_cdiv(k, want), QGEMM_KSTEP) * QGEMM_KSTEP
    slices = _cdiv(k, k_slice)
    return QgemmPlan(variant, tile, slices, k if slices == 1 else k_slice,
                     loader)


_SMS: dict = {}


def sm_count(dev: torch.device) -> int:
    """The SMs of a CUDA device (cached)."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def launch_plan(plan: QgemmPlan, *operands: torch.Tensor) -> tuple:
    """The plan's launch arguments (tile index, slices, K per slice, loader
    index).  The loader's width must also divide every operand's base
    address (a view may start anywhere), so a narrower one may run."""
    loader = min(QGEMM_LOADERS.index(plan.loader),
                 _loader(*(t.data_ptr() for t in operands)))
    return QGEMM_TILES.index(plan.tile), plan.slices, plan.k_slice, loader


# Activations the kernel's act epilogue implements, with its ids
# (csrc/qgemm_int8.cu apply_act); the formulas are ops/functional.ACTIVATIONS.
KERNEL_ACTS = {"relu": 1, "relu6": 2, "hardsigmoid": 3, "hardswish": 4,
               "sigmoid": 5, "silu": 6, "gelu": 7}


def compute_offset(q_bias: torch.Tensor, rowsum_w: torch.Tensor,
                   scale_a: float, zp_a, *, recentered: bool) -> torch.Tensor:
    """Per-output-channel s32 offset: zero-point correction + bias fold
    (+128*rowsum when the kernel consumes recentered activations)."""
    base = 128 if recentered else 0
    zp_term = (base - int(zp_a)) * rowsum_w.to(torch.int32)
    bias_term = (q_bias.to(torch.float32) / f32(scale_a, q_bias.device)
                 ).to(torch.int32)
    return zp_term + bias_term


def _mult_vector(scale_a, scale_w, scale_c, n: int, device) -> torch.Tensor:
    """Requant multiplier ``s_a * s_w / s_c`` as an f32 [N] vector."""
    mult = (f32(scale_a, device) * f32(scale_w, device)
            / f32(scale_c, device))
    return mult.expand(n).contiguous()


def epilogue_vector(scale_a, scale_w, scale_c, n: int, device,
                    order: str = "gemm") -> torch.Tensor:
    """The f32 [N] vector the epilogue of ``order`` reads: ``mult`` for
    'gemm', ``s_w`` for 'conv'.  ``scale_w`` is a float or an [N] tensor."""
    if order == "gemm":
        return _mult_vector(scale_a, scale_w, scale_c, n, device)
    if order == "conv":
        return f32(scale_w, device).expand(n).contiguous()
    raise ValueError(f"unknown epilogue order {order!r}; one of {ORDERS}")


def _requant_epilogue(c: torch.Tensor, ep: torch.Tensor, *, scale_a,
                      scale_c, zp_c, relu=False, rounding: str = "trunc",
                      order: str = "gemm", act=None) -> torch.Tensor:
    """The requant tail on an s32 accumulator that already includes the
    offset vector.  ``ep`` is ``epilogue_vector(..., order=order)``."""
    if order == "conv":
        out = down_scale(c, scale_a, ep, scale_c, zp_c, rounding)
        return out.clamp_min(int(zp_c)) if relu else out
    q = c.to(torch.float32) * ep.reshape(1, -1) + f32(zp_c, c.device)
    q = torch.clamp(q, 0.0, 255.0)
    if rounding == "nearest":
        q = q + f32(0.5, c.device)
    qi = q.to(torch.int32)
    if act is not None:
        from .functional import ACTIVATIONS
        name, act_scale, act_zp = act
        x = ((qi.to(torch.float32) - f32(zp_c, c.device))
             * f32(scale_c, c.device))
        return quantize_u8(ACTIVATIONS[name](x), act_scale, act_zp, rounding)
    if relu:
        qi = qi.clamp_min(int(zp_c))
    return qi.to(torch.uint8)


def _accumulate(a_u8: torch.Tensor, w_s8_nk: torch.Tensor) -> torch.Tensor:
    """sum_k (a[m,k]-128) * w[n,k] as int32.  The product accumulates in
    float64, which is exact here (|acc| <= 128*127*K < 2**53) and runs on
    the CPU and on CUDA alike (PyTorch has no int32 matmul on CUDA)."""
    a = a_u8.to(torch.float64) - 128.0          # widen before recentering
    return torch.matmul(a, w_s8_nk.to(torch.float64).t()).to(torch.int32)


def qgemm_plain(a_u8: torch.Tensor, w_s8_nk: torch.Tensor, oc: torch.Tensor,
                ep: torch.Tensor, *, scale_a, scale_c, zp_c, relu=False,
                rounding: str = "trunc", order: str = "gemm", act=None
                ) -> torch.Tensor:
    """u8[M,K] x s8[N,K] (+oc[N]) -> u8[M,N], in plain PyTorch."""
    return _requant_epilogue(_accumulate(a_u8, w_s8_nk) + oc.reshape(1, -1),
                             ep, scale_a=scale_a, scale_c=scale_c, zp_c=zp_c,
                             relu=relu, rounding=rounding, order=order,
                             act=act)


def _check_act(act, relu, order):
    if act is None:
        return
    if relu:
        raise ValueError("act epilogue and fuse_relu are exclusive")
    if order != "gemm":
        raise ValueError("the act epilogue follows the gemm order only")
    if act[0] not in KERNEL_ACTS:
        raise ValueError(f"act {act[0]!r} has no kernel epilogue; one of "
                         f"{sorted(KERNEL_ACTS)}")


def _check_operands(a_u8, w_s8_nk, oc, ep, order):
    if a_u8.dtype != torch.uint8:
        raise TypeError(f"qgemm activations must be uint8 codes, got "
                        f"{a_u8.dtype}")
    if w_s8_nk.dtype != torch.int8:
        raise TypeError(f"qgemm weights must be int8, got {w_s8_nk.dtype}")
    if a_u8.dim() != 2 or w_s8_nk.dim() != 2 \
            or a_u8.shape[1] != w_s8_nk.shape[1]:
        raise ValueError(f"qgemm shapes: a {tuple(a_u8.shape)} vs w "
                         f"{tuple(w_s8_nk.shape)} (want [M,K] and [N,K])")
    n = w_s8_nk.shape[0]
    if oc.dtype != torch.int32 or tuple(oc.shape) != (n,):
        raise ValueError(f"oc must be int32 [{n}], got {oc.dtype} "
                         f"{tuple(oc.shape)}")
    if ep.dtype != torch.float32 or tuple(ep.shape) != (n,):
        raise ValueError(f"ep must be float32 [{n}], got {ep.dtype} "
                         f"{tuple(ep.shape)}")
    if order not in ORDERS:
        raise ValueError(f"unknown epilogue order {order!r}; one of {ORDERS}")


def _card_operands(fn: str, a_u8: torch.Tensor, *others):
    """The device of a CUDA launch (or None for the CPU), after checking
    that every operand lies on it and is contiguous."""
    dev = a_u8.device
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"{fn} runs on CUDA or CPU tensors, got {dev}")
    for i, t in enumerate((a_u8,) + others):
        if t.device != dev:
            raise ValueError(f"{fn}: operand {i} is on {t.device}, a on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: operand {i} must be contiguous")
    m, k = a_u8.shape
    n = others[0].shape[0]
    if max(m, n, k) >= 2 ** 31:
        raise ValueError(f"{fn}: shape M={m} N={n} K={k} too large")
    if k == 0:
        raise ValueError(f"{fn}: K must be positive")
    return dev


def qgemm(a_u8: torch.Tensor, w_s8_nk: torch.Tensor, oc: torch.Tensor,
          ep: torch.Tensor, *, scale_a, scale_c, zp_c, relu=False,
          rounding: str = "trunc", order: str = "gemm",
          act=None, plan: QgemmPlan | None = None) -> torch.Tensor:
    """u8[M,K] x s8[N,K] (+oc[N]) -> u8[M,N] requantized to (scale_c, zp_c),
    or to the act layer's grid under ``act=(name, act_scale, act_zp)``.

    On CUDA tensors this launches the hand-written kernel
    (``csrc/qgemm_int8.cu``) on the current stream, with ``plan`` (by
    default ``plan_qgemm``'s), and adds one to ``qgemm.launches``; on CPU
    tensors it is ``qgemm_plain``."""
    _check_operands(a_u8, w_s8_nk, oc, ep, order)
    _check_act(act, relu, order)
    dev = _card_operands("qgemm", a_u8, w_s8_nk, oc, ep)
    if dev is None:
        return qgemm_plain(a_u8, w_s8_nk, oc, ep, scale_a=scale_a,
                           scale_c=scale_c, zp_c=zp_c, relu=relu,
                           rounding=rounding, order=order, act=act)
    m, n, k = a_u8.shape[0], w_s8_nk.shape[0], a_u8.shape[1]
    out = torch.empty((m, n), dtype=torch.uint8, device=dev)
    if m == 0 or n == 0:
        return out
    act_id, act_scale, act_zp = 0, 1.0, 0.0
    if act is not None:
        act_id, act_scale, act_zp = KERNEL_ACTS[act[0]], act[1], act[2]
    plan = plan or plan_qgemm(m, n, k, sms=sm_count(dev))
    from ..kernels import load
    lib = load("qgemm_int8")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.qgemm_u8s8(
            a_u8.data_ptr(), w_s8_nk.data_ptr(), oc.data_ptr(), ep.data_ptr(),
            out.data_ptr(), m, n, k, float(scale_a), float(scale_c),
            int(zp_c), int(order == "conv"), int(bool(relu)),
            int(rounding == "nearest"), act_id, float(act_scale),
            float(act_zp), *launch_plan(plan, a_u8, w_s8_nk), stream)
    if rc != 0:
        raise RuntimeError(f"qgemm_u8s8 launch failed with CUDA error {rc} "
                           f"({plan})")
    qgemm.launches += 1
    return out


qgemm.launches = 0


# -- several weight heads sharing one input: one GEMM (kernel B2) ----------

def merge_parts(parts, *, scale_a, zp_a) -> dict:
    """The merged operands of ``qgemm_multi`` for input grid (scale_a, zp_a).

    ``parts``: dicts with ``w_s8_nk`` ([N_i, K] s8), ``rowsum`` ([N_i] s32),
    ``q_bias`` ([N_i] s8), ``scale_w`` (float or [N_i]), ``scale_c``,
    ``zp_c``; an ``oc`` key, when given, is taken instead of computing it.
    Returns ``w`` [N_total, K], ``oc`` s32, ``mult`` f32 and ``zp`` f32
    [N_total] and the part ``widths``.  A caller caches the result per input
    grid: the concatenation is not redone per call."""
    w = torch.cat([p["w_s8_nk"] for p in parts], dim=0).contiguous()
    dev = w.device
    oc = torch.cat([p["oc"] if "oc" in p else compute_offset(
        p["q_bias"], p["rowsum"], scale_a, zp_a, recentered=True)
        for p in parts]).contiguous()
    widths = [int(p["w_s8_nk"].shape[0]) for p in parts]
    mult = torch.cat([_mult_vector(scale_a, p["scale_w"], p["scale_c"], n,
                                   dev) for p, n in zip(parts, widths)])
    zp = torch.cat([f32(float(p["zp_c"]), dev).expand(n)
                    for p, n in zip(parts, widths)]).contiguous()
    return dict(w=w, oc=oc, mult=mult.contiguous(), zp=zp, widths=widths)


def _split(out: torch.Tensor, widths) -> list:
    return list(torch.split(out, widths, dim=1))


def vzp_epilogue(c: torch.Tensor, merged: dict,
                 rounding: str = "trunc") -> torch.Tensor:
    """The merged GEMM's requant tail on an s32 accumulator that already
    includes ``oc``: ``f32(c) * mult[n] + zp[n]``, clip, +0.5, truncate."""
    q = (c.to(torch.float32) * merged["mult"].reshape(1, -1)
         + merged["zp"].reshape(1, -1))
    q = torch.clamp(q, 0.0, 255.0)
    if rounding == "nearest":
        q = q + f32(0.5, c.device)
    return q.to(torch.int32).to(torch.uint8)


def qgemm_multi_plain(a_u8: torch.Tensor, merged: dict, *,
                      rounding: str = "trunc") -> list:
    """The merged GEMM in plain PyTorch: one u8 [M, N_i] output per part."""
    c = _accumulate(a_u8, merged["w"]) + merged["oc"].reshape(1, -1)
    return _split(vzp_epilogue(c, merged, rounding), merged["widths"])


def qgemm_multi(a_u8: torch.Tensor, merged: dict, *,
                rounding: str = "trunc",
                plan: QgemmPlan | None = None) -> list:
    """One GEMM over several heads sharing ``a_u8`` [M, K]; one u8 [M, N_i]
    output per part (column views of one [M, N_total] result), each equal
    to a ``qgemm`` call of that part alone.

    On CUDA tensors this launches ``qgemm_u8s8_vzp`` with ``plan`` (by
    default ``plan_qgemm``'s) and adds one to ``qgemm_multi.launches``; on
    CPU tensors it is ``qgemm_multi_plain``."""
    w, oc, mult, zp = merged["w"], merged["oc"], merged["mult"], merged["zp"]
    if a_u8.dtype != torch.uint8 or w.dtype != torch.int8:
        raise TypeError("qgemm_multi takes u8 activations and s8 weights")
    n = w.shape[0]
    if a_u8.dim() != 2 or a_u8.shape[1] != w.shape[1] or any(
            t.shape != (n,) for t in (oc, mult, zp)):
        raise ValueError(f"qgemm_multi shapes: a {tuple(a_u8.shape)}, w "
                         f"{tuple(w.shape)}")
    dev = _card_operands("qgemm_multi", a_u8, w, oc, mult, zp)
    if dev is None:
        return qgemm_multi_plain(a_u8, merged, rounding=rounding)
    m, k = a_u8.shape
    out = torch.empty((m, n), dtype=torch.uint8, device=dev)
    if m == 0:
        return _split(out, merged["widths"])
    plan = plan or plan_qgemm(m, n, k, sms=sm_count(dev))
    from ..kernels import load
    lib = load("qgemm_int8")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.qgemm_u8s8_vzp(
            a_u8.data_ptr(), w.data_ptr(), oc.data_ptr(), mult.data_ptr(),
            zp.data_ptr(), out.data_ptr(), m, n, k,
            int(rounding == "nearest"), *launch_plan(plan, a_u8, w), stream)
    if rc != 0:
        raise RuntimeError(f"qgemm_u8s8_vzp launch failed with CUDA error "
                           f"{rc} ({plan})")
    qgemm_multi.launches += 1
    return _split(out, merged["widths"])


qgemm_multi.launches = 0
