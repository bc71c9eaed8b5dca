"""Convolution paths (counterpart of ``int8inferenceengine_tpu.ops.conv``).

* ``conv2d_fp32``      — ``torch.nn.functional.conv2d`` + bias, NCHW
  (grouped when ``groups`` > 1).
* ``conv2d_int8_gemm`` — the quantized conv as a GEMM over its patch
  matrix.  On a CUDA tensor with ``gemm=qgemm`` it launches the gathered
  conv (``qgemm_conv``: kernel B1's conv variant, whose loader reads each
  patch straight from the u8 NHWC input) wherever ``conv_gathered`` says so;
  otherwise it is batched im2col (static strided slices on the u8 codes)
  feeding ``gemm``.  Stock PyTorch has no CUDA int8 convolution.  With the
  'conv' epilogue order it is bit-identical to the JAX package's native
  integer conv (``conv2d_int8_xla``): the integer accumulators are identical
  and the epilogue replays ``down_scale``'s float order.
* ``conv2d_int8_grouped`` — the grouped (depthwise) quantized conv.  On a
  CUDA tensor it launches kernel G1 (``csrc/conv_grouped.cu``), which has
  no Pallas counterpart: the JAX package leaves grouped convs to XLA's
  native integer conv (``conv2d_int8_xla`` with ``feature_group_count``);
  ``conv2d_int8_grouped_plain`` is its plain version.  A grouped conv is
  never space-to-depth'ed.
* ``s2d_input`` / ``s2d_weights`` — the JAX package's space-to-depth
  halves.  The input half runs on the host (the ingest pre-layout,
  ``native.s2d_quantized``'s plain version); a pre-laid-out input then runs
  as a stride-1 conv over ``s*s*C`` channels on the weight half
  (``layers.Conv2d``: B1's gathered conv on the card).
  ``QuantConfig(conv_backend='xla_conv')`` is another name for 'auto'
  here, as in the JAX package, whose 'auto' is its integer conv.

Every quantized conv but the GEMM-order one also runs the bfloat16
epilogue order (``epilogue_vector(..., order='conv_bf16')``) under
``QuantConfig(epilogue_dtype='bfloat16')``: B1's gathered conv and G1 have
a kernel instance of it.

Zero-point padding parity: the reference pads the patch matrix with the
activation zero_point, so padded taps contribute nothing after zero-point
correction.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .gemm_int8 import (ORDERS, ConvGeom, _card_operands, _check_operands,
                        _requant_epilogue, conv_gathered, launch_plan,
                        plan_qgemm, qgemm, qgemm_plain, sm_count)


def conv2d_fp32(x_nchw: torch.Tensor, w_oihw: torch.Tensor,
                bias: torch.Tensor, stride: int, padding: int,
                groups: int = 1) -> torch.Tensor:
    """FP32 convolution + bias in NCHW, grouped when ``groups`` > 1 (bias
    added after the conv, as the JAX package does)."""
    out = F.conv2d(x_nchw, w_oihw, None, stride=stride, padding=padding,
                   groups=groups)
    return out + bias.reshape(1, -1, 1, 1)


def windows_nhwc(x_nhwc: torch.Tensor, kh: int, kw: int,
                 stride: int) -> torch.Tensor:
    """The [n, oh, ow, kh, kw, c] view of every (VALID) window: each
    (l, m) tap is the strided slice x[:, l::stride, m::stride, :]."""
    n, h, w, c = x_nhwc.shape
    sn, sh, sw, sc = x_nhwc.stride()
    oh = (h - kh) // stride + 1
    ow = (w - kw) // stride + 1
    return x_nhwc.as_strided((n, oh, ow, kh, kw, c),
                             (sn, sh * stride, sw * stride, sh, sw, sc))


def im2col_nhwc(x_nhwc: torch.Tensor, kh: int, kw: int, stride: int,
                padding: int, pad_value=0) -> torch.Tensor:
    """Patch extraction: the kh*kw strided window slices, copied once.

    Returns [n, oh, ow, kh*kw*c] with patch element order
    ((l*kw + m)*c + ch); the weight is reordered to match at convert time
    (OIHW -> [O, kh*kw*I])."""
    if padding:
        x_nhwc = F.pad(x_nhwc, (0, 0, padding, padding, padding, padding),
                       value=pad_value)
    win = windows_nhwc(x_nhwc, kh, kw, stride)
    n, oh, ow, _, _, c = win.shape
    return win.reshape(n, oh, ow, kh * kw * c)


def s2d_input(x: np.ndarray, kh: int, kw: int, stride: int, pad_value):
    """Space-to-depth input half on the host: u8 [n,h,w,c] ->
    [n,hp/s,wp/s,s*s*c].

    ``x`` is the (already zp-padded) conv input as a numpy array (the
    host-side ingest pre-layout: ``native.s2d_quantized``'s plain version).
    Each spatial dim is sliced or padded (with ``pad_value``) to exactly
    ``s * (out + ceil(k/s) - 1)``: a stride-s VALID conv then equals a
    stride-1 conv of the result with ``s2d_weights``, because input
    positions beyond the original read range only meet zero weight taps."""
    n, h, w, c = x.shape
    s = stride
    kp_h, kp_w = -(-kh // s), -(-kw // s)
    hp, wp = s * ((h - kh) // s + kp_h), s * ((w - kw) // s + kp_w)
    x = x[:, :hp, :wp, :]
    if hp > x.shape[1] or wp > x.shape[2]:
        x = np.pad(x, ((0, 0), (0, hp - x.shape[1]), (0, wp - x.shape[2]),
                       (0, 0)), constant_values=pad_value)
    xb = x.reshape(n, hp // s, s, wp // s, s, c).transpose(0, 1, 3, 2, 4, 5)
    return xb.reshape(n, hp // s, wp // s, s * s * c)


def s2d_weights(w_hwio: torch.Tensor, stride: int) -> torch.Tensor:
    """Space-to-depth weight half: [kh,kw,c,o] -> [kp_h,kp_w,s*s*c,o], the
    taps past the window zero."""
    kh, kw, c, o = w_hwio.shape
    s = stride
    kp_h, kp_w = -(-kh // s), -(-kw // s)
    wpad = F.pad(w_hwio, (0, 0, 0, 0, 0, kp_w * s - kw, 0, kp_h * s - kh))
    wb = wpad.reshape(kp_h, s, kp_w, s, c, o)
    return wb.permute(0, 2, 1, 3, 4, 5).reshape(kp_h, kp_w, s * s * c, o)


def conv2d_int8_gemm(x_u8_nhwc: torch.Tensor, qw_nk: torch.Tensor,
                     oc: torch.Tensor, ep: torch.Tensor, *, kh: int, kw: int,
                     stride: int, padding: int, scale_a, zp_a, scale_c, zp_c,
                     relu=False, rounding: str = "trunc",
                     order: str = "conv", gemm=qgemm) -> torch.Tensor:
    """Quantized conv as the quantized GEMM over its patch matrix
    (``gemm``: ``qgemm`` or its plain version); returns u8 NHWC.

    ``qw_nk`` is the weight as [O, kh*kw*I]; ``oc``/``ep`` as for
    ``qgemm``.  On CUDA with ``gemm=qgemm`` a geometry that
    ``conv_gathered`` takes runs the gathered conv (``qgemm_conv``), never
    im2col."""
    kw_ = dict(scale_a=scale_a, scale_c=scale_c, zp_c=zp_c, relu=relu,
               rounding=rounding, order=order)
    if gemm is qgemm and x_u8_nhwc.device.type == "cuda" and conv_gathered(
            ConvGeom(*x_u8_nhwc.shape, kh, kw, stride, padding)):
        return qgemm_conv(x_u8_nhwc, qw_nk, oc, ep, kh=kh, kw=kw,
                          stride=stride, padding=padding, zp_a=zp_a, **kw_)
    n = x_u8_nhwc.shape[0]
    patches = im2col_nhwc(x_u8_nhwc, kh, kw, stride, padding,
                          pad_value=int(zp_a))
    _, oh, ow, k = patches.shape
    out = gemm(patches.reshape(n * oh * ow, k), qw_nk, oc, ep, **kw_)
    return out.reshape(n, oh, ow, -1)


def qgemm_conv(x_u8_nhwc: torch.Tensor, qw_nk: torch.Tensor, oc: torch.Tensor,
               ep: torch.Tensor, *, kh: int, kw: int, stride: int,
               padding: int, scale_a, zp_a, scale_c, zp_c, relu=False,
               rounding: str = "trunc", order: str = "conv",
               plan=None) -> torch.Tensor:
    """The gathered conv: kernel B1 (``csrc/qgemm_int8.cu``
    ``qgemm_u8s8_conv``) with its A tile gathered from the u8 NHWC input,
    patch order ``(l*kw + m)*c + ch`` and padded taps at ``zp_a``; returns
    u8 NHWC.

    On CUDA tensors this launches the kernel with ``plan`` (by default
    ``plan_qgemm(..., conv=geometry)``) and adds one to ``qgemm.launches``;
    on CPU tensors it is im2col + ``qgemm_plain``.  The kernel's loader
    moves 4-byte words at least: where C % 4 != 0 (AlexNet conv1, C = 3)
    the channels are first padded to a multiple of 4, the input with the
    zero point and the weight with zero taps, which add nothing to any
    accumulator."""
    kw_ = dict(scale_a=scale_a, scale_c=scale_c, zp_c=zp_c, relu=relu,
               rounding=rounding, order=order)
    if x_u8_nhwc.dtype != torch.uint8 or x_u8_nhwc.dim() != 4:
        raise TypeError(f"qgemm_conv takes u8 NHWC codes, got "
                        f"{x_u8_nhwc.dtype} {tuple(x_u8_nhwc.shape)}")
    geom = ConvGeom(*x_u8_nhwc.shape, kh, kw, stride, padding)
    (oh, ow), (m, k) = geom.out_hw, geom.gemm_shape
    if min(oh, ow) <= 0:
        raise ValueError(f"qgemm_conv: window {kh}x{kw} larger than the "
                         f"padded input {tuple(x_u8_nhwc.shape)}")
    _check_operands(x_u8_nhwc.new_empty((0, k)), qw_nk, oc, ep, order)
    if x_u8_nhwc.device.type == "cpu":
        return conv2d_int8_gemm(x_u8_nhwc, qw_nk, oc, ep, kh=kh, kw=kw,
                                stride=stride, padding=padding, zp_a=zp_a,
                                gemm=qgemm_plain, **kw_)
    if geom.c % 4:
        extra = -geom.c % 4
        x_u8_nhwc = F.pad(x_u8_nhwc, (0, extra), value=int(zp_a))
        qw_nk = F.pad(qw_nk.reshape(-1, kh, kw, geom.c), (0, extra)).reshape(
            qw_nk.shape[0], -1)
        geom = geom._replace(c=geom.c + extra)
        k = geom.gemm_shape[1]
    x_u8_nhwc = x_u8_nhwc.contiguous()
    dev = _card_operands("qgemm_conv", x_u8_nhwc.view(-1, geom.c), qw_nk,
                         oc, ep)
    n = qw_nk.shape[0]
    out = torch.empty((geom.batch, oh, ow, n), dtype=torch.uint8, device=dev)
    plan = plan or plan_qgemm(m, n, k, conv=geom, sms=sm_count(dev))
    if plan.variant != "conv":
        raise ValueError(f"qgemm_conv: {geom} is not a gathered geometry")
    from ..kernels import load
    lib = load("qgemm_int8")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.qgemm_u8s8_conv(
            x_u8_nhwc.data_ptr(), qw_nk.data_ptr(), oc.data_ptr(),
            ep.data_ptr(), out.data_ptr(), *geom, n, int(zp_a),
            float(scale_a), float(scale_c), int(zp_c), ORDERS.index(order),
            int(bool(relu)), int(rounding == "nearest"),
            *launch_plan(plan, x_u8_nhwc, qw_nk), stream)
    if rc != 0:
        raise RuntimeError(f"qgemm_u8s8_conv launch failed with CUDA error "
                           f"{rc} ({geom}, {plan})")
    qgemm.launches += 1
    return out


# -- grouped (depthwise) convolution: kernel G1 -------------------------------

def _grouped_geometry(x_u8_nhwc: torch.Tensor, qw: torch.Tensor,
                      oc: torch.Tensor, ep: torch.Tensor, groups: int,
                      kh: int, kw: int, stride: int, padding: int):
    """Check a grouped conv's operands; returns (C/g, O, OH, OW)."""
    if x_u8_nhwc.dtype != torch.uint8 or x_u8_nhwc.dim() != 4:
        raise TypeError(f"grouped conv takes u8 NHWC codes, got "
                        f"{x_u8_nhwc.dtype} {tuple(x_u8_nhwc.shape)}")
    if qw.dtype != torch.int8 or qw.dim() != 2:
        raise TypeError(f"grouped conv weights must be s8 [O, K], got "
                        f"{qw.dtype} {tuple(qw.shape)}")
    n, h, w, c = x_u8_nhwc.shape
    o = qw.shape[0]
    if groups < 1 or c % groups or o % groups:
        raise ValueError(f"groups={groups} must divide in_channels={c} and "
                         f"out_channels={o}")
    cg = c // groups
    if qw.shape[1] != kh * kw * cg:
        raise ValueError(f"grouped conv weight {tuple(qw.shape)}: want "
                         f"[{o}, {kh * kw * cg}] ((kh, kw, C/g) taps)")
    if oc.dtype != torch.int32 or tuple(oc.shape) != (o,):
        raise ValueError(f"oc must be int32 [{o}], got {oc.dtype} "
                         f"{tuple(oc.shape)}")
    if ep.dtype != torch.float32 or tuple(ep.shape) != (o,):
        raise ValueError(f"ep must be float32 [{o}], got {ep.dtype} "
                         f"{tuple(ep.shape)}")
    oh = (h + 2 * padding - kh) // stride + 1
    ow = (w + 2 * padding - kw) // stride + 1
    if stride < 1 or padding < 0 or min(oh, ow) <= 0:
        raise ValueError(f"grouped conv: window {kh}x{kw} stride {stride} "
                         f"padding {padding} over {tuple(x_u8_nhwc.shape)}")
    return cg, o, oh, ow


def conv2d_int8_grouped_plain(x_u8_nhwc: torch.Tensor, qw: torch.Tensor,
                              oc: torch.Tensor, ep: torch.Tensor, *,
                              groups: int, kh: int, kw: int, stride: int,
                              padding: int, scale_a, zp_a, scale_c, zp_c,
                              relu=False, rounding: str = "trunc",
                              order: str = "conv") -> torch.Tensor:
    """The grouped conv in plain PyTorch: u8 NHWC [B, H, W, C] x s8 ``qw``
    [O, kh*kw*C/g] (taps (kh, kw, C/g), output channel o in group
    o // (O/g)) -> u8 NHWC [B, OH, OW, O].

    im2col over the input with padded taps at ``zp_a``, each group's patch
    columns against its weights in float64 (exact integers, as
    ``qgemm_plain``'s accumulate: |acc| <= 128*127*K), ``+ oc`` (which holds
    the +128*rowsum term over the channel's own group taps), then the conv
    float order ``acc*s_a*s_w / s_c + zp_c``, clip, 'trunc' or 'nearest',
    relu at the zero point: the JAX package's ``conv2d_int8_xla`` with
    ``feature_group_count``.  ``order='conv_bf16'`` takes the bfloat16
    epilogue instead (``ep`` its multiplier)."""
    cg, o, oh, ow = _grouped_geometry(x_u8_nhwc, qw, oc, ep, groups, kh, kw,
                                      stride, padding)
    n = x_u8_nhwc.shape[0]
    patches = im2col_nhwc(x_u8_nhwc, kh, kw, stride, padding,
                          pad_value=int(zp_a))
    a = patches.reshape(-1, kh * kw, groups, cg).to(torch.float64) - 128.0
    wt = qw.reshape(groups, o // groups, kh * kw, cg).to(torch.float64)
    acc = torch.einsum("mtgc,gotc->mgo", a, wt).to(torch.int32)
    out = _requant_epilogue(acc.reshape(-1, o) + oc.reshape(1, -1), ep,
                            scale_a=scale_a, scale_c=scale_c, zp_c=zp_c,
                            relu=relu, rounding=rounding, order=order)
    return out.reshape(n, oh, ow, o)


def conv2d_int8_grouped(x_u8_nhwc: torch.Tensor, qw: torch.Tensor,
                        oc: torch.Tensor, ep: torch.Tensor, *, groups: int,
                        kh: int, kw: int, stride: int, padding: int, scale_a,
                        zp_a, scale_c, zp_c, relu=False,
                        rounding: str = "trunc",
                        order: str = "conv") -> torch.Tensor:
    """The grouped INT8 conv (``conv2d_int8_grouped_plain``'s function).

    On CUDA tensors this launches kernel G1 (``csrc/conv_grouped.cu``
    ``conv_grouped_u8s8``) on the current stream and adds one to
    ``conv2d_int8_grouped.launches``; on CPU tensors it is the plain
    version.  ``ep`` is the per-channel ``s_w`` (``epilogue_vector(...,
    order='conv')``): a grouped conv always takes the conv order, as the
    JAX package's native grouped conv does, or its bfloat16 form under
    ``order='conv_bf16'`` (``ep`` the bfloat16 multiplier), which G1 has as
    a kernel instance of its own."""
    if order not in ("conv", "conv_bf16"):
        raise ValueError(f"grouped conv epilogue order {order!r}: 'conv' or "
                         f"'conv_bf16'")
    cg, o, oh, ow = _grouped_geometry(x_u8_nhwc, qw, oc, ep, groups, kh, kw,
                                      stride, padding)
    kw_ = dict(groups=groups, kh=kh, kw=kw, stride=stride, padding=padding,
               scale_a=scale_a, zp_a=zp_a, scale_c=scale_c, zp_c=zp_c,
               relu=relu, rounding=rounding, order=order)
    dev = x_u8_nhwc.device
    if dev.type == "cpu":
        return conv2d_int8_grouped_plain(x_u8_nhwc, qw, oc, ep, **kw_)
    if dev.type != "cuda":
        raise ValueError(f"grouped conv runs on CUDA or CPU tensors, got "
                         f"{dev}")
    x_u8_nhwc = x_u8_nhwc.contiguous()
    for i, t in enumerate((qw, oc, ep)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"grouped conv: operand {i + 1} must be "
                             f"contiguous on {dev}")
    n, h, w, c = x_u8_nhwc.shape
    if x_u8_nhwc.numel() >= 2 ** 31 or n * oh * ow * o >= 2 ** 31:
        raise ValueError(f"grouped conv: {tuple(x_u8_nhwc.shape)} -> {o} "
                         f"channels is too large")
    out = torch.empty((n, oh, ow, o), dtype=torch.uint8, device=dev)
    from ..kernels import load
    lib = load("conv_grouped")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.conv_grouped_u8s8(
            x_u8_nhwc.data_ptr(), qw.data_ptr(), oc.data_ptr(),
            ep.data_ptr(), out.data_ptr(), n, h, w, c, o, groups, kh, kw,
            stride, padding, int(zp_a), float(scale_a), float(scale_c),
            int(zp_c), int(bool(relu)), int(rounding == "nearest"),
            int(order == "conv_bf16"), stream)
    if rc != 0:
        raise RuntimeError(f"conv_grouped_u8s8 launch failed with CUDA "
                           f"error {rc} ({tuple(x_u8_nhwc.shape)}, O={o}, "
                           f"groups={groups}, k={kh}x{kw}, stride={stride})")
    conv2d_int8_grouped.launches += 1
    return out


conv2d_int8_grouped.launches = 0


# -- the weight-only convs: W8F and DAC --------------------------------------

def w8f_conv2d(x_nchw: torch.Tensor, q_w: torch.Tensor, s_w: torch.Tensor,
               bias: torch.Tensor, stride: int, padding: int,
               groups: int = 1) -> torch.Tensor:
    """The W8-float conv: ``conv2d_fp32`` on the weight dequantized at this
    call (``q_w`` s8 OIHW, ``s_w`` float32 [O]), as the JAX package's
    weight-only ``Conv2d`` does; float32 NCHW out."""
    from .weight_only import dequant_w8
    w8f_conv2d.calls += 1
    return conv2d_fp32(x_nchw, dequant_w8(q_w, s_w), bias, stride, padding,
                       groups)


w8f_conv2d.calls = 0


def _check_s8_conv(x: torch.Tensor, w: torch.Tensor, groups: int) -> None:
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"conv2d_s8 takes int8 operands, got {x.dtype} and "
                        f"{w.dtype}")
    if x.dim() != 4 or w.dim() != 4 or x.shape[1] != w.shape[1] * groups \
            or w.shape[0] % groups:
        raise ValueError(f"conv2d_s8 shapes: x {tuple(x.shape)} (NCHW), w "
                         f"{tuple(w.shape)} (OIHW), groups {groups}")
    if x.device != w.device:
        raise ValueError(f"conv2d_s8: x on {x.device}, w on {w.device}")


def conv2d_s8(x_s8_nchw: torch.Tensor, w_s8_oihw: torch.Tensor,
              stride: int, padding: int, groups: int = 1) -> torch.Tensor:
    """DAC, the dynamic conv's product: s8 NCHW x s8 OIHW -> s32 NCHW,
    exact, on any device: ``F.conv2d`` on float64 copies of the integer
    operands (zero padding).  Every partial sum is an integer of magnitude
    at most (C/g) * k^2 * 127^2 < 2^53, so float64 holds it exactly in any
    order of additions (float32 would not: 512 * 9 * 127^2 > 2^24).  The
    JAX package runs XLA's integer conv with ``feature_group_count``; no
    ``pallas_call``."""
    _check_s8_conv(x_s8_nchw, w_s8_oihw, groups)
    conv2d_s8.calls += 1
    out = F.conv2d(x_s8_nchw.to(torch.float64), w_s8_oihw.to(torch.float64),
                   None, stride=stride, padding=padding, groups=groups)
    return out.to(torch.int32)


conv2d_s8.calls = 0


def conv2d_s8_plain(x_s8_nchw: torch.Tensor, w_s8_oihw: torch.Tensor,
                    stride: int, padding: int, groups: int = 1
                    ) -> torch.Tensor:
    """``conv2d_s8``'s plain version on integers alone: im2col of the
    zero-padded input and one int64 product a group."""
    _check_s8_conv(x_s8_nchw, w_s8_oihw, groups)
    o, cg, k, _ = w_s8_oihw.shape
    x = x_s8_nchw.permute(0, 2, 3, 1).to(torch.int64)         # NHWC
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    win = windows_nhwc(x, k, k, stride)              # [n, oh, ow, k, k, c]
    n, oh, ow = win.shape[:3]
    og = o // groups
    outs = []
    for g in range(groups):
        patch = win[..., g * cg:(g + 1) * cg].reshape(n * oh * ow, -1)
        wg = w_s8_oihw[g * og:(g + 1) * og].permute(0, 2, 3, 1).reshape(
            og, -1).to(torch.int64)                  # (kh, kw, c) taps
        outs.append(patch @ wg.t())
    out = torch.cat(outs, dim=1).reshape(n, oh, ow, o)
    return out.permute(0, 3, 1, 2).to(torch.int32).contiguous()
