"""INT8 attention: the encoders' composed prefill attention and the
cached-decode attention over the T-major flat u8 KV cache (counterpart of
``int8inferenceengine_tpu.ops.attention``).

The encoders' (ViT, the text transformer) full-sequence attention is
``attention``: QuantMatmul -> QuantSoftmax -> QuantMatmul run back to back
(``attention_xla``).  The JAX package sends 'auto' there too and raises for
'pallas': its prefill Pallas kernel lost to the composed path and was
deleted, so there is no TPU kernel to port.  It is stock PyTorch here (the
exact float64 products of ``ops/qmatmul``), a library route that counts its
``calls``.

The decode step's attention is one query row per sequence (``mq`` rows on a
multi-position extend) against the cache ``k``/``v`` u8 [B, T, Hkv*D], in
which row t holds position t's head-merged codes and the first ``valid``
rows are live.  It is the composed QuantMatmul -> QuantSoftmax(valid_len)
-> QuantMatmul chain:

    codes_s = trunc(clip(sum_d (q-zp_q)(k-zp_k) * mult_s + zp_s) [+rb])
    f       = (codes_s - zp_s) * s_s          [-> softcap*tanh(f/softcap)]
    f       = -inf outside [valid+j-window, valid+j)       (row j's horizon)
    p       = exp(f - max) / sum(exp(f - max))
    codes_p = trunc(clip(p / s_p + zp_p) [+rb])     (masked -> exactly zp_p)
    out     = trunc(clip(sum_t (p-zp_p)(v-zp_v) * mult_o + zp_c) [+rb])

with ``mult_s = s_q*s_k*alpha/s_s`` and ``mult_o = s_p*s_v/s_c`` formed in
float32 left to right.  Masked positions quantize to exactly zp_p and add
exactly zero, so garbage in unwritten cache rows never reaches the output.

* ``decode_attention_xla`` is that chain in plain PyTorch on [B, Hkv, R, T]
  scores (the JAX package's composed oracle);
* ``decode_attention_flat`` is the entry point, and ``decode_attention``
  its head-split ([B, H, 1, D] / [B, Hkv, T, D]) compat wrapper.  On a CUDA tensor with
  ``backend`` 'auto' or 'pallas' it launches the hand-written kernel
  (``csrc/decode_attn.cu``) and adds one to ``decode_attention_flat
  .launches``; on a CPU tensor, or with ``backend='xla'`` (the caller's
  explicit choice of the composed path), it runs ``decode_attention_xla``.
* ALiBi (the BLOOM family's per-head score bias ``m_h * (col - (valid +
  j - 1))``, added after the softcap and before the mask) runs the
  composed path on every device, as in the JAX package, whose kernel has
  no bias tail: ``decode_attention_alibi``, a library route that counts
  its ``calls``.  It reads all T cache rows; ``backend='pallas'`` with
  ALiBi raises ``ValueError``.

The JAX package has two Pallas revisions of the kernel, the merged-dot one
(``merged=True``) and the block walk it keeps as its oracle
(``merged=False``).  They compute one function, and one CUDA kernel serves
both flags here.

The kernel cuts each (sequence, kv head)'s query positions into tiles of
``mq_tile`` consecutive positions (one for a decode step or a short verify
extend, several for a long extend such as a chunked prefill), and splits
each tile's live span over T across a thread block cluster;
``plan_decode_attn`` chooses the tile and the split count from the shapes
alone, and ``decode_attention_split_plain`` is the plain twin of the
tiling and of the split's exact reductions (equal bit for bit to the
composed version at every tiling and split: rows are independent).

The JAX package sends a multi-position call to its composed path once the
scores of all rows, ``mq * H * T * 4`` bytes, outgrow 4 MiB: a rule about
the TPU's VMEM, which holds one kernel instance's rows.  The port does not
follow it.  On the card the row tiles bound a block's shared memory
whatever mq is, so every extend, however long, runs the kernel.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .functional import rounded64
from .qmatmul import qmatmul_act, requant_act
from .quant import dequantize_u8, quantize_u8, f32

BACKENDS = ("auto", "pallas", "xla")


def softmax_last(f: torch.Tensor) -> torch.Tensor:
    """``exp(f - max) / sum(exp(f - max))`` over the last axis: the
    composed softmax's order (``jax.nn.softmax``); -inf entries give 0.

    The denominator accumulates in float64 and rounds once to float32: the
    correctly rounded sum of the float32 exps, whatever order the adds run
    in, so the decode kernel (``csrc/decode_attn.cu``) and the card's and
    the CPU's reductions agree on it.  A float32 sum in another order moves
    it by an ULP, which flips a probability code that sits on a truncation
    boundary; in a decode that code then spreads through the KV cache.
    Each exp is taken in float64 and rounded once for the same reason (the
    card's and the CPU's float32 exp differ by an ULP).  ``jax.nn.softmax``
    takes both in float32: within the 1-code contract."""
    e = rounded64(torch.exp, f - f.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True, dtype=torch.float64).to(
        torch.float32)


def softcap_(f: torch.Tensor, softcap) -> torch.Tensor:
    c = f32(softcap, f.device)
    return c * torch.tanh(f / c)


def attention_xla(q_u8, k_u8, v_u8, *, scale_q, zp_q, scale_k, zp_k,
                  scale_v, zp_v, scale_s, zp_s, scale_p, zp_p, scale_c, zp_c,
                  alpha: float, rounding: str = "trunc") -> torch.Tensor:
    """Composed attention over [..., T, D] heads: bit for bit
    ``QuantMatmul(alpha, transpose_b) -> QuantSoftmax -> QuantMatmul`` run
    back to back at the same grids."""
    s = qmatmul_act(q_u8, k_u8, scale_a=scale_q, zp_a=zp_q, scale_b=scale_k,
                    zp_b=zp_k, scale_c=scale_s, zp_c=zp_s, alpha=alpha,
                    transpose_b=True, rounding=rounding)
    p = quantize_u8(softmax_last(dequantize_u8(s, scale_s, zp_s)), scale_p,
                    zp_p, rounding)
    return qmatmul_act(p, v_u8, scale_a=scale_p, zp_a=zp_p, scale_b=scale_v,
                       zp_b=zp_v, scale_c=scale_c, zp_c=zp_c,
                       rounding=rounding)


def attention(q_u8, k_u8, v_u8, *, backend: str = "auto", **kw
              ) -> torch.Tensor:
    """The encoders' fused-attention dispatch (``QuantConfig
    .fused_attention``): 'auto' and 'xla' run ``attention_xla`` on any
    device; 'pallas' raises, as in the JAX package, whose prefill kernel
    was removed after the composed path beat it at every shape it
    measured."""
    if backend == "pallas":
        raise ValueError(
            "the prefill fused-attention Pallas kernel was removed from the "
            "JAX package (the composed path beat it at every measured "
            "shape), so the port has none either; use 'auto', 'xla' or "
            "'off' (the cached-decode kernel is unaffected)")
    attention.calls += 1
    return attention_xla(q_u8, k_u8, v_u8, **kw)


attention.calls = 0


def decode_attention_xla(q_u8, k_u8, v_u8, valid, *, scale_q, zp_q,
                         scale_k, zp_k, scale_v, zp_v, scale_s, zp_s,
                         scale_p, zp_p, scale_c, zp_c, alpha: float,
                         rounding: str = "trunc", window: int | None = None,
                         softcap: float | None = None,
                         alibi: torch.Tensor | None = None) -> torch.Tensor:
    """Composed decode attention (the plain version): QuantMatmul ->
    QuantSoftmax(valid_len) -> QuantMatmul on [..., R, T] scores.

    ``valid`` broadcasts against the score columns: an int, a 0-dim tensor,
    [B, 1, 1, 1] per sequence, or [B, 1, R, 1] per row.  ``alibi`` (float32
    [Hkv, R]) is the ALiBi slope of each score row's query head."""
    f = _masked_scores(q_u8, k_u8, valid, scale_q=scale_q, zp_q=zp_q,
                       scale_k=scale_k, zp_k=zp_k, scale_s=scale_s, zp_s=zp_s,
                       alpha=alpha, rounding=rounding, window=window,
                       softcap=softcap, alibi=alibi)
    p = quantize_u8(softmax_last(f), scale_p, zp_p, rounding)
    return qmatmul_act(p, v_u8, scale_a=scale_p, zp_a=zp_p, scale_b=scale_v,
                       zp_b=zp_v, scale_c=scale_c, zp_c=zp_c,
                       rounding=rounding)


def _masked_scores(q_u8, k_u8, valid, *, scale_q, zp_q, scale_k, zp_k,
                   scale_s, zp_s, alpha, rounding, window, softcap,
                   alibi=None):
    """The requantized, dequantized (softcapped, ALiBi-biased) scores [...,
    R, T], -inf outside each row's horizon."""
    s = qmatmul_act(q_u8, k_u8, scale_a=scale_q, zp_a=zp_q, scale_b=scale_k,
                    zp_b=zp_k, scale_c=scale_s, zp_c=zp_s, alpha=alpha,
                    transpose_b=True, rounding=rounding)
    f = dequantize_u8(s, scale_s, zp_s)
    if softcap is not None:
        f = softcap_(f, softcap)
    col = torch.arange(f.shape[-1], device=f.device, dtype=torch.int32)
    if alibi is not None:
        # the query's absolute position is valid - 1: 0 at itself, negative
        # into the past (future columns are masked below)
        m = alibi.reshape(1, alibi.shape[0], alibi.shape[1], 1)
        f = f + m * (col - (valid - 1)).to(torch.float32)
    keep = col < valid
    if window is not None:
        keep = keep & (col >= valid - int(window))
    return torch.where(keep, f, f32(float("-inf"), f.device))


def split_bounds(valid, t: int, mq: int, window, splits: int):
    """Each sequence's split of its live span over T, as the kernel forms
    it on the card from ``valid`` (int32 [B]): the span [lo, hi) of all of
    its query rows, cut into ``splits`` equal shares of ``ceil(span /
    splits)`` rows (the last ones shorter or empty).  Returns the split
    index of every cache row, int64 [B, T], -1 outside the span."""
    v = valid.to(torch.int64)
    hi = torch.clamp(v + (mq - 1), max=t)
    lo = torch.clamp(v - int(window), min=0) if window is not None else \
        torch.zeros_like(v)
    share = torch.clamp((hi - lo + splits - 1) // splits, min=1)
    col = torch.arange(t, device=v.device, dtype=torch.int64)
    sid = torch.div(col[None, :] - lo[:, None], share[:, None],
                    rounding_mode="floor")
    inside = (col[None, :] >= lo[:, None]) & (col[None, :] < hi[:, None])
    return torch.where(inside, sid, torch.full_like(sid, -1))


def decode_attention_split_plain(q2_u8, k3_u8, v3_u8, valid, *,
                                 n_heads: int, n_kv_heads: int | None = None,
                                 splits: int, mq_tile: int | None = None,
                                 window: int | None = None,
                                 softcap: float | None = None, **kw):
    """The plain twin of the kernel's loop (``decode_attention_flat``
    arguments, ``splits`` and ``mq_tile``, by default all positions in one
    tile): the query positions in tiles of ``mq_tile``, tile j0.. seeing
    the live length ``valid + j0``; in each tile each split's local max,
    the max over the splits, the float64 partial sums of the exps added in
    split order and rounded once, the probabilities requantized, each
    split's int32 P@V partials added in s32, and the output requantized
    once.  Equal bit for bit to ``decode_attention_xla`` on the same
    inputs."""
    bsz = k3_u8.shape[0]
    mq = q2_u8.shape[1] if q2_u8.dim() == 3 else 1
    q3 = q2_u8.reshape(bsz, mq, q2_u8.shape[-1])
    v = _valid_tensor(valid, bsz, q2_u8.device).expand(bsz)
    tile = mq if mq_tile is None else int(mq_tile)
    outs = [_split_tile(q3[:, j0:j0 + tile], k3_u8, v3_u8, v + j0,
                        n_heads=n_heads, n_kv_heads=n_kv_heads,
                        splits=splits, window=window, softcap=softcap, **kw)
            for j0 in range(0, mq, tile)]
    return torch.cat(outs, 1).reshape(q2_u8.shape)


def _split_tile(q3_u8, k3_u8, v3_u8, v, *, n_heads, n_kv_heads, splits,
                window, softcap, scale_q, zp_q, scale_k, zp_k, scale_v, zp_v,
                scale_s, zp_s, scale_p, zp_p, scale_c, zp_c, alpha,
                rounding="trunc"):
    """One tile of ``decode_attention_split_plain``: q3 [B, mq, H*D], its
    first position's live length ``v`` int32 [B]."""
    bsz, t, c = k3_u8.shape
    n_kv = n_heads if n_kv_heads is None else int(n_kv_heads)
    d = c // n_kv
    grp = n_heads // n_kv
    mq = q3_u8.shape[1]
    rows = mq * grp
    dev = q3_u8.device
    q4, k4, v4 = _head_major(q3_u8, k3_u8, v3_u8, n_kv, mq)
    rowj = (torch.arange(rows, device=dev, dtype=torch.int32) // grp
            ).reshape(1, 1, rows, 1)
    f = _masked_scores(q4, k4, v.reshape(-1, 1, 1, 1) + rowj,
                       scale_q=scale_q, zp_q=zp_q, scale_k=scale_k,
                       zp_k=zp_k, scale_s=scale_s, zp_s=zp_s, alpha=alpha,
                       rounding=rounding, window=window, softcap=softcap)
    sid = split_bounds(v, t, mq, window, splits)[:, None, None, :]
    ninf = f32(float("-inf"), dev)
    m = torch.stack([torch.where(sid == j, f, ninf).amax(-1, keepdim=True)
                     for j in range(splits)]).amax(0)
    e = rounded64(torch.exp, f - m)
    total = torch.zeros(f.shape[:-1] + (1,), dtype=torch.float64, device=dev)
    for j in range(splits):
        total = total + torch.where(sid == j, e, 0.0).sum(
            -1, keepdim=True, dtype=torch.float64)
    pz = (quantize_u8(e / total.to(torch.float32), scale_p, zp_p, rounding
                      ).to(torch.float64) - float(int(zp_p)))
    vz = v4.to(torch.float64) - float(int(zp_v))
    acc = torch.zeros(f.shape[:-1] + (d,), dtype=torch.int32, device=dev)
    for j in range(splits):
        # exact in float64: |partial| <= 255 * 255 * T
        acc = acc + torch.matmul(torch.where(sid == j, pz, 0.0),
                                 vz).to(torch.int32)
    out4 = requant_act(acc, scale_a=scale_p, scale_b=scale_v,
                       scale_c=scale_c, zp_c=zp_c, rounding=rounding)
    return out4.reshape(bsz, n_kv, mq, grp, d).permute(
        0, 2, 1, 3, 4).reshape(q3_u8.shape)


def _valid_tensor(valid, bsz: int, device) -> torch.Tensor:
    """``valid`` as an int32 tensor on ``device``: 0-dim or [B]."""
    if isinstance(valid, torch.Tensor):
        v = valid.to(device=device, dtype=torch.int32)
    else:
        v = torch.tensor(np.asarray(valid, np.int32), device=device)
    if v.dim() > 1 or (v.dim() == 1 and v.shape[0] != bsz):
        raise ValueError(f"valid must be a scalar or [B={bsz}], got shape "
                         f"{tuple(v.shape)}")
    return v


def _head_major(q, k3, v3, n_kv, mq):
    """q [B, (mq,) H*D] and k/v [B, T, Hkv*D] as [B, Hkv, R, D] and [B, Hkv,
    T, D]: kv group kv's grp query heads (times mq positions) ride the
    matmul M dim, row (j, g) of group kv being position j, query head
    kv*grp + g."""
    bsz, t, c = k3.shape
    d = c // n_kv
    grp = q.shape[-1] // d // n_kv

    def to4(x):                                  # [B,T,Hkv*D]->[B,Hkv,T,D]
        return x.reshape(bsz, t, n_kv, d).permute(0, 2, 1, 3)

    q4 = q.reshape(bsz, mq, n_kv, grp, d).permute(0, 2, 1, 3, 4).reshape(
        bsz, n_kv, mq * grp, d)
    return q4, to4(k3), to4(v3)


def _composed(q, k3, v3, v, *, n_heads, n_kv, mq, window, softcap, kw,
              alibi=None):
    bsz, t, c = k3.shape
    d = c // n_kv
    grp = n_heads // n_kv
    q4, k4, v4 = _head_major(q, k3, v3, n_kv, mq)
    vmask = v.reshape(-1, 1, 1, 1) if v.dim() else v
    if mq > 1:
        rowj = (torch.arange(mq * grp, device=q.device, dtype=torch.int32)
                // grp).reshape(1, 1, mq * grp, 1)
        vmask = vmask + rowj
    if alibi is not None:
        # rows (j, g) of kv group kv hold query head kv * grp + g
        alibi = alibi.reshape(n_kv, 1, grp).expand(n_kv, mq, grp).reshape(
            n_kv, mq * grp)
    out4 = decode_attention_xla(q4, k4, v4, vmask, window=window,
                                softcap=softcap, alibi=alibi, **kw)
    return out4.reshape(bsz, n_kv, mq, grp, d).permute(0, 2, 1, 3, 4)


def decode_attention_flat(q2_u8, k3_u8, v3_u8, valid, *, n_heads: int,
                          n_kv_heads: int | None = None,
                          backend: str = "auto", merged: bool | None = None,
                          window: int | None = None,
                          softcap: float | None = None, alibi=None,
                          plan: DecodeAttnPlan | None = None,
                          **kw) -> torch.Tensor:
    """Cached-decode attention on the T-major flat cache.

    q u8 [B, H*D] (one position) or [B, mq, H*D] (mq consecutive positions;
    row j sees ``valid + j`` columns), k/v u8 [B, T, Hkv*D], ``valid`` the
    live length of position 0 (int, 0-dim or int32 [B] tensor, each >= 1)
    -> u8 of q's shape.  ``n_kv_heads`` < ``n_heads`` is grouped-query
    attention: query head h reads kv head h // (H / Hkv); the cache is
    never expanded.  ``kw`` carries the scales and zero points of q, k, v,
    the scores (s), the probabilities (p) and the output (c), ``alpha`` and
    ``rounding``.  ``merged`` selects the JAX kernel revision; both are the
    one CUDA kernel here.  ``plan`` is the kernel's (by default
    ``plan_decode_attn``'s; one it cannot run raises).  ``alibi`` (one
    slope a query head: a sequence, or a float32 tensor, which a captured
    step needs) sends the call to ``decode_attention_alibi``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown decode attention backend {backend!r}; "
                         f"one of {BACKENDS}")
    if alibi is not None:
        if backend == "pallas":
            raise ValueError("decode_attention_flat: ALiBi has no kernel "
                             "route (as in the JAX package); use "
                             "backend='auto' or 'xla'")
        if len(alibi) != n_heads:
            raise ValueError(f"alibi slopes ({len(alibi)}) != query heads "
                             f"{n_heads}")
    del merged                                   # one kernel serves both
    bsz, t, c = k3_u8.shape
    n_kv = n_heads if n_kv_heads is None else int(n_kv_heads)
    if n_heads % n_kv:
        raise ValueError(f"{n_heads} query heads not divisible by {n_kv} "
                         f"kv heads")
    if c % n_kv:
        raise ValueError(f"flat kv channels {c} not divisible by {n_kv} kv "
                         f"heads")
    d = c // n_kv
    multi = q2_u8.dim() == 3
    mq = q2_u8.shape[1] if multi else 1
    if q2_u8.shape[-1] != n_heads * d or q2_u8.shape[0] != bsz:
        raise ValueError(f"query {tuple(q2_u8.shape)} does not match "
                         f"{n_heads} heads of {d} over a batch of {bsz}")
    for x in (q2_u8, k3_u8, v3_u8):
        if x.dtype != torch.uint8:
            raise TypeError(f"decode attention operands must be uint8 codes, "
                            f"got {x.dtype}")
    if tuple(v3_u8.shape) != (bsz, t, c):
        raise ValueError(f"k {tuple(k3_u8.shape)} and v "
                         f"{tuple(v3_u8.shape)} caches differ")
    dev = q2_u8.device
    v = _valid_tensor(valid, bsz, dev)
    if window is not None:
        window = int(window)
    if alibi is not None:
        return decode_attention_alibi(
            q2_u8, k3_u8, v3_u8, v, torch.as_tensor(
                alibi, dtype=torch.float32, device=dev),
            n_heads=n_heads, n_kv=n_kv, mq=mq, window=window,
            softcap=softcap, kw=kw)
    if dev.type == "cpu" or backend == "xla":
        out = _composed(q2_u8, k3_u8, v3_u8, v, n_heads=n_heads, n_kv=n_kv,
                        mq=mq, window=window, softcap=softcap, kw=kw)
        return out.reshape(q2_u8.shape)
    if dev.type != "cuda":
        raise ValueError(f"decode attention runs on CUDA or CPU tensors, got "
                         f"{dev}")
    return _launch(q2_u8.reshape(bsz, mq, n_heads * d), k3_u8, v3_u8, v,
                   n_heads=n_heads, n_kv=n_kv, mq=mq, window=window,
                   softcap=softcap, plan=plan, **kw).reshape(q2_u8.shape)


decode_attention_flat.launches = 0


def decode_attention(q_u8, k_u8, v_u8, valid, *, backend: str = "auto",
                     **kw) -> torch.Tensor:
    """Cached-decode attention on head-split operands (the JAX package's
    compat API): q u8 [B, H, 1, D], k/v u8 [B, Hkv, T, D] caches (Hkv
    dividing H: grouped-query attention), ``valid`` the live length (int,
    0-dim, [B] or [B, 1, 1, 1]) -> u8 [B, H, 1, D].

    A transpose wrapper over ``decode_attention_flat``: on a CUDA tensor
    with ``backend`` 'auto' or 'pallas' it runs kernel B3 on the T-major
    flat layout; on the CPU, or with ``backend='xla'``, the composed
    ``decode_attention_xla``.  ``kw`` as for ``decode_attention_flat``
    (the scales and zero points, ``alpha``, ``rounding``, ``window``,
    ``softcap``)."""
    bsz, n_heads, one, d = q_u8.shape
    if one != 1:
        raise ValueError(f"decode_attention expects one query row, got "
                         f"{tuple(q_u8.shape)}")
    if k_u8.dim() != 4 or tuple(k_u8.shape) != tuple(v_u8.shape) \
            or k_u8.shape[0] != bsz or k_u8.shape[3] != d:
        raise ValueError(f"decode_attention: k {tuple(k_u8.shape)} and v "
                         f"{tuple(v_u8.shape)} must be [B, Hkv, T, D] "
                         f"beside q {tuple(q_u8.shape)}")
    if isinstance(valid, torch.Tensor) and valid.dim() > 1:
        valid = valid.reshape(-1)

    def flat(x4):                                    # [B,H,T,D]->[B,T,H*D]
        return x4.permute(0, 2, 1, 3).reshape(x4.shape[0], x4.shape[2], -1)

    out2 = decode_attention_flat(
        q_u8.reshape(bsz, n_heads * d).contiguous(),
        flat(k_u8).contiguous(), flat(v_u8).contiguous(), valid,
        n_heads=n_heads, n_kv_heads=k_u8.shape[1], backend=backend, **kw)
    return out2.reshape(bsz, n_heads, 1, d)


def decode_attention_alibi(q, k3, v3, v, alibi, *, n_heads, n_kv, mq, window,
                           softcap, kw) -> torch.Tensor:
    """The ALiBi decode attention: the composed chain over all T rows of the
    cache with each score row biased by its query head's slope (``alibi``
    float32 [H]), on any device.  The JAX package leaves it to XLA (no
    ``pallas_call``); here it is stock PyTorch, counted in ``.calls``."""
    decode_attention_alibi.calls += 1
    out = _composed(q, k3, v3, v, n_heads=n_heads, n_kv=n_kv, mq=mq,
                    window=window, softcap=softcap, kw=kw, alibi=alibi)
    return out.reshape(q.shape)


decode_attention_alibi.calls = 0


class DecodeAttnPlan(NamedTuple):
    """One launch of the decode attention kernel: the query positions in
    tiles of ``mq_tile`` (a block's rows: ``mq_tile`` positions times the
    grp query heads of a kv head), ``splits`` blocks (one thread block
    cluster) per (sequence, kv head, tile), each holding the scores of at
    most ``share`` = ceil(T / splits) cache rows, and ``tiles`` BLK-row K
    and V buffers (all of a share, loaded at once; or two, to stream a
    longer one), in ``smem`` bytes of shared memory."""
    mq_tile: int
    splits: int
    share: int
    tiles: int
    smem: int


# csrc/decode_attn.cu: BLK-row K and V tiles; at most 8 splits (a portable
# cluster)
_BLK = 64
SMEM_LIMIT = 227 * 1024
MAX_SPLITS = 8


def _align16(x: int) -> int:
    return -(-x // 16) * 16


def _smem_bytes(rows: int, share: int, d: int, tiles: int,
                splits: int) -> int:
    """Dynamic shared memory of one block (``csrc/decode_attn.cu``
    ``layout``) holding ``rows`` query rows: the scores of one share [rows,
    share] f32, the zero-padded query [rows, DP] u8 and its sums, the P@V
    partials [rows, D] i32, the local max and partial sum per row, the
    inbox [rows, D] i32 in which split 0 receives the splits' sums, and
    ``tiles`` K and as many V tiles of BLK rows padded to an odd multiple
    of 16 bytes."""
    dp = _align16(d)
    ldt = dp + 16 if (dp // 16) % 2 == 0 else dp + 32
    inbox = _align16(4 * rows * d) if splits > 1 else 0
    return (_align16(4 * rows * share) + rows * dp + _align16(4 * rows)
            + _align16(4 * rows * d) + _align16(4 * rows) + _align16(8 * rows)
            + inbox + 2 * tiles * _BLK * ldt)


def decode_attn_plan(splits: int, mq_tile: int, grp: int, t: int, d: int
                     ) -> DecodeAttnPlan:
    """The plan at ``splits`` with tiles of ``mq_tile`` positions of
    ``grp`` query heads: the tile buffers hold a whole share where shared
    memory allows, else two stream it."""
    rows = mq_tile * grp
    share = -(-t // splits)
    tiles = -(-share // _BLK)
    if _smem_bytes(rows, share, d, tiles, splits) > SMEM_LIMIT:
        tiles = 2
    return DecodeAttnPlan(mq_tile, splits, share, tiles,
                          _smem_bytes(rows, share, d, tiles, splits))


# query rows x cache rows one block holds at most: past it the span is
# split (a cluster's barriers cost about as much as a block's work on 512;
# PERF.md, the sweep)
ROWS_PER_BLOCK = 512


def split_plan(mq_tile: int, grp: int, t: int, d: int) -> DecodeAttnPlan:
    """The split rule at one tile: the fewest splits, a power of two, that
    keep query rows x cache rows a block holds within ``ROWS_PER_BLOCK``
    (at most ``MAX_SPLITS``), and more where one share's scores would not
    fit the block's shared memory (the plan may still not fit)."""
    rows = mq_tile * grp
    splits = 1
    while splits < MAX_SPLITS and rows * -(-t // splits) > ROWS_PER_BLOCK:
        splits *= 2
    while splits < MAX_SPLITS and \
            decode_attn_plan(splits, mq_tile, grp, t, d).smem > SMEM_LIMIT:
        splits += 1
    return decode_attn_plan(splits, mq_tile, grp, t, d)


@functools.lru_cache(maxsize=256)
def plan_decode_attn(b: int, t: int, h: int, hkv: int, d: int, mq: int = 1
                     ) -> DecodeAttnPlan:
    """The kernel's plan from the shapes alone (never the live length, a
    device value): all ``mq`` positions in one tile under ``split_plan``
    wherever that fits the block's shared memory (every decode step and
    short extend), else the largest ``mq_tile`` whose ``split_plan`` fits
    (a long extend: each tile holds only its own rows' scores).  Raises
    where even one position's rows do not fit at 8 splits."""
    if min(b, t, h, hkv, d, mq) <= 0 or h % hkv:
        raise ValueError(f"plan_decode_attn: B={b} T={t} H={h} Hkv={hkv} "
                         f"D={d} mq={mq}")
    grp = h // hkv
    for mq_tile in range(mq, 0, -1):
        plan = split_plan(mq_tile, grp, t, d)
        if plan.smem <= SMEM_LIMIT:
            return plan
    raise ValueError(f"decode attention: {grp} query rows over T={t} "
                     f"need {plan.smem} bytes of shared memory at "
                     f"{plan.splits} splits, more than {SMEM_LIMIT}")


def _launch(q3, k3, v3, v, *, n_heads, n_kv, mq, window, softcap, scale_q,
            zp_q, scale_k, zp_k, scale_v, zp_v, scale_s, zp_s, scale_p, zp_p,
            scale_c, zp_c, alpha, rounding="trunc", plan=None):
    bsz, t, c = k3.shape
    dev = q3.device
    for name, x in (("k", k3), ("v", v3)):
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"decode attention: the {name} cache must be a "
                             f"contiguous tensor on {dev}")
        if x.data_ptr() % 4:
            raise ValueError(f"decode attention: the {name} cache must be "
                             f"4-byte aligned")
    if q3.stride(2) != 1 or q3.data_ptr() % 4 or any(
            s % 4 for s in q3.stride()[:2]):
        q3 = q3.contiguous()
    d = c // n_kv
    if d % 4 or d > 256:
        raise ValueError(f"decode attention kernel takes head_dim % 4 == 0 "
                         f"and <= 256, got {d}")
    if max(bsz * t * c, t * 255 * 255) >= 2 ** 31:
        raise ValueError(f"decode attention: cache [B={bsz}, T={t}, C={c}] "
                         f"too large for int32 offsets and sums")
    grp = n_heads // n_kv
    plan = plan or plan_decode_attn(bsz, t, n_heads, n_kv, d, mq)
    if not 1 <= plan.splits <= MAX_SPLITS or \
            not 1 <= plan.mq_tile <= mq or \
            plan != decode_attn_plan(plan.splits, plan.mq_tile, grp, t, d) \
            or plan.smem > SMEM_LIMIT:
        raise ValueError(f"decode attention cannot run {plan} for {mq} "
                         f"positions of {grp} query heads over T={t}, D={d}")
    v = v.contiguous()
    out = torch.empty((bsz, mq, n_heads * d), dtype=torch.uint8, device=dev)
    f = np.float32
    # float32, left to right, as qmatmul_act's act_mult forms them
    mult_s = f(scale_q) * f(scale_k) * f(alpha) / f(scale_s)
    mult_o = f(scale_p) * f(scale_v) / f(scale_c)
    from ..kernels import load
    lib = load("decode_attn")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.decode_attn_flat(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), v.data_ptr(),
            out.data_ptr(), bsz, t, n_heads, n_kv, d, mq,
            q3.stride(0), q3.stride(1), int(v.dim() == 1),
            -1 if window is None else window,
            0.0 if softcap is None else f(softcap),
            int(zp_q), int(zp_k), int(zp_p), int(zp_v),
            float(mult_s), f(zp_s), f(scale_s), f(scale_p), f(zp_p),
            float(mult_o), f(zp_c), int(rounding == "nearest"),
            plan.mq_tile, plan.splits, plan.share, plan.tiles, stream)
    if rc != 0:
        raise RuntimeError(f"decode_attn_flat launch failed with CUDA error "
                           f"{rc} ({plan})")
    decode_attention_flat.launches += 1
    return out
