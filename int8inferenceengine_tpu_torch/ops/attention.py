"""Cached-decode INT8 attention over the T-major flat u8 KV cache
(counterpart of ``int8inferenceengine_tpu.ops.attention``'s decode path).

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
* ``decode_attention_flat`` is the entry point.  On a CUDA tensor with
  ``backend`` 'auto' or 'pallas' it launches the hand-written kernel
  (``csrc/decode_attn.cu``) and adds one to ``decode_attention_flat
  .launches``; on a CPU tensor, or with ``backend='xla'`` (the caller's
  explicit choice of the composed path), it runs ``decode_attention_xla``.

The JAX package has two Pallas revisions of the kernel, the merged-dot one
(``merged=True``) and the block walk it keeps as its oracle
(``merged=False``).  They compute one function, and one CUDA kernel serves
both flags here.
"""

from __future__ import annotations

import numpy as np
import torch

from .qmatmul import qmatmul_act
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
    ``jax.nn.softmax`` sums in float32: within the 1-code contract."""
    e = torch.exp(f - f.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True, dtype=torch.float64).to(
        torch.float32)


def softcap_(f: torch.Tensor, softcap) -> torch.Tensor:
    c = f32(softcap, f.device)
    return c * torch.tanh(f / c)


def decode_attention_xla(q_u8, k_u8, v_u8, valid, *, scale_q, zp_q,
                         scale_k, zp_k, scale_v, zp_v, scale_s, zp_s,
                         scale_p, zp_p, scale_c, zp_c, alpha: float,
                         rounding: str = "trunc", window: int | None = None,
                         softcap: float | None = None) -> torch.Tensor:
    """Composed decode attention (the plain version): QuantMatmul ->
    QuantSoftmax(valid_len) -> QuantMatmul on [..., R, T] scores.

    ``valid`` broadcasts against the score columns: an int, a 0-dim tensor,
    [B, 1, 1, 1] per sequence, or [B, 1, R, 1] per row."""
    s = qmatmul_act(q_u8, k_u8, scale_a=scale_q, zp_a=zp_q, scale_b=scale_k,
                    zp_b=zp_k, scale_c=scale_s, zp_c=zp_s, alpha=alpha,
                    transpose_b=True, rounding=rounding)
    f = dequantize_u8(s, scale_s, zp_s)
    if softcap is not None:
        f = softcap_(f, softcap)
    col = torch.arange(f.shape[-1], device=f.device, dtype=torch.int32)
    keep = col < valid
    if window is not None:
        keep = keep & (col >= valid - int(window))
    f = torch.where(keep, f, f32(float("-inf"), f.device))
    p = quantize_u8(softmax_last(f), scale_p, zp_p, rounding)
    return qmatmul_act(p, v_u8, scale_a=scale_p, zp_a=zp_p, scale_b=scale_v,
                       zp_b=zp_v, scale_c=scale_c, zp_c=zp_c,
                       rounding=rounding)


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


def _composed(q, k3, v3, v, *, n_heads, n_kv, mq, window, softcap, kw):
    bsz, t, c = k3.shape
    d = c // n_kv
    grp = n_heads // n_kv

    def to4(x):                                  # [B,T,Hkv*D]->[B,Hkv,T,D]
        return x.reshape(bsz, t, n_kv, d).permute(0, 2, 1, 3)

    # kv group kv's grp query heads (times mq positions) ride the matmul M
    # dim: row (j, g) of group kv is position j, query head kv*grp + g
    q4 = q.reshape(bsz, mq, n_kv, grp, d).permute(0, 2, 1, 3, 4).reshape(
        bsz, n_kv, mq * grp, d)
    vmask = v.reshape(-1, 1, 1, 1) if v.dim() else v
    if mq > 1:
        rowj = (torch.arange(mq * grp, device=q.device, dtype=torch.int32)
                // grp).reshape(1, 1, mq * grp, 1)
        vmask = vmask + rowj
    out4 = decode_attention_xla(q4, to4(k3), to4(v3), vmask, window=window,
                                softcap=softcap, **kw)
    return out4.reshape(bsz, n_kv, mq, grp, d).permute(0, 2, 1, 3, 4)


def decode_attention_flat(q2_u8, k3_u8, v3_u8, valid, *, n_heads: int,
                          n_kv_heads: int | None = None,
                          backend: str = "auto", merged: bool | None = None,
                          window: int | None = None,
                          softcap: float | None = None, alibi=None,
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
    one CUDA kernel here."""
    if alibi is not None:
        raise NotImplementedError(
            "decode_attention_flat: ALiBi is composed-only in the JAX "
            "package too; the port has no ALiBi model yet")
    if backend not in BACKENDS:
        raise ValueError(f"unknown decode attention backend {backend!r}; "
                         f"one of {BACKENDS}")
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
    if dev.type == "cpu" or backend == "xla":
        out = _composed(q2_u8, k3_u8, v3_u8, v, n_heads=n_heads, n_kv=n_kv,
                        mq=mq, window=window, softcap=softcap, kw=kw)
        return out.reshape(q2_u8.shape)
    if dev.type != "cuda":
        raise ValueError(f"decode attention runs on CUDA or CPU tensors, got "
                         f"{dev}")
    return _launch(q2_u8.reshape(bsz, mq, n_heads * d), k3_u8, v3_u8, v,
                   n_heads=n_heads, n_kv=n_kv, mq=mq, window=window,
                   softcap=softcap, **kw).reshape(q2_u8.shape)


decode_attention_flat.launches = 0


def _launch(q3, k3, v3, v, *, n_heads, n_kv, mq, window, softcap, scale_q,
            zp_q, scale_k, zp_k, scale_v, zp_v, scale_s, zp_s, scale_p, zp_p,
            scale_c, zp_c, alpha, rounding="trunc"):
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
    rows = mq * (n_heads // n_kv)
    smem = _smem_bytes(rows, t, d)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"decode attention: {rows} query rows over T={t} "
                         f"need {smem} bytes of shared memory, more than "
                         f"{_SMEM_LIMIT}")
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
            float(mult_o), f(zp_c), int(rounding == "nearest"), smem, stream)
    if rc != 0:
        raise RuntimeError(f"decode_attn_flat launch failed with CUDA error "
                           f"{rc}")
    decode_attention_flat.launches += 1
    return out


# csrc/decode_attn.cu: BLK-row K/V tiles, double-buffered, rows padded by 4
_BLK = 64
_SMEM_LIMIT = 227 * 1024


def _smem_bytes(rows: int, t: int, d: int) -> int:
    """Dynamic shared memory of one block: scores [rows, T] f32, the
    recentred query and the P@V accumulators [rows, D] i32, and two K/V
    tiles of BLK padded rows."""
    return 4 * rows * t + 8 * rows * d + 2 * _BLK * (d + 4)
