"""Ring tensor-parallel quantized GEMM: the transfer of the next chunk
overlaps the partial product of this one (counterpart of
``int8inferenceengine_tpu.parallel.overlap``).

The baseline TP design (``parallel/sharding.py``) all-gathers each layer's
channel-sharded output before the next layer consumes it.  In overlap mode
the activation stays sharded, and the consuming Linear runs a ring
schedule

    for step in range(p):
        start sending x_chunk to the next rank of the model group
        acc += x_chunk @ W[local_cols, rows(chunk)]^T     # exact s32
        x_chunk = the chunk received from the previous rank

and requantizes the int32 accumulator once at the end with the GEMM
epilogue: bit-identical to gather-then-GEMM because integer partial sums
are exact.  The JAX package computes the partial products as XLA dots;
here they are the same exact s8 products (``ops/gemm_int8.s8_product``),
not the B1 kernel.

Used via ``shard_module(..., overlap=True)``: Linear layers consume their
predecessor's sharded output directly.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.gemm_int8 import _requant_epilogue, qgemm_plain, recentre, \
    s8_product


def ring_shift(x: torch.Tensor, pa):
    """Start sending ``x`` to the next rank of the model group and
    receiving the previous rank's; returns a function that waits and gives
    the received tensor (JAX's ``ppermute`` to ``(i + 1) mod p``).

    The transport: gloo's point-to-point ops take host tensors only (a
    CUDA tensor's device pointer reaches the socket), so under gloo a CUDA
    tensor is copied to the host, exchanged there and copied back.  NCCL
    exchanges device tensors directly."""
    group = pa.model_group
    p, me = pa.model_size, pa.model_index
    via_host = (x.device.type == "cuda"
                and dist.get_backend(group) == "gloo")
    send = x.cpu() if via_host else x.contiguous()
    recv = torch.empty_like(send)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, dist.get_global_rank(group,
                                                          (me + 1) % p),
                   group),
        dist.P2POp(dist.irecv, recv, dist.get_global_rank(group,
                                                          (me - 1) % p),
                   group)])

    def wait() -> torch.Tensor:
        for w in works:
            w.wait()
        return recv.to(x.device) if via_host else recv

    return wait


def ring_qgemm(x_chunk_u8: torch.Tensor, w_cols_nk: torch.Tensor,
               oc: torch.Tensor, ep: torch.Tensor, *, pa, scale_a, scale_c,
               zp_c, relu=False, rounding: str = "trunc") -> torch.Tensor:
    """Quantized ring GEMM on this rank of the model group.

    ``x_chunk_u8``: [M, K/p] — this rank's channel chunk of the u8
    activation (chunk i on model rank i).  ``w_cols_nk``: [N/p, K] — the
    local output columns over the full contraction; its K columns are
    consumed chunk by chunk as the activations rotate.  ``oc`` / ``ep``:
    the local [N/p] offset and epilogue vectors (the GEMM order).

    Returns the local [M, N/p] u8 output (still channel-sharded)."""
    p, me = pa.model_size, pa.model_index
    m, k_chunk = x_chunk_u8.shape
    acc = torch.zeros((m, w_cols_nk.shape[0]), dtype=torch.int32,
                      device=x_chunk_u8.device)
    x = x_chunk_u8
    for i in range(p):
        # the chunk held at step i is global chunk (me - i) mod p
        src = (me - i) % p
        nxt = ring_shift(x, pa) if i < p - 1 else None
        w = w_cols_nk[:, src * k_chunk:(src + 1) * k_chunk].contiguous()
        acc += s8_product(recentre(x), w)
        if nxt is not None:
            x = nxt()
    ring_qgemm.calls += 1
    return _requant_epilogue(acc + oc.reshape(1, -1), ep, scale_a=scale_a,
                             scale_c=scale_c, zp_c=zp_c, relu=relu,
                             rounding=rounding, order="gemm")


ring_qgemm.calls = 0


def ring_linear_reference(x_full_u8, w_nk, oc, ep, **kw):
    """Single-device oracle with the same epilogue (for tests)."""
    return qgemm_plain(x_full_u8, w_nk, oc, ep, **kw)
