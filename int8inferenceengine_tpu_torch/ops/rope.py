"""Rotary position embeddings (RoPE), the llama-family position scheme
(counterpart of ``int8inferenceengine_tpu.ops.rope``).

Each head's pair (x[i], x[i + D/2]) rotates by ``pos * inv_freq[i]`` with
``inv_freq[i] = base ** (-2i / D)`` (the llama/HF rotate-half layout).

The cached-decode invariant of the u8 KV cache: position p's angles are
``p * inv_freq`` from one static ``inv_freq`` vector, whichever path (the
prompt's prefill or a decode step) rotates it, so a cached k code equals the
one a full recompute gives.  ``inv_freq`` is computed once, on the CPU, and
copied to the operand's device, so the card and the CPU rotate with the
same table; cos/sin are elementwise on the angle.
"""

from __future__ import annotations

import torch

__all__ = ["inv_freq", "rope_angles", "apply_rope"]


def inv_freq(head_dim: int, base: float = 10000.0, scaling=None):
    """(float32 [head_dim // 2] ``inv_freq``, position divisor or None),
    both static.  ``scaling``: ``("linear", f)`` divides positions by f
    (position interpolation); ``("ntk", f)`` raises the base to
    ``base * f ** (D / (D - 2))``."""
    if head_dim % 2:
        raise ValueError(f"RoPE head_dim must be even, got {head_dim}")
    divisor = None
    if scaling is not None:
        kind, factor = scaling
        factor = float(factor)
        if factor <= 0:
            raise ValueError(f"RoPE scaling factor must be > 0, got {factor}")
        if kind == "linear":
            divisor = factor
        elif kind == "ntk":
            base = float(base) * factor ** (head_dim / (head_dim - 2))
        else:
            raise ValueError(
                f"unknown RoPE scaling {kind!r}; use 'linear' or 'ntk'")
    half = head_dim // 2
    expo = -torch.arange(half, dtype=torch.float32) * torch.tensor(
        2.0 / head_dim, dtype=torch.float32)
    return torch.pow(torch.tensor(float(base), dtype=torch.float32),
                     expo), divisor


def rope_angles(positions: torch.Tensor, head_dim: int, base: float = 10000.0,
                scaling=None, table=None):
    """cos/sin for ``positions`` (int [T] or [B, T]), each
    ``positions.shape + (head_dim // 2,)`` float32.  ``table`` is a
    precomputed ``inv_freq(...)`` result on the positions' device."""
    freq, divisor = inv_freq(head_dim, base, scaling) if table is None \
        else table
    pos = positions.to(torch.float32)
    if divisor is not None:
        pos = pos / torch.tensor(divisor, dtype=torch.float32,
                                 device=pos.device)
    ang = pos[..., None] * freq.to(pos.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Rotate head-split f32 ``x`` [..., T, D]; ``cos``/``sin`` [..., T,
    D/2] broadcast against its leading dims."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
