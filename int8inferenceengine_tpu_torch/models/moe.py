"""MoEDecoder: the mixture-of-experts llama-family INT8 LM, mixtral-like
(counterpart of ``int8inferenceengine_tpu.models.moe``).

The llama block's dense SwiGLU MLP (gate/silu/up/mul/down) becomes one
top-k routed ``layers.QuantMoE`` per block (``moe{i}``: stacked expert
weights, a float32 router, dynamic W8A8 expert products, one calibrated
output grid).  Everything else is ``LlamaDecoder``'s: RMSNorm, RoPE, the
kv-compact GQA cache and kernel B3, ``generate``, the extend, speculative
decoding and the engine.  The MLP is positionwise, so a cached decode step
still gives a full recompute's codes.  In a captured decode step the
experts run the dense form (``QuantMoE``)."""

from __future__ import annotations

from ..config import DEFAULT_CONFIG, QuantConfig
from ..layers import QuantMoE
from .llama import LlamaDecoder, swiglu_hidden

__all__ = ["MoEDecoder", "torch_moe"]


class MoEDecoder(LlamaDecoder):
    """llama block body with a top-k MoE MLP (moe_tiny defaults: 128 dim /
    2 blocks / 4 heads over 2 kv / 4 experts, top-2)."""

    def __init__(self, vocab_size: int = 1000, max_len: int = 64,
                 dim: int = 128, depth: int = 2, heads: int = 4,
                 kv_heads: int | None = None, mlp_hidden: int | None = None,
                 n_experts: int = 4, top_k: int = 2,
                 rope_base: float = 10000.0, eps: float = 1e-6,
                 config: QuantConfig = DEFAULT_CONFIG,
                 dispatch: str = "auto", device=None):
        super().__init__(vocab_size=vocab_size, max_len=max_len, dim=dim,
                         depth=depth, heads=heads, kv_heads=kv_heads,
                         mlp_hidden=mlp_hidden, rope_base=rope_base,
                         eps=eps, config=config, device=device)
        self.n_experts, self.top_k = int(n_experts), int(top_k)
        for i in range(1, depth + 1):
            for nm in ("gate", "silu", "up", "mul", "down"):
                delattr(self, f"{nm}{i}")
            setattr(self, f"moe{i}", QuantMoE(
                dim, self.mlp_hidden, n_experts, top_k, config=config,
                dispatch=dispatch, device=self.device))

    def _mlp(self, i, x):
        h = self._l("ln2_", i)(x)
        return self._l("add2_", i)(x, self._l("moe", i)(h))


def torch_moe(vocab_size: int = 1000, max_len: int = 64, dim: int = 128,
              depth: int = 2, heads: int = 4, kv_heads: int | None = None,
              mlp_hidden: int | None = None, n_experts: int = 4,
              top_k: int = 2, rope_base: float = 10000.0,
              eps: float = 1e-6, seed: int = 42):
    """Matching ``torch.nn`` oracle: ``torch_llama``'s attention with each
    dense MLP replaced by stacked experts named ``router`` / ``gate_w`` /
    ``up_w`` / ``down_w`` (they load through ``QuantMoE``'s setters); the
    same weights as the JAX package's twin for a seed."""
    import types

    import torch
    import torch.nn as nn
    import torch.nn.functional as tF

    from .llama import torch_llama

    hidden = swiglu_hidden(dim) if mlp_hidden is None else mlp_hidden
    kv = heads if kv_heads is None else kv_heads
    hd = dim // heads

    class MoE(nn.Module):
        def __init__(self):
            super().__init__()
            self.router = nn.Parameter(torch.randn(n_experts, dim) * 0.05)
            self.gate_w = nn.Parameter(
                torch.randn(n_experts, hidden, dim) * dim ** -0.5)
            self.up_w = nn.Parameter(
                torch.randn(n_experts, hidden, dim) * dim ** -0.5)
            self.down_w = nn.Parameter(
                torch.randn(n_experts, dim, hidden) * hidden ** -0.5)

        def forward(self, h):
            shp = h.shape
            f = h.reshape(-1, shp[-1])
            logits = f @ self.router.T
            kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
            w = torch.softmax(
                logits.masked_fill(logits < kth, float("-inf")), dim=-1)
            g = torch.einsum("mk,ehk->meh", f, self.gate_w)
            u = torch.einsum("mk,ehk->meh", f, self.up_w)
            d = torch.einsum("meh,ekh->mek", tF.silu(g) * u, self.down_w)
            return (d * w[:, :, None]).sum(dim=1).reshape(shp)

    net = torch_llama(vocab_size=vocab_size, max_len=max_len, dim=dim,
                      depth=depth, heads=heads, kv_heads=kv_heads,
                      mlp_hidden=mlp_hidden, rope_base=rope_base, eps=eps,
                      seed=seed)
    torch.manual_seed(seed + 1)
    for i in range(1, depth + 1):
        for nm in ("gate", "up", "down"):
            delattr(net, f"{nm}{i}")
        setattr(net, f"moe{i}", MoE())

    def forward(self, ids):
        b, t = ids.shape
        dev = ids.device
        x = self.embed(ids)
        mask = torch.triu(torch.full((t, t), float("-inf"), device=dev), 1)
        half = hd // 2
        inv = rope_base ** (-torch.arange(half, dtype=torch.float32,
                                          device=dev) * (2.0 / hd))
        ang = torch.arange(t, dtype=torch.float32, device=dev)[:, None] * inv
        cos, sin = torch.cos(ang), torch.sin(ang)

        def rot(z):
            z1, z2 = z[..., :half], z[..., half:]
            return torch.cat([z1 * cos - z2 * sin, z2 * cos + z1 * sin], -1)

        def heads_of(z, n):
            return z.reshape(b, -1, n, hd).transpose(1, 2)

        for i in range(1, depth + 1):
            h = getattr(self, f"ln1_{i}")(x)
            qh = rot(heads_of(getattr(self, f"wq{i}")(h), heads))
            kh = rot(heads_of(getattr(self, f"wk{i}")(h), kv))
            vh = heads_of(getattr(self, f"wv{i}")(h), kv)
            kh = kh.repeat_interleave(heads // kv, dim=1)
            vh = vh.repeat_interleave(heads // kv, dim=1)
            s = (qh @ kh.transpose(-1, -2)) * hd ** -0.5 + mask
            o = (torch.softmax(s, dim=-1) @ vh).transpose(1, 2).reshape(
                b, -1, dim)
            x = x + getattr(self, f"proj{i}")(o)
            x = x + getattr(self, f"moe{i}")(getattr(self, f"ln2_{i}")(x))
        return self.head(self.ln_f(x))

    net.forward = types.MethodType(forward, net)
    return net
