"""GemmaDecoder: the gemma-2-family INT8 LM (counterpart of
``int8inferenceengine_tpu.models.gemma``).

It subclasses ``LlamaDecoder`` (RoPE, the kv-compact GQA cache, kernel B3,
``generate``, the engine) and changes only what gemma-2 changes:

* **unit-offset RMSNorms** (``QuantRMSNorm(unit_offset=True)``): the
  checkpoints store each gain as a delta around 1, and so does the layer;
* **sandwich norms**: ``postn1_{i}`` norms the attention output (the
  ``_attn_out`` hook) and ``postn2_{i}`` the MLP's, each before its
  residual add, on top of the pre-norms;
* **GeGLU**: ``down(gelu_tanh(gate(x)) * up(x))``, the tanh gelu a
  composed ``QuantAct`` (the JAX ``_mlp`` does not fuse it into the GEMM);
* **attention softcap**: scores pass ``cap * tanh(s / cap)`` before the
  mask and the softmax (``QuantSoftmax(softcap=)``; B3 applies it on the
  card);
* **final softcap** on the FP32 forward only: tanh is monotone, so greedy
  argmax over the INT8 logit codes is the same without it, and the INT8
  logits are left uncapped (sampled INT8 logits are not capped either);
* **sqrt(dim) embedding scale** as a pure rescale of the embedding's grid:
  value = (code - zp) * (scale * sqrt(dim)), no code changes;
* **local and global blocks**: odd blocks (1-indexed) attend within
  ``sliding_window``, even blocks globally; with ``ring_cache=True`` only
  the odd blocks' caches are rings;
* **head_dim decoupled from dim / heads**: q projects to ``heads *
  head_dim``, k/v to ``kv_heads * head_dim``, and proj back to ``dim``.
"""

from __future__ import annotations

import torch

from ..config import DEFAULT_CONFIG, QuantConfig
from ..layers import (Linear, QuantAct, QuantAdd, QuantEmbed, QuantMatmul,
                      QuantMul, QuantRMSNorm, QuantRoPE, QuantSoftmax)
from ..module import Module
from ..ops.quant import f32
from ..tensor import Tensor
from .llama import LlamaDecoder

__all__ = ["GemmaDecoder", "torch_gemma"]


class GemmaDecoder(LlamaDecoder):
    """gemma-2-family causal LM (gemma_tiny defaults: 128 dim / 2 blocks /
    4 query heads, a window of 32 on the odd blocks)."""

    def __init__(self, vocab_size: int = 1000, max_len: int = 64,
                 dim: int = 128, depth: int = 2, heads: int = 4,
                 kv_heads: int | None = None, head_dim: int | None = None,
                 mlp_hidden: int | None = None, rope_base: float = 10000.0,
                 sliding_window: int | None = 32, ring_cache: bool = False,
                 attn_softcap: float = 50.0, final_softcap: float = 30.0,
                 eps: float = 1e-6, config: QuantConfig = DEFAULT_CONFIG,
                 device=None):
        Module.__init__(self, config, device)
        kv_heads = heads if kv_heads is None else int(kv_heads)
        if heads % kv_heads:
            raise ValueError(
                f"heads {heads} not divisible by kv_heads {kv_heads}")
        self.vocab_size, self.max_len = vocab_size, max_len
        self.dim, self.depth, self.heads = dim, depth, heads
        self.kv_heads = kv_heads
        self.head_dim = dim // heads if head_dim is None else int(head_dim)
        self.mlp_hidden = 4 * dim if mlp_hidden is None else int(mlp_hidden)
        self.sliding_window = (None if sliding_window is None
                               else int(sliding_window))
        if ring_cache and self.sliding_window is None:
            raise ValueError("ring_cache requires sliding_window")
        self.ring_cache = bool(ring_cache)
        self.attn_softcap = float(attn_softcap)
        self.final_softcap = float(final_softcap)
        self.INPUT_SHAPE = (max_len,)
        q_dim, kv_dim = heads * self.head_dim, kv_heads * self.head_dim
        kw = dict(config=config, device=self.device)

        def norm():
            return QuantRMSNorm(dim, eps, unit_offset=True, **kw)

        self.embed = QuantEmbed(vocab_size, dim, **kw)
        for i in range(1, depth + 1):
            window = self.sliding_window if i % 2 == 1 else None
            setattr(self, f"ln1_{i}", norm())
            setattr(self, f"wq{i}", Linear(dim, q_dim, **kw))
            setattr(self, f"wk{i}", Linear(dim, kv_dim, **kw))
            setattr(self, f"wv{i}", Linear(dim, kv_dim, **kw))
            for r in ("rq", "rk"):
                setattr(self, f"{r}{i}", QuantRoPE(self.head_dim, rope_base,
                                                   **kw))
            setattr(self, f"attn{i}", QuantMatmul(
                alpha=self.head_dim ** -0.5, transpose_b=True, **kw))
            setattr(self, f"smax{i}", QuantSoftmax(
                causal=True, window=window, softcap=self.attn_softcap, **kw))
            setattr(self, f"av{i}", QuantMatmul(**kw))
            setattr(self, f"proj{i}", Linear(q_dim, dim, **kw))
            setattr(self, f"postn1_{i}", norm())
            setattr(self, f"add1_{i}", QuantAdd(**kw))
            setattr(self, f"ln2_{i}", norm())
            setattr(self, f"gate{i}", Linear(dim, self.mlp_hidden, **kw))
            setattr(self, f"gelu{i}", QuantAct("gelu_tanh", **kw))
            setattr(self, f"up{i}", Linear(dim, self.mlp_hidden, **kw))
            setattr(self, f"mul{i}", QuantMul(**kw))
            setattr(self, f"down{i}", Linear(self.mlp_hidden, dim, **kw))
            setattr(self, f"postn2_{i}", norm())
            setattr(self, f"add2_{i}", QuantAdd(**kw))
        self.ln_f = norm()
        self.head = Linear(dim, vocab_size, **kw)

    # -- the gemma deltas ------------------------------------------------------
    def _stem(self, ids: Tensor, start=None) -> Tensor:
        x = self.embed(ids)
        c = float(self.dim) ** 0.5
        if x.quantized:
            return Tensor(x.data, x.scale * c, x.zero_point)
        return Tensor(x.data * f32(c, x.device))

    def _attn_out(self, i, o):
        return self._l("postn1_", i)(o)

    def _mlp(self, i, x):
        h = self._l("ln2_", i)(x)
        g = self._l("gelu", i)(self._l("gate", i)(h))
        m = self._l("mul", i)(g, self._l("up", i)(h))
        d = self._l("postn2_", i)(self._l("down", i)(m))
        return self._l("add2_", i)(x, d)

    def forward(self, ids):
        out = super().forward(ids)
        if out.quantized:
            return out
        c = f32(self.final_softcap, out.device)
        return Tensor(c * torch.tanh(out.data / c))


def torch_gemma(vocab_size: int = 1000, max_len: int = 64, dim: int = 128,
                depth: int = 2, heads: int = 4, kv_heads: int | None = None,
                head_dim: int | None = None, mlp_hidden: int | None = None,
                rope_base: float = 10000.0, sliding_window: int | None = 32,
                attn_softcap: float = 50.0, final_softcap: float = 30.0,
                eps: float = 1e-6, seed: int = 42):
    """Matching ``torch.nn`` oracle (same attribute names, so its
    ``state_dict`` loads as-is), built on the default device; its forward
    runs on the device of its input."""
    import torch.nn as nn
    import torch.nn.functional as tF

    torch.manual_seed(seed)
    kv = heads if kv_heads is None else kv_heads
    hd = dim // heads if head_dim is None else head_dim
    hidden = 4 * dim if mlp_hidden is None else mlp_hidden
    grp = heads // kv

    class RMSNorm(nn.Module):
        def __init__(self, d):
            super().__init__()
            self.weight = nn.Parameter(torch.zeros(d))        # unit offset

        def forward(self, x):
            ms = x.pow(2).mean(-1, keepdim=True)
            return x * torch.rsqrt(ms + eps) * (1.0 + self.weight)

    def rope(x):
        t, d = x.shape[2], x.shape[3]
        half = d // 2
        inv = rope_base ** (-torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half)
        pos = torch.arange(t, dtype=torch.float32, device=x.device)
        ang = pos[:, None] * inv[None, :]
        cos, sin = torch.cos(ang), torch.sin(ang)
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(vocab_size, dim)
            for i in range(1, depth + 1):
                setattr(self, f"ln1_{i}", RMSNorm(dim))
                setattr(self, f"wq{i}", nn.Linear(dim, heads * hd,
                                                  bias=False))
                setattr(self, f"wk{i}", nn.Linear(dim, kv * hd, bias=False))
                setattr(self, f"wv{i}", nn.Linear(dim, kv * hd, bias=False))
                setattr(self, f"proj{i}", nn.Linear(heads * hd, dim,
                                                    bias=False))
                setattr(self, f"postn1_{i}", RMSNorm(dim))
                setattr(self, f"ln2_{i}", RMSNorm(dim))
                setattr(self, f"gate{i}", nn.Linear(dim, hidden, bias=False))
                setattr(self, f"up{i}", nn.Linear(dim, hidden, bias=False))
                setattr(self, f"down{i}", nn.Linear(hidden, dim, bias=False))
                setattr(self, f"postn2_{i}", RMSNorm(dim))
            self.ln_f = RMSNorm(dim)
            self.head = nn.Linear(dim, vocab_size, bias=False)

        def forward(self, ids):
            x = self.embed(ids) * (dim ** 0.5)
            b, t, _ = x.shape
            row = torch.arange(t, device=ids.device)[:, None]
            col = torch.arange(t, device=ids.device)[None, :]
            for i in range(1, depth + 1):
                h = getattr(self, f"ln1_{i}")(x)
                q = getattr(self, f"wq{i}")(h).view(b, t, heads, hd
                                                    ).transpose(1, 2)
                k = getattr(self, f"wk{i}")(h).view(b, t, kv, hd
                                                    ).transpose(1, 2)
                v = getattr(self, f"wv{i}")(h).view(b, t, kv, hd
                                                    ).transpose(1, 2)
                q, k = rope(q), rope(k)
                k = k.repeat_interleave(grp, dim=1)
                v = v.repeat_interleave(grp, dim=1)
                s = (q @ k.transpose(-1, -2)) * (hd ** -0.5)
                s = attn_softcap * torch.tanh(s / attn_softcap)
                keep = col <= row
                if sliding_window is not None and i % 2 == 1:
                    keep = keep & (col > row - sliding_window)
                s = s.masked_fill(~keep, float("-inf"))
                o = (tF.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(
                    b, t, heads * hd)
                x = x + getattr(self, f"postn1_{i}")(
                    getattr(self, f"proj{i}")(o))
                h = getattr(self, f"ln2_{i}")(x)
                g = tF.gelu(getattr(self, f"gate{i}")(h), approximate="tanh")
                x = x + getattr(self, f"postn2_{i}")(
                    getattr(self, f"down{i}")(g * getattr(self, f"up{i}")(h)))
            logits = self.head(self.ln_f(x))
            return final_softcap * torch.tanh(logits / final_softcap)

    return Net()
