"""NeoXDecoder: the GPT-NeoX / Pythia-family INT8 LM (counterpart of
``int8inferenceengine_tpu.models.neox``).

It subclasses ``LlamaDecoder`` (the kv cache of post-rotation k codes,
kernel B3, the cached extend, ``generate``, the engine) and changes what
the family changes:

* **parallel residual** (``use_parallel_residual=True``, the NeoX
  default): attention and the MLP read the same block input, ``x +
  attn(ln1(x)) + mlp(ln2(x))``, through the ``_residual`` hook, so the
  prefill, the cached decode step and the extend all take it;
  ``use_parallel_residual=False`` keeps the inherited sequential tail;
* **partial rotary** (``rotary_pct``, 0.25 by default): only the first
  ``head_dim * rotary_pct`` channels of each head rotate
  (``QuantRoPE(rotary_dim=)``); the rest pass through onto rk's grid, so
  the cache still holds post-rotation k codes and a cached code equals a
  full recompute's;
* **biased projections and LayerNorm with bias** (``QuantLayerNorm``),
  multi-head attention (``kv_heads == heads``), and fc1 -> gelu -> fc2 with
  gelu in B1's epilogue (``fused_linear_act``).
"""

from __future__ import annotations

from ..config import DEFAULT_CONFIG, QuantConfig
from ..layers import (Linear, QuantAct, QuantAdd, QuantEmbed,
                      QuantLayerNorm, QuantMatmul, QuantRoPE, QuantSoftmax,
                      fused_linear_act)
from ..module import Module
from .llama import LlamaDecoder
from .text_decoder import TextDecoder

__all__ = ["NeoXDecoder", "torch_neox"]


class NeoXDecoder(LlamaDecoder):
    """GPT-NeoX-family causal LM (neox_tiny defaults: 128 dim / 2 blocks /
    4 heads, rotary_pct 0.25, parallel residual)."""

    def __init__(self, vocab_size: int = 1000, max_len: int = 64,
                 dim: int = 128, depth: int = 2, heads: int = 4,
                 mlp_ratio: int = 4, rotary_pct: float = 0.25,
                 rope_base: float = 10000.0,
                 use_parallel_residual: bool = True, eps: float = 1e-5,
                 config: QuantConfig = DEFAULT_CONFIG, device=None):
        Module.__init__(self, config, device)
        if dim % heads:
            raise ValueError(f"dim {dim} not divisible by heads {heads}")
        self.vocab_size, self.max_len = vocab_size, max_len
        self.dim, self.depth, self.heads = dim, depth, heads
        self.kv_heads = heads
        self.head_dim = dim // heads
        self.mlp_hidden = mlp_ratio * dim
        self.sliding_window = None
        self.ring_cache = False
        self.parallel_residual = bool(use_parallel_residual)
        rotary_dim = int(self.head_dim * float(rotary_pct))
        if rotary_dim % 2:
            raise ValueError(f"head_dim {self.head_dim} * rotary_pct "
                             f"{rotary_pct} gives odd rotary_dim {rotary_dim}")
        self.rotary_dim = rotary_dim
        self.eps = float(eps)
        self.INPUT_SHAPE = (max_len,)
        kw = dict(config=config, device=self.device)
        self.embed = QuantEmbed(vocab_size, dim, **kw)
        for i in range(1, depth + 1):
            setattr(self, f"ln1_{i}", QuantLayerNorm(dim, eps, **kw))
            for w in ("wq", "wk", "wv"):
                setattr(self, f"{w}{i}", Linear(dim, dim, **kw))
            for r in ("rq", "rk"):
                setattr(self, f"{r}{i}", QuantRoPE(
                    self.head_dim, rope_base, rotary_dim=rotary_dim, **kw))
            setattr(self, f"attn{i}", QuantMatmul(
                alpha=self.head_dim ** -0.5, transpose_b=True, **kw))
            setattr(self, f"smax{i}", QuantSoftmax(causal=True, **kw))
            setattr(self, f"av{i}", QuantMatmul(**kw))
            setattr(self, f"proj{i}", Linear(dim, dim, **kw))
            setattr(self, f"add1_{i}", QuantAdd(**kw))
            setattr(self, f"ln2_{i}", QuantLayerNorm(dim, eps, **kw))
            setattr(self, f"fc1_{i}", Linear(dim, self.mlp_hidden, **kw))
            setattr(self, f"gelu{i}", QuantAct("gelu", **kw))
            setattr(self, f"fc2_{i}", Linear(self.mlp_hidden, dim, **kw))
            setattr(self, f"add2_{i}", QuantAdd(**kw))
        self.ln_f = QuantLayerNorm(dim, eps, **kw)
        self.head = Linear(dim, vocab_size, **kw)

    # the gpt block's plan (fc1 / fc2, not llama's gate / up / down)
    tp_roles = TextDecoder.tp_roles

    def _mlp_out(self, i, x):
        """ln2 -> fc1/gelu (fused when converted) -> fc2, without the
        residual add."""
        h = self._l("ln2_", i)(x)
        fc1, gelu = self._l("fc1_", i), self._l("gelu", i)
        if fc1.is_quantized and self.config.fuse_linear_act:
            h = fused_linear_act(fc1, gelu, h)
        else:
            h = gelu(fc1(h))
        return self._l("fc2_", i)(h)

    def _mlp(self, i, x):
        # the sequential tail (use_parallel_residual=False) reaches this
        # through the inherited _residual
        return self._l("add2_", i)(x, self._mlp_out(i, x))

    def _residual(self, i, x, o):
        if not self.parallel_residual:
            return super()._residual(i, x, o)
        m = self._mlp_out(i, x)             # the MLP reads the block input
        return self._l("add2_", i)(self._l("add1_", i)(x, o), m)


def torch_neox(vocab_size: int = 1000, max_len: int = 64, dim: int = 128,
               depth: int = 2, heads: int = 4, mlp_ratio: int = 4,
               rotary_pct: float = 0.25, rope_base: float = 10000.0,
               use_parallel_residual: bool = True, eps: float = 1e-5,
               seed: int = 42):
    """Matching ``torch.nn`` oracle (HF GPTNeoX's math: parallel residual,
    partial rotary in the half-split pair layout, erf gelu) with the
    framework model's attribute names, so its ``state_dict`` loads as-is;
    the same weights as the JAX package's twin for a seed."""
    import torch
    import torch.nn as nn

    torch.manual_seed(seed)
    hd = dim // heads
    rd = int(hd * rotary_pct)

    def rope(x):
        # x [B, H, T, D]: rotate the first rd channels
        t, dev = x.shape[-2], x.device
        pos = torch.arange(t, dtype=torch.float32, device=dev)
        inv = rope_base ** (-torch.arange(0, rd, 2, dtype=torch.float32,
                                          device=dev) / rd)
        ang = pos[:, None] * inv[None, :]
        cos, sin = torch.cos(ang), torch.sin(ang)
        x1, x2 = x[..., : rd // 2], x[..., rd // 2: rd]
        rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        return torch.cat([rot, x[..., rd:]], dim=-1)

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(vocab_size, dim)
            for i in range(1, depth + 1):
                setattr(self, f"ln1_{i}", nn.LayerNorm(dim, eps=eps))
                for w in ("wq", "wk", "wv"):
                    setattr(self, f"{w}{i}", nn.Linear(dim, dim))
                setattr(self, f"proj{i}", nn.Linear(dim, dim))
                setattr(self, f"ln2_{i}", nn.LayerNorm(dim, eps=eps))
                setattr(self, f"fc1_{i}", nn.Linear(dim, mlp_ratio * dim))
                setattr(self, f"fc2_{i}", nn.Linear(mlp_ratio * dim, dim))
            self.ln_f = nn.LayerNorm(dim, eps=eps)
            self.head = nn.Linear(dim, vocab_size)

        def forward(self, ids):
            b, t = ids.shape
            x = self.embed(ids)
            mask = torch.triu(torch.full((t, t), float("-inf"),
                                         device=ids.device), diagonal=1)

            def heads_of(y):
                return y.view(b, t, heads, hd).transpose(1, 2)
            for i in range(1, depth + 1):
                h = getattr(self, f"ln1_{i}")(x)
                q = rope(heads_of(getattr(self, f"wq{i}")(h)))
                k = rope(heads_of(getattr(self, f"wk{i}")(h)))
                v = heads_of(getattr(self, f"wv{i}")(h))
                s = q @ k.transpose(-1, -2) * hd ** -0.5 + mask
                o = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(
                    b, t, dim)
                a = getattr(self, f"proj{i}")(o)
                m = getattr(self, f"fc2_{i}")(torch.nn.functional.gelu(
                    getattr(self, f"fc1_{i}")(getattr(self, f"ln2_{i}")(
                        x if use_parallel_residual else x + a))))
                x = x + a + m
            return self.head(self.ln_f(x))

    return Net().eval()
