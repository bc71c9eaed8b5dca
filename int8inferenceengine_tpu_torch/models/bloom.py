"""BloomDecoder: the BLOOM-family INT8 LM with ALiBi attention (counterpart
of ``int8inferenceengine_tpu.models.bloom``).

* **ALiBi instead of positional embeddings**: the scores carry a per-head
  linear bias ``m_h * (col - row_position)`` (``QuantSoftmax(alibi_heads=
  H)``, the slopes ``layers.alibi_slopes``).  The bias is a function of
  absolute positions only, so a cached decode step gives a full
  recompute's codes.  The cached steps run the composed attention over all
  ``max_len`` cache rows (``ops/attention.decode_attention_alibi``), as the
  JAX package's do: its kernel has no bias tail, and neither has B3.
* **Embedding LayerNorm** on the token embeddings before the first block
  (the ``_stem`` override); there is no position table.
* Otherwise the gpt block of ``TextDecoder``: MHA, biased Linears, pre-LN,
  a gelu MLP with gelu in B1's epilogue.
"""

from __future__ import annotations

from ..config import DEFAULT_CONFIG, QuantConfig
from ..layers import (Linear, QuantAct, QuantAdd, QuantEmbed,
                      QuantLayerNorm, QuantMatmul, QuantSoftmax, alibi_slopes)
from ..module import Module
from ..tensor import Tensor
from .text_decoder import TextDecoder

__all__ = ["BloomDecoder", "torch_bloom"]


class BloomDecoder(TextDecoder):
    """BLOOM-family causal LM (bloom_tiny defaults: 128 dim / 2 blocks / 4
    heads, ALiBi attention, embedding LayerNorm)."""

    def __init__(self, vocab_size: int = 1000, max_len: int = 64,
                 dim: int = 128, depth: int = 2, heads: int = 4,
                 mlp_ratio: int = 4, eps: float = 1e-5,
                 config: QuantConfig = DEFAULT_CONFIG, device=None):
        Module.__init__(self, config, device)
        if dim % heads:
            raise ValueError(f"dim {dim} not divisible by heads {heads}")
        self.vocab_size, self.max_len = vocab_size, max_len
        self.dim, self.depth, self.heads = dim, depth, heads
        self.kv_heads = heads
        self.head_dim = dim // heads
        self.mlp_hidden = mlp_ratio * dim
        self.act = "gelu"
        self.sliding_window = None
        self.ring_cache = False
        self.INPUT_SHAPE = (max_len,)
        kw = dict(config=config, device=self.device)
        self.embed = QuantEmbed(vocab_size, dim, **kw)
        self.embed_ln = QuantLayerNorm(dim, eps, **kw)
        for i in range(1, depth + 1):
            setattr(self, f"ln1_{i}", QuantLayerNorm(dim, eps, **kw))
            for w in ("wq", "wk", "wv"):
                setattr(self, f"{w}{i}", Linear(dim, dim, **kw))
            setattr(self, f"attn{i}", QuantMatmul(
                alpha=self.head_dim ** -0.5, transpose_b=True, **kw))
            setattr(self, f"smax{i}", QuantSoftmax(
                causal=True, alibi_heads=heads, **kw))
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

    def tp_roles(self, model_size: int) -> dict:
        """No head-local attention: the ALiBi slopes index GLOBAL heads, so
        QKV stay column-parallel and gathered; the MLP still shards."""
        roles = {}
        for i in range(1, self.depth + 1):
            roles[f"proj{i}"] = "row"
            roles[f"fc1_{i}"] = "col_local"
            roles[f"fc2_{i}"] = "row"
        return roles

    def _stem(self, ids: Tensor, start=None) -> Tensor:
        # no position table: ALiBi carries position in the scores, so
        # ``start`` goes unused (absolute positions enter through each
        # attention's live length)
        return self.embed_ln(self.embed(ids))


def torch_bloom(vocab_size: int = 1000, max_len: int = 64, dim: int = 128,
                depth: int = 2, heads: int = 4, mlp_ratio: int = 4,
                eps: float = 1e-5, seed: int = 42):
    """Matching ``torch.nn`` oracle (HF Bloom's math: ALiBi biases, the
    embedding LayerNorm, erf gelu) with the framework model's attribute
    names; the same weights as the JAX package's twin for a seed."""
    import torch
    import torch.nn as nn

    torch.manual_seed(seed)
    slopes = torch.tensor(alibi_slopes(heads), dtype=torch.float32)
    hd = dim // heads

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(vocab_size, dim)
            self.embed_ln = nn.LayerNorm(dim, eps=eps)
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
            dev = ids.device
            x = self.embed_ln(self.embed(ids))
            row = torch.arange(t, device=dev)[:, None]
            col = torch.arange(t, device=dev)[None, :]
            mask = torch.where(col <= row, 0.0, float("-inf"))
            bias = slopes.to(dev).view(heads, 1, 1) * (col - row).float()

            def heads_of(y):
                return y.view(b, t, heads, hd).transpose(1, 2)
            for i in range(1, depth + 1):
                h = getattr(self, f"ln1_{i}")(x)
                q = heads_of(getattr(self, f"wq{i}")(h))
                k = heads_of(getattr(self, f"wk{i}")(h))
                v = heads_of(getattr(self, f"wv{i}")(h))
                s = q @ k.transpose(-1, -2) * hd ** -0.5 + bias + mask
                o = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(
                    b, t, dim)
                x = x + getattr(self, f"proj{i}")(o)
                x = x + getattr(self, f"fc2_{i}")(torch.nn.functional.gelu(
                    getattr(self, f"fc1_{i}")(getattr(self, f"ln2_{i}")(x))))
            return self.head(self.ln_f(x))

    return Net().eval()
