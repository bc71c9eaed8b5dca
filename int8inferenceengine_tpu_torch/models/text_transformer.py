"""TextTransformer: the BERT-style INT8 text-classification encoder
(counterpart of ``int8inferenceengine_tpu.models.text_transformer``).

``QuantEmbed`` (a pre-quantized u8 token table: the INT8 stem is a row
gather) takes the raw ids (``Module`` does not quantize an id-consuming
model's input), ``QuantPosEmbed`` prepends the class token and adds the
positions, and the blocks are ViT's (``models/vit.encoder_blocks``:
pre-LN attention and a gelu MLP on the flat [B*T, C] view, with the
merged QKV, fused gelu and fused attention under the configuration's
switches).

Flat attribute naming and a hand-written torch twin.
"""

from __future__ import annotations

from ..config import DEFAULT_CONFIG, QuantConfig
from ..layers import Linear, QuantEmbed, QuantPosEmbed
from ..module import Module
from .vit import encoder_blocks, encoder_forward, encoder_twin_forward

__all__ = ["TextTransformer", "torch_text_transformer"]


class TextTransformer(Module):
    """Encoder-only classifier (text_tiny defaults, the JAX package's: vocab
    1,000, 64 tokens, dim 128, 2 blocks, 2 heads, MLP 4 x dim, 10 classes):
    ``embed`` -> ``pe`` -> blocks -> ``ln_f`` -> the class token ->
    ``head``.  Input: token ids [B, max_len] (clamped into the table)."""

    def __init__(self, vocab_size: int = 1000, max_len: int = 64,
                 dim: int = 128, depth: int = 2, heads: int = 2,
                 mlp_ratio: int = 4, num_classes: int = 10,
                 config: QuantConfig = DEFAULT_CONFIG, device=None):
        super().__init__(config, device)
        if dim % heads:
            raise ValueError(f"dim {dim} not divisible by heads {heads}")
        self.INPUT_SHAPE = (max_len,)
        self.dim, self.depth, self.heads = dim, depth, heads
        self.max_len = max_len
        d = self.device
        self.embed = QuantEmbed(vocab_size, dim, config=config, device=d)
        self.pe = QuantPosEmbed(max_len, dim, config=config, device=d)
        encoder_blocks(self, dim, depth, heads, mlp_ratio, config)
        self.head = Linear(dim, num_classes, config=config, device=d)

    def forward(self, ids):
        return encoder_forward(self, self.pe(self.embed(ids)))


def torch_text_transformer(vocab_size: int = 1000, max_len: int = 64,
                           dim: int = 128, depth: int = 2, heads: int = 2,
                           mlp_ratio: int = 4, num_classes: int = 10,
                           seed: int = 42):
    """Matching ``torch.nn`` oracle with the framework model's attribute
    names (the same weights as the JAX package's twin for a seed)."""
    import torch
    import torch.nn as nn
    import torch.nn.functional as tF

    torch.manual_seed(seed)
    hd = dim // heads

    class PE(nn.Module):
        def __init__(self):
            super().__init__()
            self.weight = nn.Parameter(torch.randn(max_len + 1, dim) * 0.02)
            self.bias = nn.Parameter(torch.randn(dim) * 0.02)

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(vocab_size, dim)
            self.pe = PE()
            for i in range(1, depth + 1):
                setattr(self, f"ln1_{i}", nn.LayerNorm(dim))
                for w in ("wq", "wk", "wv"):
                    setattr(self, f"{w}{i}", nn.Linear(dim, dim))
                setattr(self, f"proj{i}", nn.Linear(dim, dim))
                setattr(self, f"ln2_{i}", nn.LayerNorm(dim))
                setattr(self, f"fc1_{i}", nn.Linear(dim, mlp_ratio * dim))
                setattr(self, f"fc2_{i}", nn.Linear(mlp_ratio * dim, dim))
            self.ln_f = nn.LayerNorm(dim)
            self.head = nn.Linear(dim, num_classes)

        def forward(self, ids):
            b = ids.shape[0]
            x = self.embed(ids.long())
            cls = self.pe.bias.reshape(1, 1, dim).expand(b, 1, dim)
            x = torch.cat([cls, x], dim=1) + self.pe.weight
            return encoder_twin_forward(self, x, b, dim, heads, hd, depth,
                                        tF)

    return Net()
