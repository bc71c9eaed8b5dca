"""ViT: the INT8 Vision Transformer (counterpart of
``int8inferenceengine_tpu.models.vit``).

The patch stem is a ``Conv2d`` with kernel = stride = patch (kernel B1's
gathered conv on the card), ``F.to_tokens`` turns its NHWC codes into
[B, T, C] tokens, and ``QuantPosEmbed`` prepends the class token and adds
the positions.  Each block is pre-LN attention and a gelu MLP; every
pointwise layer (LayerNorm, Linear, add, gelu) runs on the flat [B*T, C]
view, only the head split and merge touch [B, H, T, D].  Under the
configuration's switches the three projections run as one merged GEMM
(``fused_qkv``: kernel B2), fc1 -> gelu as one GEMM with gelu in its
epilogue (``fused_linear_act``: B1), and the attention as one composed op
(``fused_attention``).

Flat attribute naming and a hand-written torch twin, so that
``model.load(torch_vit(...).state_dict())`` works as-is.
"""

from __future__ import annotations

from ..config import DEFAULT_CONFIG, QuantConfig
from ..layers import (Conv2d, Linear, QuantAct, QuantAdd, QuantLayerNorm,
                      QuantMatmul, QuantPosEmbed, QuantSoftmax,
                      fused_attention, fused_linear_act, fused_qkv)
from ..module import Module
from ..ops import functional as F

__all__ = ["ViT", "torch_vit", "encoder_blocks", "encoder_forward",
           "encoder_twin_forward"]


def encoder_blocks(model, dim: int, depth: int, heads: int, mlp_ratio: int,
                   config: QuantConfig) -> None:
    """Declare the encoders' blocks on ``model`` (ViT, TextTransformer):
    per block i ``ln1_{i}``, ``wq{i}``/``wk{i}``/``wv{i}``, ``attn{i}``
    (QK^T, alpha = 1/sqrt(head_dim)), ``smax{i}``, ``av{i}`` (P@V),
    ``proj{i}``, ``add1_{i}``, ``ln2_{i}``, ``fc1_{i}``, ``gelu{i}``,
    ``fc2_{i}``, ``add2_{i}``; then ``ln_f``."""
    d = model.device
    hd = dim // heads
    for i in range(1, depth + 1):
        setattr(model, f"ln1_{i}", QuantLayerNorm(dim, config=config,
                                                  device=d))
        for w in ("wq", "wk", "wv"):
            setattr(model, f"{w}{i}", Linear(dim, dim, config=config,
                                             device=d))
        setattr(model, f"attn{i}", QuantMatmul(
            alpha=hd ** -0.5, transpose_b=True, config=config, device=d))
        setattr(model, f"smax{i}", QuantSoftmax(config=config, device=d))
        setattr(model, f"av{i}", QuantMatmul(config=config, device=d))
        setattr(model, f"proj{i}", Linear(dim, dim, config=config, device=d))
        setattr(model, f"add1_{i}", QuantAdd(config=config, device=d))
        setattr(model, f"ln2_{i}", QuantLayerNorm(dim, config=config,
                                                  device=d))
        setattr(model, f"fc1_{i}", Linear(dim, mlp_ratio * dim,
                                          config=config, device=d))
        setattr(model, f"gelu{i}", QuantAct("gelu", config=config, device=d))
        setattr(model, f"fc2_{i}", Linear(mlp_ratio * dim, dim,
                                          config=config, device=d))
        setattr(model, f"add2_{i}", QuantAdd(config=config, device=d))
    model.ln_f = QuantLayerNorm(dim, config=config, device=d)


def encoder_forward(model, x):
    """The blocks of ``encoder_blocks`` over tokens ``x`` [B, T, C], then
    ``ln_f``, the class token and ``head``."""
    cfg = model.config
    b, t, c = x.shape
    x = x.reshape(b * t, c)
    for i in range(1, model.depth + 1):
        h = getattr(model, f"ln1_{i}")(x)
        if cfg.fuse_qkv != "off":
            q2, k2, v2 = fused_qkv(getattr(model, f"wq{i}"),
                                   getattr(model, f"wk{i}"),
                                   getattr(model, f"wv{i}"), h)
        else:
            q2 = getattr(model, f"wq{i}")(h)
            k2 = getattr(model, f"wk{i}")(h)
            v2 = getattr(model, f"wv{i}")(h)
        # -1 widths: under head-parallel TP the projections keep their
        # local channel shard (c / model_size)
        qh = F.split_heads(q2.reshape(b, t, -1), model.heads)
        kh = F.split_heads(k2.reshape(b, t, -1), model.heads)
        vh = F.split_heads(v2.reshape(b, t, -1), model.heads)
        attn = getattr(model, f"attn{i}")
        if attn.is_quantized and qh.quantized \
                and cfg.fused_attention != "off":
            o = fused_attention(attn, getattr(model, f"smax{i}"),
                                getattr(model, f"av{i}"), qh, kh, vh)
        else:
            s = attn(qh, kh)
            p = getattr(model, f"smax{i}")(s)
            o = getattr(model, f"av{i}")(p, vh)
        o = F.merge_heads(o).reshape(b * t, -1)
        o = getattr(model, f"proj{i}")(o)
        x = getattr(model, f"add1_{i}")(x, o)
        h = getattr(model, f"ln2_{i}")(x)
        fc1, gelu = getattr(model, f"fc1_{i}"), getattr(model, f"gelu{i}")
        if fc1.is_quantized and cfg.fuse_linear_act:
            h = fused_linear_act(fc1, gelu, h)
        else:
            h = gelu(fc1(h))
        h = getattr(model, f"fc2_{i}")(h)
        x = getattr(model, f"add2_{i}")(x, h)
    x = model.ln_f(x)
    x = F.select_token(x.reshape(b, t, c), 0)
    return model.head(x)


class ViT(Module):
    """Vision Transformer (vit_tiny defaults, the JAX package's: 224 x 224,
    patch 16, dim 192, 12 blocks, 3 heads, MLP 4 x dim, 10 classes).

    ``patch`` -> ``to_tokens`` -> ``pe`` (class token and positions) ->
    the blocks of ``encoder_blocks`` -> ``ln_f`` -> the class token ->
    ``head``."""

    def __init__(self, img_size: int = 224, patch: int = 16, dim: int = 192,
                 depth: int = 12, heads: int = 3, mlp_ratio: int = 4,
                 num_classes: int = 10, config: QuantConfig = DEFAULT_CONFIG,
                 device=None):
        super().__init__(config, device)
        if img_size % patch:
            raise ValueError(f"img_size {img_size} not divisible by "
                             f"patch {patch}")
        if dim % heads:
            raise ValueError(f"dim {dim} not divisible by heads {heads}")
        self.INPUT_SHAPE = (3, img_size, img_size)
        self.dim, self.depth, self.heads = dim, depth, heads
        t = (img_size // patch) ** 2
        d = self.device
        self.patch = Conv2d(3, dim, patch, stride=patch, config=config,
                            device=d)
        self.pe = QuantPosEmbed(t, dim, config=config, device=d)
        encoder_blocks(self, dim, depth, heads, mlp_ratio, config)
        self.head = Linear(dim, num_classes, config=config, device=d)

    def tp_roles(self, model_size: int) -> dict:
        """Megatron-style transformer TP plan (see TextDecoder.tp_roles).
        Where the heads do not divide the model axis (ViT-Tiny's 3 over
        2) QKV stay plain column-parallel (gathered) and attention runs on
        full heads, while proj/fc1/fc2 still shard."""
        roles = {}
        head_local = self.heads % model_size == 0
        for i in range(1, self.depth + 1):
            if head_local:
                for w in ("wq", "wk", "wv"):
                    roles[f"{w}{i}"] = "col_local"
            roles[f"proj{i}"] = "row"
            roles[f"fc1_{i}"] = "col_local"
            roles[f"fc2_{i}"] = "row"
        return roles

    def forward(self, x):
        x = self.pe(F.to_tokens(self.patch(x)))
        return encoder_forward(self, x)


def torch_vit(img_size: int = 224, patch: int = 16, dim: int = 192,
              depth: int = 12, heads: int = 3, mlp_ratio: int = 4,
              num_classes: int = 10, seed: int = 42):
    """Matching ``torch.nn`` oracle with the framework model's attribute
    names (the same weights as the JAX package's twin for a seed).  The
    class token and the positions live in ``pe``: ``pe.weight`` [T+1, C]
    and ``pe.bias`` [C]."""
    import torch
    import torch.nn as nn
    import torch.nn.functional as tF

    torch.manual_seed(seed)
    t = (img_size // patch) ** 2
    hd = dim // heads

    class PE(nn.Module):
        def __init__(self):
            super().__init__()
            self.weight = nn.Parameter(torch.randn(t + 1, dim) * 0.02)
            self.bias = nn.Parameter(torch.randn(dim) * 0.02)

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.patch = nn.Conv2d(3, dim, patch, stride=patch)
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

        def forward(self, x):
            b = x.shape[0]
            x = self.patch(x).flatten(2).transpose(1, 2)        # [B, T, C]
            cls = self.pe.bias.reshape(1, 1, dim).expand(b, 1, dim)
            x = torch.cat([cls, x], dim=1) + self.pe.weight
            return encoder_twin_forward(self, x, b, dim, heads, hd, depth,
                                        tF)

    return Net()


def encoder_twin_forward(net, x, b, dim, heads, hd, depth, tF):
    """The twins' blocks, ``ln_f`` and class-token head over [B, T, C]."""
    for i in range(1, depth + 1):
        h = getattr(net, f"ln1_{i}")(x)

        def heads_of(z):
            return z.reshape(b, -1, heads, hd).transpose(1, 2)
        q = heads_of(getattr(net, f"wq{i}")(h))
        k = heads_of(getattr(net, f"wk{i}")(h))
        v = heads_of(getattr(net, f"wv{i}")(h))
        s = (q @ k.transpose(-1, -2)) * hd ** -0.5
        p = tF.softmax(s, dim=-1)
        o = (p @ v).transpose(1, 2).reshape(b, -1, dim)
        x = x + getattr(net, f"proj{i}")(o)
        h = getattr(net, f"ln2_{i}")(x)
        x = x + getattr(net, f"fc2_{i}")(tF.gelu(getattr(net, f"fc1_{i}")(h)))
    x = net.ln_f(x)
    return net.head(x[:, 0, :])
