"""LlamaDecoder: the llama-family INT8 LM, RMSNorm / RoPE / GQA / SwiGLU
(counterpart of ``int8inferenceengine_tpu.models.llama``).

It subclasses ``TextDecoder`` and overrides only the block bodies; the
prefill into the u8 T-major flat KV cache, the cached decode step, the
cached multi-token extend, ``generate`` and ``generate_speculative`` are
inherited:

* **RoPE defines the KV-cache grid**: the cache holds post-rotation k codes
  at the k-side ``QuantRoPE``'s (scale, zp) (``_kv_scales``).  Prefill and
  decode rotate with the same static ``inv_freq`` (``ops/rope.py``), so a
  cached code equals a full recompute's.
* **GQA stays kv-compact**: wk/wv project to ``kv_heads * head_dim``
  channels, the cache holds only kv heads, and the decode attention groups
  each kv head's query heads (kernel B3); only the prefill expands kv views
  (``F.repeat_kv``).
* **SwiGLU** = down(silu(gate(x)) * up(x)) with a calibrated ``QuantMul``;
  the three Linears are bias-free (zero biases quantize to exactly zero).
  Under W8A8 gate rides B1's fused silu epilogue; under W4A8 gate and up
  are one merged call (``fused_w4a8_multi``) and silu stays a composed
  ``QuantAct``.

* **The mistral family** (``sliding_window=W``): every position attends to
  at most the last W positions, through ``QuantSoftmax(window=)`` in the
  prefill and kernel B3's window in the cached steps; ``ring_cache=True``
  gives each windowed layer a ring of roundup32(2W) cache rows instead of
  ``max_len`` (``TextDecoder._cache_rows``).

* **The weight-only modes** keep a head-split float cache [B, Hkv, T, D]
  (``TextDecoder._float_attention``): each kv head's query heads read it
  through a grouped view, so GQA never repeats the cache in the cached
  steps either.
"""

from __future__ import annotations

from ..config import DEFAULT_CONFIG, QuantConfig
from ..layers import (Linear, QuantAct, QuantAdd, QuantEmbed, QuantMatmul,
                      QuantMul, QuantRMSNorm, QuantRoPE, QuantSoftmax,
                      fused_decode_attention, fused_extend_attention,
                      fused_linear_act, fused_w4a8_multi)
from ..module import Module
from ..ops import functional as F
from ..tensor import Tensor
from .text_decoder import TextDecoder

__all__ = ["LlamaDecoder", "torch_llama", "swiglu_hidden"]


def swiglu_hidden(dim: int, multiple_of: int = 64) -> int:
    """The llama MLP width: ``(8 * dim) // 3`` rounded up to a multiple of
    ``multiple_of``."""
    h = (8 * dim) // 3
    return -(-h // multiple_of) * multiple_of


class LlamaDecoder(TextDecoder):
    """Causal llama-family LM (llama_tiny defaults: 128 dim / 2 blocks /
    4 query heads).

    Per block i: ``ln1_{i}`` (RMSNorm) -> ``wq{i}``/``wk{i}``/``wv{i}``
    (bias-free; k/v at kv_heads width) -> ``rq{i}``/``rk{i}`` (RoPE) ->
    ``attn{i}`` -> ``smax{i}`` -> ``av{i}`` -> ``proj{i}`` -> ``add1_{i}``;
    then ``ln2_{i}`` -> ``gate{i}``+``silu{i}`` / ``up{i}`` -> ``mul{i}``
    -> ``down{i}`` -> ``add2_{i}``.  Head: ``ln_f`` -> ``head``.
    """

    def __init__(self, vocab_size: int = 1000, max_len: int = 64,
                 dim: int = 128, depth: int = 2, heads: int = 4,
                 kv_heads: int | None = None, mlp_hidden: int | None = None,
                 rope_base: float = 10000.0, rope_scaling=None,
                 sliding_window: int | None = None,
                 ring_cache: bool = False, eps: float = 1e-6,
                 config: QuantConfig = DEFAULT_CONFIG, device=None):
        Module.__init__(self, config, device)
        kv_heads = heads if kv_heads is None else int(kv_heads)
        if dim % heads:
            raise ValueError(f"dim {dim} not divisible by heads {heads}")
        if heads % kv_heads:
            raise ValueError(
                f"heads {heads} not divisible by kv_heads {kv_heads}")
        self.vocab_size, self.max_len = vocab_size, max_len
        self.dim, self.depth, self.heads = dim, depth, heads
        self.kv_heads = kv_heads
        self.head_dim = dim // heads
        self.mlp_hidden = (swiglu_hidden(dim) if mlp_hidden is None
                           else int(mlp_hidden))
        self.sliding_window = (None if sliding_window is None
                               else int(sliding_window))
        if ring_cache and self.sliding_window is None:
            raise ValueError("ring_cache requires sliding_window")
        self.ring_cache = bool(ring_cache)
        self.INPUT_SHAPE = (max_len,)
        kv_dim = kv_heads * self.head_dim
        kw = dict(config=config, device=self.device)
        self.embed = QuantEmbed(vocab_size, dim, **kw)
        for i in range(1, depth + 1):
            setattr(self, f"ln1_{i}", QuantRMSNorm(dim, eps, **kw))
            setattr(self, f"wq{i}", Linear(dim, dim, **kw))
            setattr(self, f"wk{i}", Linear(dim, kv_dim, **kw))
            setattr(self, f"wv{i}", Linear(dim, kv_dim, **kw))
            for r in ("rq", "rk"):
                setattr(self, f"{r}{i}", QuantRoPE(
                    self.head_dim, rope_base, scaling=rope_scaling, **kw))
            setattr(self, f"attn{i}", QuantMatmul(
                alpha=self.head_dim ** -0.5, transpose_b=True, **kw))
            setattr(self, f"smax{i}", QuantSoftmax(
                causal=True, window=self.sliding_window, **kw))
            setattr(self, f"av{i}", QuantMatmul(**kw))
            setattr(self, f"proj{i}", Linear(dim, dim, **kw))
            setattr(self, f"add1_{i}", QuantAdd(**kw))
            setattr(self, f"ln2_{i}", QuantRMSNorm(dim, eps, **kw))
            setattr(self, f"gate{i}", Linear(dim, self.mlp_hidden, **kw))
            setattr(self, f"silu{i}", QuantAct("silu", **kw))
            setattr(self, f"up{i}", Linear(dim, self.mlp_hidden, **kw))
            setattr(self, f"mul{i}", QuantMul(**kw))
            setattr(self, f"down{i}", Linear(self.mlp_hidden, dim, **kw))
            setattr(self, f"add2_{i}", QuantAdd(**kw))
        self.ln_f = QuantRMSNorm(dim, eps, **kw)
        self.head = Linear(dim, vocab_size, **kw)

    def tp_roles(self, model_size: int) -> dict:
        """Megatron plan for the llama block: attention head-local only
        when BOTH head counts divide the model axis (each shard then holds
        whole kv groups, so its query heads find their kv heads locally);
        SwiGLU column-parallel with a row-parallel down."""
        roles = {}
        head_local = (self.heads % model_size == 0
                      and self.kv_heads % model_size == 0)
        for i in range(1, self.depth + 1):
            if head_local:
                for w in ("wq", "wk", "wv"):
                    roles[f"{w}{i}"] = "col_local"
            roles[f"proj{i}"] = "row"
            roles[f"gate{i}"] = "col_local"
            roles[f"up{i}"] = "col_local"
            roles[f"down{i}"] = "row"
        return roles

    # -- block bodies (the only overrides of the decode machinery) -----------
    def _stem(self, ids: Tensor, start=None) -> Tensor:
        # no position table: positions enter through RoPE in each block
        return self.embed(ids)

    def _kv_scales(self, i):
        # the cache holds post-RoPE k codes: rk defines k's grid
        rk, wv = self._l("rk", i), self._l("wv", i)
        return (rk.scale, rk.zero_point), (wv.scale, wv.zero_point)

    def _attn_out(self, i, o):
        """The attention output before the residual add: the gemma family
        norms it (``postn1_{i}``); llama passes it on."""
        return o

    def _residual(self, i, x, o):
        """The block's tail after attention: sequential here (the MLP reads
        the post-attention residual ``x + o``); the neox family overrides it
        with the parallel form ``x + o + mlp(x)``."""
        return self._mlp(i, self._l("add1_", i)(x, o))

    def _mlp(self, i, x):
        h = self._l("ln2_", i)(x)
        gate, silu, up = self._l("gate", i), self._l("silu", i), \
            self._l("up", i)
        mul, down, add2 = self._l("mul", i), self._l("down", i), \
            self._l("add2_", i)
        if self.config.weight_bits == 4 and not self.config.weight_only:
            # W4A8: gate and up share h, one merged call
            merged = fused_w4a8_multi((gate, up), h)
            if merged is not None:
                return add2(x, down(mul(silu(merged[0]), merged[1])))
        if gate.is_quantized and self.config.fuse_linear_act:
            g = fused_linear_act(gate, silu, h)
        else:
            g = silu(gate(h))
        return add2(x, down(mul(g, up(h))))

    def _block(self, i, x, b, t, capture=None):
        h = self._l("ln1_", i)(x)
        q2, k2, v2 = self._qkv(i, h)
        qh = F.split_heads(q2.reshape(b, t, -1), self.heads)
        kh = F.split_heads(k2.reshape(b, t, -1), self.kv_heads)
        vh = F.split_heads(v2.reshape(b, t, -1), self.kv_heads)
        qh = self._l("rq", i)(qh)
        kh = self._l("rk", i)(kh)
        if capture is not None:
            # post-rotation k rows, on rk's grid
            capture[i] = (F.merge_heads(kh), v2.reshape(b, t, -1))
        grp = self.heads // self.kv_heads
        s = self._l("attn", i)(qh, F.repeat_kv(kh, grp))
        p = self._l("smax", i)(s)
        o = F.merge_heads(self._l("av", i)(p, F.repeat_kv(vh, grp)))
        o = self._l("proj", i)(o.reshape(b * t, o.shape[-1]))
        return self._residual(i, x, self._attn_out(i, o))

    def _block_decode(self, i, x, valid, pos, rows, at, k_cache, v_cache):
        b = x.shape[0]
        h = self._l("ln1_", i)(x)
        q2, k2, v2 = self._qkv(i, h)
        qh = F.split_heads(q2.reshape(b, 1, -1), self.heads)
        kh = F.split_heads(k2.reshape(b, 1, -1), self.kv_heads)
        qh = self._l("rq", i)(qh, start=pos)
        kh = self._l("rk", i)(kh, start=pos)
        self._append(k_cache, F.merge_heads(kh).data.reshape(b, -1), at,
                     rows)
        self._append(v_cache, v2.data, at, rows)
        if not qh.quantized:                     # the float cache
            o = F.merge_heads(self._float_attention(
                i, qh, k_cache, v_cache, self._float_valid(valid, 1)))
            o = self._l("proj", i)(o.reshape(b, -1))
            return self._residual(i, x, self._attn_out(i, o))
        (ks, kzp), (vs, vzp) = self._kv_scales(i)
        q_flat = F.merge_heads(qh).reshape(b, -1)
        o = fused_decode_attention(
            self._l("attn", i), self._l("smax", i), self._l("av", i), q_flat,
            Tensor(k_cache, ks, kzp), Tensor(v_cache, vs, vzp), valid,
            self.head_dim)
        o = self._l("proj", i)(o)
        return self._residual(i, x, self._attn_out(i, o))

    def _block_extend(self, i, x, b, m, valid, pos, k_cache, v_cache):
        """m-row cached block: RoPE at positions pos..pos+m-1 (per-row
        starts broadcast through ``QuantRoPE``), the post-rotation k codes
        appended, every query row of every head against the kv-compact
        cache in one ``fused_extend_attention`` call (the composed
        ``_float_attention`` over a float cache)."""
        h = self._l("ln1_", i)(x)
        q2, k2, v2 = self._qkv(i, h)
        qh = F.split_heads(q2.reshape(b, m, -1), self.heads)
        kh = F.split_heads(k2.reshape(b, m, -1), self.kv_heads)
        qh = self._l("rq", i)(qh, start=pos)
        kh = self._l("rk", i)(kh, start=pos)
        self._append_rows(k_cache, F.merge_heads(kh).data, pos)
        self._append_rows(v_cache, v2.data.reshape(b, m, -1), pos)
        if not qh.quantized:                     # the float cache
            o = F.merge_heads(self._float_attention(
                i, qh, k_cache, v_cache, self._float_valid(valid, m)))
            o = self._l("proj", i)(o.reshape(b * m, -1))
            return self._residual(i, x, self._attn_out(i, o))
        (ks, kzp), (vs, vzp) = self._kv_scales(i)
        o = fused_extend_attention(
            self._l("attn", i), self._l("smax", i), self._l("av", i),
            F.merge_heads(qh), Tensor(k_cache, ks, kzp),
            Tensor(v_cache, vs, vzp), valid, self.head_dim)
        o = self._l("proj", i)(o.reshape(b * m, -1))
        return self._residual(i, x, self._attn_out(i, o))


def torch_llama(vocab_size: int = 1000, max_len: int = 64, dim: int = 128,
                depth: int = 2, heads: int = 4, kv_heads: int | None = None,
                mlp_hidden: int | None = None, rope_base: float = 10000.0,
                eps: float = 1e-6, seed: int = 42,
                sliding_window: int | None = None):
    """Matching ``torch.nn`` oracle on the CPU (same attribute names, so
    its ``state_dict`` loads as-is; its bias-free Linears leave the port's
    zero biases untouched).  ``sliding_window`` adds the mistral band mask:
    position t attends to (t - W, t]."""
    import torch
    import torch.nn as nn
    import torch.nn.functional as tF

    torch.manual_seed(seed)
    kv = heads if kv_heads is None else kv_heads
    hd = dim // heads
    hidden = swiglu_hidden(dim) if mlp_hidden is None else mlp_hidden
    grp = heads // kv

    class RMSNorm(nn.Module):
        def __init__(self, d):
            super().__init__()
            self.weight = nn.Parameter(torch.ones(d))

        def forward(self, x):
            ms = x.pow(2).mean(-1, keepdim=True)
            return x * torch.rsqrt(ms + eps) * self.weight

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(vocab_size, dim)
            for i in range(1, depth + 1):
                setattr(self, f"ln1_{i}", RMSNorm(dim))
                setattr(self, f"wq{i}", nn.Linear(dim, dim, bias=False))
                setattr(self, f"wk{i}", nn.Linear(dim, kv * hd, bias=False))
                setattr(self, f"wv{i}", nn.Linear(dim, kv * hd, bias=False))
                setattr(self, f"proj{i}", nn.Linear(dim, dim, bias=False))
                setattr(self, f"ln2_{i}", RMSNorm(dim))
                setattr(self, f"gate{i}", nn.Linear(dim, hidden, bias=False))
                setattr(self, f"up{i}", nn.Linear(dim, hidden, bias=False))
                setattr(self, f"down{i}", nn.Linear(hidden, dim, bias=False))
            self.ln_f = RMSNorm(dim)
            self.head = nn.Linear(dim, vocab_size, bias=False)

        def forward(self, ids):
            b, t = ids.shape
            dev = ids.device
            x = self.embed(ids)
            mask = torch.triu(torch.full((t, t), float("-inf"), device=dev),
                              1)
            if sliding_window is not None:
                mask = mask + torch.tril(torch.full(
                    (t, t), float("-inf"), device=dev), -sliding_window)
            half = hd // 2
            inv = rope_base ** (-torch.arange(half, dtype=torch.float32,
                                              device=dev) * (2.0 / hd))
            ang = torch.arange(t, dtype=torch.float32, device=dev)[:, None] \
                * inv
            cos, sin = torch.cos(ang), torch.sin(ang)    # [T, D/2]

            def rot(z):                                   # [B, H, T, D]
                z1, z2 = z[..., :half], z[..., half:]
                return torch.cat([z1 * cos - z2 * sin,
                                  z2 * cos + z1 * sin], dim=-1)

            for i in range(1, depth + 1):
                h = getattr(self, f"ln1_{i}")(x)

                def heads_of(z, n):
                    return z.reshape(b, -1, n, hd).transpose(1, 2)
                qh = rot(heads_of(getattr(self, f"wq{i}")(h), heads))
                kh = rot(heads_of(getattr(self, f"wk{i}")(h), kv))
                vh = heads_of(getattr(self, f"wv{i}")(h), kv)
                kh = kh.repeat_interleave(grp, dim=1)
                vh = vh.repeat_interleave(grp, dim=1)
                s = (qh @ kh.transpose(-1, -2)) * hd ** -0.5 + mask
                p = tF.softmax(s, dim=-1)
                o = (p @ vh).transpose(1, 2).reshape(b, -1, dim)
                x = x + getattr(self, f"proj{i}")(o)
                h = getattr(self, f"ln2_{i}")(x)
                g = tF.silu(getattr(self, f"gate{i}")(h))
                x = x + getattr(self, f"down{i}")(
                    g * getattr(self, f"up{i}")(h))
            return self.head(self.ln_f(x))

    return Net()
