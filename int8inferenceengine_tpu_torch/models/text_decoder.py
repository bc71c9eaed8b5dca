"""TextDecoder: INT8 autoregressive (GPT-style) decoder with a u8 KV cache
(counterpart of ``int8inferenceengine_tpu.models.text_decoder``).

* **u8 KV cache, T-major flat layout**: after convert each layer's wk/wv
  Linear emits u8 codes at a fixed calibrated (scale, zp), so the cache is
  two u8 buffers [B, max_len, C] per layer in which position t's codes are
  one contiguous row.  A decode step appends one row (an in-place
  ``index_copy_`` at a position held on the device) and the decode
  attention kernel reads only the live rows.
* **exact masked attention over the static cache**: columns at or past the
  live length quantize to exactly the probability zero point and add
  exactly zero, so cached decode gives the same tokens as re-running the
  full causal forward at every step.

``generate()`` is greedy: the prefill fills the cache for the whole prompt
in one causal forward, then a Python loop runs the cached decode steps.  The
loop never waits for the card: the position and the tokens stay on the
device, and the tokens come to the host once, at the end.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, QuantConfig
from ..layers import (Linear, QuantAct, QuantAdd, QuantEmbed, QuantLayerNorm,
                      QuantMatmul, QuantPosEmbed, QuantSoftmax,
                      fused_decode_attention, fused_linear_act, fused_qkv)
from ..module import Module
from ..ops import functional as F
from ..tensor import Tensor

__all__ = ["TextDecoder", "torch_text_decoder"]


class TextDecoder(Module):
    """Causal transformer LM (gpt_tiny defaults: 128 dim / 2 blocks).

    Per block i: ``ln1_{i}`` -> ``wq{i}``/``wk{i}``/``wv{i}`` -> heads ->
    ``attn{i}`` (QK^T) -> ``smax{i}`` (causal) -> ``av{i}`` -> ``proj{i}``
    -> ``add1_{i}``; then ``ln2_{i}`` -> ``fc1_{i}`` -> ``gelu{i}`` ->
    ``fc2_{i}`` -> ``add2_{i}``.  Head: ``ln_f`` -> ``head`` over every
    position (LM logits [B, T, vocab]).  Input: token ids [B, T].
    """

    def __init__(self, vocab_size: int = 1000, max_len: int = 64,
                 dim: int = 128, depth: int = 2, heads: int = 2,
                 mlp_ratio: int = 4, mlp_hidden: int | None = None,
                 act: str = "gelu", config: QuantConfig = DEFAULT_CONFIG,
                 device=None):
        super().__init__(config, device)
        if dim % heads:
            raise ValueError(f"dim {dim} not divisible by heads {heads}")
        self.vocab_size, self.max_len = vocab_size, max_len
        self.dim, self.depth, self.heads = dim, depth, heads
        self.mlp_hidden = (mlp_ratio * dim if mlp_hidden is None
                           else int(mlp_hidden))
        self.act = str(act)
        self.kv_heads = heads
        self.head_dim = dim // heads
        self.INPUT_SHAPE = (max_len,)
        kw = dict(config=config, device=self.device)
        self.embed = QuantEmbed(vocab_size, dim, **kw)
        self.pe = QuantPosEmbed(max_len, dim, cls=False, **kw)
        for i in range(1, depth + 1):
            setattr(self, f"ln1_{i}", QuantLayerNorm(dim, **kw))
            for w in ("wq", "wk", "wv"):
                setattr(self, f"{w}{i}", Linear(dim, dim, **kw))
            setattr(self, f"attn{i}", QuantMatmul(
                alpha=(dim // heads) ** -0.5, transpose_b=True, **kw))
            setattr(self, f"smax{i}", QuantSoftmax(causal=True, **kw))
            setattr(self, f"av{i}", QuantMatmul(**kw))
            setattr(self, f"proj{i}", Linear(dim, dim, **kw))
            setattr(self, f"add1_{i}", QuantAdd(**kw))
            setattr(self, f"ln2_{i}", QuantLayerNorm(dim, **kw))
            setattr(self, f"fc1_{i}", Linear(dim, self.mlp_hidden, **kw))
            setattr(self, f"gelu{i}", QuantAct(act, **kw))
            setattr(self, f"fc2_{i}", Linear(self.mlp_hidden, dim, **kw))
            setattr(self, f"add2_{i}", QuantAdd(**kw))
        self.ln_f = QuantLayerNorm(dim, **kw)
        self.head = Linear(dim, vocab_size, **kw)

    def _l(self, name: str, i: int):
        return getattr(self, f"{name}{i}")

    # -- shared block body ---------------------------------------------------
    def _stem(self, ids: Tensor, start=None) -> Tensor:
        """Token embedding + learned positions -> [B, T, C]; ``start`` is
        the decode position (0-dim or [B] tensor), None for the prompt."""
        x = self.embed(ids)
        return self.pe(x) if start is None else self.pe(x, start=start)

    def _qkv(self, i, h):
        if self.config.fuse_qkv != "off":
            return fused_qkv(self._l("wq", i), self._l("wk", i),
                             self._l("wv", i), h)
        return self._l("wq", i)(h), self._l("wk", i)(h), self._l("wv", i)(h)

    def _block(self, i, x, b, t, capture=None):
        """One decoder block on the flat [b*t, C] view (causal softmax);
        ``capture`` collects this block's k/v rows for the KV cache."""
        h = self._l("ln1_", i)(x)
        q2, k2, v2 = self._qkv(i, h)
        qh = F.split_heads(q2.reshape(b, t, -1), self.heads)
        kh = F.split_heads(k2.reshape(b, t, -1), self.heads)
        vh = F.split_heads(v2.reshape(b, t, -1), self.heads)
        if capture is not None:
            capture[i] = (k2.reshape(b, t, -1), v2.reshape(b, t, -1))
        s = self._l("attn", i)(qh, kh)
        p = self._l("smax", i)(s)
        o = F.merge_heads(self._l("av", i)(p, vh))
        o = self._l("proj", i)(o.reshape(b * t, o.shape[-1]))
        return self._mlp(i, self._l("add1_", i)(x, o))

    def _mlp(self, i, x):
        """ln2 -> fc1/gelu (fused when converted) -> fc2 -> add2."""
        h = self._l("ln2_", i)(x)
        fc1, gelu = self._l("fc1_", i), self._l("gelu", i)
        if fc1.is_quantized and self.config.fuse_linear_act:
            h = fused_linear_act(fc1, gelu, h)
        else:
            h = gelu(fc1(h))
        h = self._l("fc2_", i)(h)
        return self._l("add2_", i)(x, h)

    def forward(self, ids):
        x = self._stem(ids)                      # [B, T, C]
        b, t, c = x.shape
        x = x.reshape(b * t, c)
        for i in range(1, self.depth + 1):
            x = self._block(i, x, b, t)
        x = self.ln_f(x)
        return self.head(x).reshape(b, t, self.vocab_size)

    # -- KV-cache decoding ----------------------------------------------------
    def _kv_scales(self, i):
        wk, wv = self._l("wk", i), self._l("wv", i)
        return (wk.scale, wk.zero_point), (wv.scale, wv.zero_point)

    def _prefill(self, ids: Tensor):
        """Full causal forward over the prompt ids [B, T0]; returns (the last
        position's u8 logit codes [B, V], cache) with each layer's k/v codes
        in rows [0, T0) of full-length buffers [B, max_len, C]."""
        if getattr(self, "ring_cache", False):
            raise NotImplementedError(
                "ring KV caches (sliding-window layers) are not implemented "
                "by the PyTorch port yet")
        b, t0 = ids.data.shape
        x = self._stem(ids).reshape(b * t0, self.dim)
        cache = {}
        for i in range(1, self.depth + 1):
            cap = {}
            x = self._block(i, x, b, t0, capture=cap)
            kf, vf = cap[i]                      # flat [B, T0, C] rows
            if not kf.quantized:
                raise RuntimeError("the KV cache holds u8 codes: convert() "
                                   "the model first")
            bufs = []
            for rows in (kf.data, vf.data):
                buf = torch.zeros((b, self.max_len, rows.shape[-1]),
                                  dtype=torch.uint8, device=rows.device)
                buf[:, :t0] = rows
                bufs.append(buf)
            cache[i] = tuple(bufs)
        x = self.ln_f(x)
        # u8 logit codes: argmax over codes == argmax over the dequantized
        # logits (one positive scale), so greedy decoding never dequantizes
        codes = self.head(x).data.reshape(b, t0, self.vocab_size)
        return codes[:, -1, :], cache

    def _decode_step(self, cache, pos, tok):
        """One cached decode step: tokens ``tok`` [B] at position ``pos``
        (an int, a 0-dim tensor, or a [B] tensor of per-row positions).
        Appends each layer's k/v row to ``cache`` in place and returns (u8
        logit codes [B, V], cache)."""
        b = tok.shape[0]
        dev = self.device
        pos = (pos if isinstance(pos, torch.Tensor) else torch.tensor(pos))
        pos = pos.to(device=dev, dtype=torch.int64)
        valid = (pos + 1).to(torch.int32)
        x = self._stem(Tensor(tok.reshape(b, 1)), start=pos)
        x = x.reshape(b, self.dim)
        rows = torch.arange(b, device=dev) if pos.dim() == 1 else None
        for i in range(1, self.depth + 1):
            x = self._block_decode(i, x, valid, pos, rows, *cache[i])
        x = self.ln_f(x)
        return self.head(x).data, cache

    @staticmethod
    def _append(buf, new, pos, rows):
        """Write the [B, C] codes ``new`` into row ``pos`` of ``buf``."""
        if rows is None:
            buf.index_copy_(1, pos.reshape(1), new.unsqueeze(1))
        else:
            buf[rows, pos] = new

    def _block_decode(self, i, x, valid, pos, rows, k_cache, v_cache):
        h = self._l("ln1_", i)(x)
        q2, k2, v2 = self._qkv(i, h)
        self._append(k_cache, k2.data, pos, rows)
        self._append(v_cache, v2.data, pos, rows)
        (ks, kzp), (vs, vzp) = self._kv_scales(i)
        o = fused_decode_attention(
            self._l("attn", i), self._l("smax", i), self._l("av", i), q2,
            Tensor(k_cache, ks, kzp), Tensor(v_cache, vs, vzp), valid,
            self.head_dim)
        o = self._l("proj", i)(o)
        return self._mlp(i, self._l("add1_", i)(x, o))

    def generate(self, ids, steps: int, temperature: float = 0.0,
                 top_k: int | None = None, top_p: float | None = None,
                 seed: int = 0) -> np.ndarray:
        """Greedily decode ``steps`` tokens after the prompt ``ids`` [B, T0];
        returns int32 [B, steps] on the host.  INT8 only (call after
        ``convert()``).  Sampling (temperature > 0, top_k, top_p) is not
        ported yet."""
        if temperature != 0 or top_k is not None or top_p is not None:
            raise NotImplementedError(
                "sampling (temperature > 0, top_k, top_p) is not implemented "
                "by the PyTorch port yet; temperature=0 is greedy")
        if not self.is_quant:
            raise RuntimeError("generate() requires a converted model")
        if self.config.weight_only:
            raise NotImplementedError(
                "weight-only generate() needs the float KV cache (head-split "
                "[B, Hkv, T, D] float rows), which the PyTorch port does not "
                "implement yet; the weight-only forward model(ids) runs")
        ids = np.asarray(ids)
        b, t0 = ids.shape
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        if t0 + steps > self.max_len:
            raise ValueError(f"prompt {t0} + steps {steps} exceeds max_len "
                             f"{self.max_len}")
        dev = self.device
        with torch.no_grad():
            prompt = torch.tensor(ids.astype(np.int64), device=dev)
            codes, cache = self._prefill(Tensor(prompt))
            tok = codes.argmax(-1)
            out = torch.empty((b, steps), dtype=torch.int64, device=dev)
            out[:, 0] = tok
            pos = torch.full((), t0, dtype=torch.int64, device=dev)
            for s in range(1, steps):
                codes, cache = self._decode_step(cache, pos, tok)
                tok = codes.argmax(-1)
                out[:, s] = tok
                pos = pos + 1
        return out.cpu().numpy().astype(np.int32)

    def generate_speculative(self, draft, ids, steps: int, k: int = 4):
        raise NotImplementedError(
            "speculative decoding is not implemented by the PyTorch port yet")

    def _extend_step(self, cache, pos, toks):
        raise NotImplementedError(
            "multi-token cached extends are not implemented by the PyTorch "
            "port yet")


def torch_text_decoder(vocab_size: int = 1000, max_len: int = 64,
                       dim: int = 128, depth: int = 2, heads: int = 2,
                       mlp_ratio: int = 4, seed: int = 42,
                       act: str = "gelu"):
    """Matching ``torch.nn`` oracle (same attribute names, so its
    ``state_dict`` loads as-is), on the CPU; ``act='relu'`` is the OPT-family
    MLP."""
    import torch.nn as nn
    import torch.nn.functional as tF

    torch.manual_seed(seed)
    hd = dim // heads

    class PE(nn.Module):
        def __init__(self):
            super().__init__()
            self.weight = nn.Parameter(torch.randn(max_len, dim) * 0.02)

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
            self.head = nn.Linear(dim, vocab_size)

        def forward(self, ids):
            b, t = ids.shape
            x = self.embed(ids) + self.pe.weight[:t]
            mask = torch.triu(torch.full((t, t), float("-inf"),
                                         device=ids.device), 1)
            for i in range(1, depth + 1):
                h = getattr(self, f"ln1_{i}")(x)

                def heads_of(z):
                    return z.reshape(b, -1, heads, hd).transpose(1, 2)
                q = heads_of(getattr(self, f"wq{i}")(h))
                k = heads_of(getattr(self, f"wk{i}")(h))
                v = heads_of(getattr(self, f"wv{i}")(h))
                s = (q @ k.transpose(-1, -2)) * hd ** -0.5 + mask
                p = tF.softmax(s, dim=-1)
                o = (p @ v).transpose(1, 2).reshape(b, -1, dim)
                x = x + getattr(self, f"proj{i}")(o)
                h = getattr(self, f"ln2_{i}")(x)
                h = getattr(self, f"fc2_{i}")(
                    (tF.relu if act == "relu" else tF.gelu)(
                        getattr(self, f"fc1_{i}")(h)))
                x = x + h
            return self.head(self.ln_f(x))

    return Net()
