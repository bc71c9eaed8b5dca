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

``generate()`` fills the cache for the whole prompt in one causal forward,
then runs the cached decode steps.  On the CPU they are a Python loop; on
the card the first step runs eagerly and the rest replay it as a captured
CUDA graph (``graphs.run_steps``), the port's counterpart of the JAX
package's one jitted ``lax.scan``.  The position, the step's column and
the tokens stay on the device, and the tokens come to the host once, at
the end.

Sampling works on the u8 logit codes (``code_histogram``,
``nucleus_code_floor``, ``topk_code_floor``, ``pick_u8``): top-k and top-p
are code thresholds found from one 256-bin histogram per row, and the draw
is a Gumbel-max over a counter-based hash (``uniform_hash``), so every
step is free of host syncs and can be captured.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import graphs
from ..config import DEFAULT_CONFIG, QuantConfig
from ..layers import (Linear, QuantAct, QuantAdd, QuantEmbed, QuantLayerNorm,
                      QuantMatmul, QuantPosEmbed, QuantSoftmax,
                      fused_decode_attention, fused_linear_act, fused_qkv)
from ..module import Module
from ..ops import functional as F
from ..ops.quant import f32
from ..tensor import Tensor

__all__ = ["TextDecoder", "torch_text_decoder", "code_histogram",
           "nucleus_code_floor", "topk_code_floor", "uniform_hash",
           "fold_seed", "row_seeds", "pick_u8"]


# -- sampling on the u8 logit grid -----------------------------------------

def code_histogram(codes: torch.Tensor, weight=None) -> torch.Tensor:
    """Per-row 256-bin count histogram of u8 codes [B, V] -> float32
    [B, 256] (exact for V < 2^24), one ``scatter_add_`` (``bincount``
    would sync with the host).  ``weight`` (float32 [B, V]) counts each
    token with its weight instead of 1."""
    if weight is None:
        weight = torch.ones(codes.shape, dtype=torch.float32,
                            device=codes.device)
    hist = torch.zeros((codes.shape[0], 256), dtype=torch.float32,
                       device=codes.device)
    return hist.scatter_add_(1, codes.to(torch.int64), weight)


def _revcum256(w: torch.Tensor) -> torch.Tensor:
    """``cumsum(w[:, ::-1])[:, ::-1]`` over 256 float32 classes, added in
    the JAX package's order: XLA:CPU computes a 256-long cumsum in blocks
    of 16, each summed left to right, plus the left-to-right exclusive sum
    of the block totals.  ``torch.cumsum`` adds in float64 on the CPU and
    in another order on the card, which moves the nucleus floor on a
    boundary."""
    blk = torch.flip(w, [-1]).reshape(w.shape[0], 16, 16).clone()
    for j in range(1, 16):
        blk[:, :, j] = blk[:, :, j - 1] + blk[:, :, j]
    tot = blk[:, :, 15]
    ex = torch.zeros_like(tot)
    for j in range(1, 16):
        ex[:, j] = ex[:, j - 1] + tot[:, j - 1]
    return torch.flip((blk + ex[:, :, None]).reshape(w.shape), [-1])


def _floor_of(ok: torch.Tensor) -> torch.Tensor:
    """The largest class v with ``ok[:, v]`` (0 where none) as u8 [B]."""
    v = torch.arange(256, dtype=torch.int64, device=ok.device)
    return torch.where(ok, v, torch.zeros_like(v)).amax(-1).to(torch.uint8)


def nucleus_code_floor(codes, s_over_t, p, keep=None, hist=None):
    """Smallest u8 logit code inside the nucleus (top-p) set, per row.

    ``codes`` [B, V] u8, ``s_over_t`` float32 [B] (head scale /
    temperature), ``p`` float32 [B] in (0, 1]; returns u8 [B]: keep tokens
    with ``code >= floor``.  On the 8-bit grid every token of a code class
    has the same probability, so the nucleus is a code threshold: class v
    weighs ``n_v * exp((v - 255) * s/T)`` (float32, as the JAX package
    computes it), and the floor is the largest v whose suffix mass still
    reaches ``p`` of the total.  ``keep`` (bool [B, V]) measures the mass
    over the kept tokens only (top-k then top-p, HF's order); ``hist`` is
    a precomputed (possibly class-masked) count histogram."""
    if hist is None:
        hist = code_histogram(
            codes, None if keep is None else keep.to(torch.float32))
    dev = hist.device
    v = torch.arange(256, dtype=torch.float32, device=dev)
    w = hist * torch.exp((v[None, :] - f32(255.0, dev)) * s_over_t[:, None])
    revcum = _revcum256(w)
    return _floor_of(revcum >= p[:, None] * revcum[:, :1])


def topk_code_floor(codes, k, hist=None):
    """Smallest u8 logit code inside the top-k set, per row: ``k`` [B]
    integer; keep tokens with ``code >= floor``.  The k-th largest value
    on the 8-bit grid is a code class, the largest v whose suffix count
    reaches k, so ties at the k-th value keep the whole class (the static
    ``top_k`` threshold's semantics) and k may differ per row.  k >= V
    keeps every token; k <= 0 is the callers' "off" and must be gated."""
    if hist is None:
        hist = code_histogram(codes)
    return _floor_of(_revcum256(hist) >= k[:, None].to(torch.float32))


_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit avalanche of int64 tensors holding 32-bit values (the
    murmur3 finalizer's shifts, multipliers below 2^31 so that every
    product fits in int64): the same bits on the CPU and the card."""
    x = x & _M32
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _M32
    x = ((x ^ (x >> 15)) * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def uniform_hash(seeds: torch.Tensor, pos: torch.Tensor, vocab: int
                 ) -> torch.Tensor:
    """float32 [B, vocab] uniforms in [1e-7, 1), a counter-based hash of
    (seed, position, vocabulary index): stateless, identical on the CPU and
    the card, and free of host syncs, so a captured graph replays a fresh
    draw at every position.  The 23 high bits of each hash fill a float
    mantissa in [1, 2), mapped as the JAX package's ``uniform(minval=1e-7,
    maxval=1)`` maps its bits.  The stream differs from JAX's threefry
    stream by construction."""
    dev = seeds.device
    key = _mix32(_mix32(seeds.to(torch.int64)) ^ (pos.to(torch.int64) & _M32))
    col = torch.arange(vocab, dtype=torch.int64, device=dev) * 0x9E3779B1
    bits = _mix32(key[:, None] + col[None, :])
    one = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo, hi = f32(1e-7, dev), f32(1.0, dev)
    return torch.maximum(lo, (one - hi) * (hi - lo) + lo)


def fold_seed(seed: int) -> int:
    """A seed folded to the 32 bits the draw hashes."""
    return (int(seed) & _M32) ^ ((int(seed) >> 32) & _M32)


def row_seeds(seed: int, rows: int, device) -> torch.Tensor:
    """int64 [rows] stream keys of ``generate(seed=)``'s rows: row 0 keys
    with ``seed`` itself (as a serving request with that seed does), row r
    with ``seed`` xor a hash of r."""
    s = fold_seed(seed)
    r = torch.arange(rows, dtype=torch.int64)
    mixed = torch.where(r == 0, torch.zeros_like(r), _mix32(r))
    return (s ^ mixed).to(device)


def pick_u8(codes, scale, zp, temps, seeds, pos, topps=None, topks=None):
    """Per-row next token from u8 logit codes [B, V] (the composition of
    the JAX package's ``GenerationEngine._pick``): greedy argmax on the
    codes where ``temps`` <= 0, else a Gumbel-max draw of
    ``logits / temperature`` with logits ``(code - zp) * scale``.
    ``topks`` (int [B], 0 = off) keeps the codes at or above the top-k
    floor; ``topps`` (float32 [B], 1 = off) keeps the nucleus, measured
    over the top-k-kept classes (one histogram serves both).  ``seeds``
    and ``pos`` [B] key the draw (``uniform_hash``).  None for
    ``topps``/``topks`` leaves that filter's work out.  Returns int64
    [B]."""
    dev = codes.device
    greedy = codes.argmax(-1)
    logits = (codes.to(torch.float32) - f32(zp, dev)) * f32(scale, dev)
    ninf = f32(float("-inf"), dev)
    keepk = hist = fl = None
    if topks is not None:
        hist = code_histogram(codes)
        fl = topk_code_floor(codes, topks, hist=hist)
        keepk = (codes >= fl[:, None]) | (topks <= 0)[:, None]
        logits = torch.where(keepk, logits, ninf)
    t_safe = torch.maximum(temps, f32(1e-6, dev))
    if topps is not None:
        hm = None
        if hist is not None:
            vcls = torch.arange(256, dtype=torch.uint8, device=dev)
            hm = torch.where((topks > 0)[:, None],
                             hist * (vcls[None, :] >= fl[:, None]), hist)
        floor = nucleus_code_floor(codes, f32(scale, dev) / t_safe, topps,
                                   hist=hm)
        keep = codes >= floor[:, None]
        if keepk is not None:
            keep = keep & keepk
        keep = keep | (topps >= f32(1.0, dev))[:, None]
        logits = torch.where(keep, logits, ninf)
    u = uniform_hash(seeds, pos, codes.shape[-1])
    sampled = (logits / t_safe[:, None] - torch.log(-torch.log(u))).argmax(-1)
    return torch.where(temps > 0, sampled, greedy)


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

    def _prefill(self, ids: Tensor, last=None):
        """Full causal forward over the prompt ids [B, T0]; returns (u8
        logit codes [B, V], cache) with each layer's k/v codes in rows [0,
        T0) of full-length buffers [B, max_len, C].  The codes are the last
        position's, or with ``last`` (int64 [B], the true lengths of
        right-padded prompts) row ``last - 1``'s of each prompt: the causal
        mask keeps the padding out of every earlier row."""
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
        if last is None:
            return codes[:, -1, :], cache
        idx = (last.to(device=codes.device, dtype=torch.int64) - 1)
        return codes.gather(1, idx.reshape(b, 1, 1).expand(
            b, 1, self.vocab_size))[:, 0, :], cache

    def _decode_step(self, cache, pos, tok):
        """One cached decode step: tokens ``tok`` [B] at position ``pos``
        (an int, a 0-dim tensor, or a [B] tensor of per-row positions).
        Appends each layer's k/v row to ``cache`` in place and returns (u8
        logit codes [B, V], cache).

        A position at or past ``max_len`` is clamped to the last row, as
        the JAX package's ``dynamic_update_slice``/``dynamic_slice`` clamp
        it, so the live length seen by attention is at most the cache's T:
        a serving slot that has finished keeps decoding until the host
        drops its tokens, and its writes stay inside its own last row."""
        b = tok.shape[0]
        dev = self.device
        pos = (pos if isinstance(pos, torch.Tensor) else torch.tensor(pos))
        pos = pos.to(device=dev, dtype=torch.int64).clamp(
            max=self.max_len - 1)
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

    def _head_scale_zp(self):
        """The head's output grid (scale, zp): the u8 logit codes'."""
        return float(self.head.scale), int(self.head.zero_point)

    def _pick(self, codes, temps, seeds, pos, topps=None, topks=None):
        """Per-row next token from the u8 logit codes (``pick_u8`` on the
        head's grid)."""
        scale, zp = self._head_scale_zp()
        return pick_u8(codes, scale, zp, temps, seeds, pos, topps, topks)

    def generate(self, ids, steps: int, temperature: float = 0.0,
                 top_k: int | None = None, top_p: float | None = None,
                 seed: int = 0) -> np.ndarray:
        """Decode ``steps`` tokens after the prompt ``ids`` [B, T0]; returns
        int32 [B, steps] on the host.  INT8 only (call after
        ``convert()``).  ``temperature`` 0 is greedy; above 0 each token is
        drawn from softmax(logits / temperature), optionally over the
        top_k codes and then the top_p nucleus (HF's order), with the
        draw keyed by (seed, row, position) (``row_seeds``,
        ``uniform_hash``): the port's stream, not the JAX package's.

        On the card the first decode step runs eagerly and the others
        replay it as a CUDA graph (``graphs.run_steps``); on the CPU they
        run as a loop.  Both give the same tokens."""
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
        if top_p is not None and not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        dev = self.device
        with torch.no_grad():
            prompt = torch.tensor(ids.astype(np.int64), device=dev)
            codes, cache = self._prefill(Tensor(prompt))
            pos = torch.full((), t0 - 1, dtype=torch.int64, device=dev)
            if temperature == 0:
                pick = None
            else:
                temps = f32(temperature, dev).expand(b).contiguous()
                seeds = row_seeds(seed, b, dev)
                topps = (None if top_p is None or top_p >= 1.0 else
                         f32(top_p, dev).expand(b).contiguous())
                topks = (None if top_k is None else torch.full(
                    (b,), int(top_k), dtype=torch.int64, device=dev))

                def pick(codes, pos):
                    return self._pick(codes, temps, seeds, pos.expand(b),
                                      topps, topks)
            tok = codes.argmax(-1) if pick is None else pick(codes, pos)
            out = torch.empty((b, steps), dtype=torch.int64, device=dev)
            out[:, 0] = tok
            pos += 1
            col = torch.ones((1,), dtype=torch.int64, device=dev)

            def step():
                codes, _ = self._decode_step(cache, pos, tok)
                nxt = codes.argmax(-1) if pick is None else pick(codes, pos)
                out.index_copy_(1, col, nxt[:, None])
                tok.copy_(nxt)
                pos.add_(1)
                col.add_(1)

            program = graphs.run_steps(step, steps - 1, dev)
            toks = out.cpu().numpy().astype(np.int32)
        del program
        return toks

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
