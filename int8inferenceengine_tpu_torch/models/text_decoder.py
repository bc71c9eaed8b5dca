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

* **ring cache of windowed layers** (``ring_cache=True`` on the llama and
  gemma families): a layer with a sliding window W holds R =
  roundup32(2W) rows instead of ``max_len``.  Row r holds position base +
  r, with base a closed form of the position (``_ring_base``) that moves by
  S = R - W whenever the rows fill.  The JAX package then compacts, one
  W-row block copy to row 0, at the step where base moves; a captured CUDA
  graph cannot branch on the position, so here every step writes its k/v
  row twice instead: at ``pos - base`` and, once that row reaches S, also
  at ``pos - base - S``, a row that the window no longer reads.  When
  base moves, rows [0, W) already hold the window, so no step copies a
  block, and the per-slot positions of the serving engine cost the same
  single extra row.  Attention reads rows [0, pos - base] with the window
  masked relative to them, so the codes equal the full-length cache's.

``generate()`` fills the cache for the whole prompt in one causal forward,
then runs the cached decode steps.  On the CPU they are a Python loop; on
the card the first step runs eagerly and the rest replay it as a captured
CUDA graph (``graphs.run_steps``), the port's counterpart of the JAX
package's one jitted ``lax.scan``.  The position, the step's column and
the tokens stay on the device, and the tokens come to the host once, at
the end.

``_extend_step`` runs m tokens at once against the cache (row j of the
extend sees the cache up to its own position): the verify pass of
``generate_speculative`` and the serving engine's chunked prefill.

* **float KV cache** (``QuantConfig(weight_only=True)``: W8-float,
  ``dynamic_act``, W4): the k/v rows are float32, so each layer's cache is
  two **head-split** float buffers [B, Hkv, T, D], the layout the composed
  attention reads (``_float_attention``).  A prompt's rows and a step's row
  land where the u8 path writes its codes, in the same position order, a
  ring layer's twice; attention reads every one of the T rows with
  columns past the live length masked to -inf, as the JAX package does.
  Grouped-query heads read their kv head through a grouped view (the
  group folded into the query rows); the cache is never repeated.  The
  logits are float, picked by ``pick_float``.

Sampling works on the u8 logit codes (``code_histogram``,
``nucleus_code_floor``, ``topk_code_floor``, ``pick_u8``): top-k and top-p
are code thresholds found from one 256-bin histogram per row, and the draw
is a Gumbel-max over a counter-based hash (``uniform_hash``), so every
step is free of host syncs and can be captured.  On float logits top-k is
a threshold at the k-th largest value of a sort and top-p
``nucleus_float_cutoff``, with the same draw.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import graphs
from ..config import DEFAULT_CONFIG, QuantConfig
from ..layers import (Layer, Linear, QuantAct, QuantAdd, QuantEmbed,
                      QuantLayerNorm, QuantMatmul, QuantPosEmbed, QuantSoftmax,
                      fused_decode_attention, fused_extend_attention,
                      fused_linear_act, fused_qkv)
from ..module import Module
from ..ops import functional as F
from ..ops.quant import f32
from ..tensor import Tensor

__all__ = ["TextDecoder", "torch_text_decoder", "code_histogram",
           "nucleus_code_floor", "topk_code_floor", "uniform_hash",
           "fold_seed", "row_seeds", "pick_u8", "nucleus_float_cutoff",
           "pick_float"]


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
    return _draw(logits, temps, t_safe, seeds, pos, greedy)


def _draw(logits, temps, t_safe, seeds, pos, greedy):
    """Gumbel-max over ``logits / t`` keyed by (seed, position) where
    ``temps`` > 0, else ``greedy``."""
    u = uniform_hash(seeds, pos, logits.shape[-1])
    sampled = (logits / t_safe[:, None] - torch.log(-torch.log(u))).argmax(-1)
    return torch.where(temps > 0, sampled, greedy)


def nucleus_float_cutoff(logits_t: torch.Tensor, p: torch.Tensor
                         ) -> torch.Tensor:
    """Per-row smallest kept logit of nucleus (top-p) sampling on FLOAT
    logits (the weight-only path has no code grid): sort descending,
    softmax, keep the shortest prefix whose mass reaches ``p`` (a position
    stays iff the mass strictly before it is below p, so ties at the
    cutoff all stay).  ``logits_t`` [B, V] already divided by the
    temperature, ``p`` float32 [B]; returns [B, 1]."""
    srt = torch.sort(logits_t, dim=-1, descending=True).values
    probs = torch.softmax(srt, dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs
    inf = f32(float("inf"), logits_t.device)
    return torch.where(before < p[:, None], srt, inf).amin(-1, keepdim=True)


def pick_float(logits, temps, seeds, pos, topps=None, topks=None):
    """``pick_u8`` on float logits [B, V] (the weight-only modes): greedy
    argmax where ``temps`` <= 0, else the same Gumbel-max draw of ``logits
    / temperature``.  ``topks`` (int [B], 0 = off) keeps the logits at or
    above each row's k-th largest (ties kept, a threshold as on the u8
    grid); ``topps`` (float32 [B], 1 = off) then keeps the nucleus of the
    top-k-kept logits (``nucleus_float_cutoff``, HF's order).  Returns
    int64 [B]."""
    dev = logits.device
    greedy = logits.argmax(-1)
    logits = logits.to(torch.float32)
    ninf = f32(float("-inf"), dev)
    if topks is not None:
        srt = torch.sort(logits, dim=-1, descending=True).values
        idx = (topks - 1).clamp(0, logits.shape[-1] - 1)
        kth = srt.gather(1, idx[:, None].to(torch.int64))
        keepk = (logits >= kth) | (topks <= 0)[:, None]
        logits = torch.where(keepk, logits, ninf)
    t_safe = torch.maximum(temps, f32(1e-6, dev))
    if topps is not None:
        lt = logits / t_safe[:, None]
        keep = (lt >= nucleus_float_cutoff(lt, topps)) \
            | (topps >= f32(1.0, dev))[:, None]
        logits = torch.where(keep, logits, ninf)
    return _draw(logits, temps, t_safe, seeds, pos, greedy)


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

    def tp_roles(self, model_size: int) -> dict:
        """Megatron-style transformer TP plan: QKV column-parallel with
        head-local attention (outputs stay sharded) when heads divide the
        model axis, attention out-proj and fc2 row-parallel (s32 partials
        summed), fc1 column-parallel feeding the sharded MLP interior.
        Two collectives per block instead of a gather after every
        Linear."""
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

    def _logits(self, x: Tensor) -> torch.Tensor:
        """The head's codes (floats under weight_only) with every vocabulary
        column: in overlap mode a sharded head's output is gathered."""
        return Layer._gathered(self.head(x)).data

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

    # -- ring KV cache (sliding-window layers) -------------------------------
    def _layer_window(self, i):
        """Layer i's sliding window (None: global attention)."""
        return self._l("smax", i).window

    def _cache_rows(self, i) -> int:
        """Allocated KV-cache rows of layer i: R = min(max_len,
        roundup32(2W)) for a windowed layer of a ``ring_cache`` model,
        ``max_len`` otherwise.  A cache with fewer rows than ``max_len`` is
        a ring (see the module docstring)."""
        w = self._layer_window(i)
        if w is None or not getattr(self, "ring_cache", False):
            return self.max_len
        return min(self.max_len, -(-2 * int(w) // 32) * 32)

    @staticmethod
    def _ring_base(pos: torch.Tensor, rows: int, window: int) -> torch.Tensor:
        """The absolute position of ring row 0 while position ``pos`` (an
        int64 tensor) decodes: S * max(0, 1 + floor((pos - R) / S)) with S =
        R - W, so pos - base stays in [W, R) once pos reaches R.  The
        division rounds toward minus infinity, as ``jnp``'s does."""
        s = rows - window
        return s * torch.clamp(
            1 + torch.div(pos - rows, s, rounding_mode="floor"), min=0)

    def _ring_tail(self, rows: torch.Tensor, i: int, t: int, last):
        """A windowed layer's ring [B, R, C] after a prompt whose k/v rows
        are ``rows`` [B, T0, C] and whose true lengths are ``last`` (int64
        [B]): row r holds position base + r + S where that position is
        below the length, else base + r, and zeros at or past the length;
        base is the ring base of the prompt's last position.  These are the
        rows that one-at-a-time decode steps (two writes each) leave."""
        w = self._layer_window(i)
        s = t - w
        b, t0, _ = rows.shape
        base = self._ring_base(last - 1, t, w)                      # [B]
        r = torch.arange(t, device=rows.device, dtype=torch.int64)
        src = base[:, None] + r[None, :]
        src = torch.where(src + s < last[:, None], src + s, src)
        live = src < last[:, None]
        src = torch.where(live, src, torch.zeros_like(src))
        out = rows.gather(1, src[:, :, None].expand(b, t, rows.shape[-1]))
        return out * live[:, :, None].to(out.dtype)

    def _prefill(self, ids: Tensor, last=None, full_cache: bool = False):
        """Full causal forward over the prompt ids [B, T0]; returns (logit
        codes [B, V], cache) with each layer's k/v codes in rows [0, T0)
        of full-length buffers [B, max_len, C], or a windowed ring layer's
        in the rows that ``_ring_tail`` gives.  A weight-only model's
        logits and rows are float, its buffers head-split [B, Hkv, T, D]
        (``_float_rows``).  The codes are the last position's, or with
        ``last`` (int64 [B], the true lengths of right-padded prompts) row
        ``last - 1``'s of each prompt: the causal mask keeps the padding
        out of every earlier row.  ``full_cache`` gives every layer
        ``max_len`` rows, rings included (a weight-only engine's slot
        caches)."""
        b, t0 = ids.data.shape
        x = self._stem(ids).reshape(b * t0, self.dim)
        lens = (torch.full((b,), t0, dtype=torch.int64, device=self.device)
                if last is None else
                last.to(device=self.device, dtype=torch.int64))
        cache = {}
        for i in range(1, self.depth + 1):
            cap = {}
            x = self._block(i, x, b, t0, capture=cap)
            kf, vf = cap[i]                      # flat [B, T0, C] rows
            if not (kf.quantized or self.config.weight_only):
                raise RuntimeError("the KV cache holds u8 codes: convert() "
                                   "the model first")
            t = self.max_len if full_cache else self._cache_rows(i)
            if not kf.quantized:
                if t < self.max_len and last is not None and t0 > t:
                    raise NotImplementedError(
                        "ring-cache serving prefill (right-padded prompts "
                        "beyond the ring rows) is u8-path only; weight_only "
                        "engines allocate full-length caches")
                cache[i] = tuple(self._float_rows(rows, i, t, lens)
                                 for rows in (kf.data, vf.data))
                continue
            bufs = []
            for rows in (kf.data, vf.data):
                if t < self.max_len:
                    bufs.append(self._ring_tail(rows, i, t, lens))
                    continue
                buf = torch.zeros((b, t, rows.shape[-1]),
                                  dtype=torch.uint8, device=rows.device)
                buf[:, :t0] = rows
                bufs.append(buf)
            cache[i] = tuple(bufs)
        x = self.ln_f(x)
        # u8 logit codes: argmax over codes == argmax over the dequantized
        # logits (one positive scale), so greedy decoding never dequantizes
        # (float logits under weight_only)
        codes = self._logits(x).reshape(b, t0, self.vocab_size)
        if last is None:
            return codes[:, -1, :], cache
        return codes.gather(1, (lens - 1).reshape(b, 1, 1).expand(
            b, 1, self.vocab_size))[:, 0, :], cache

    def _float_rows(self, rows: torch.Tensor, i: int, t: int, lens):
        """A layer's head-split float cache [B, Hkv, t, D] after a prompt
        whose flat k or v rows are ``rows`` [B, T0, Hkv*D] (true lengths
        ``lens``): rows [0, T0) of a full-length cache, or a ring layer's
        ``_ring_tail``; zeros elsewhere."""
        b, t0, c = rows.shape
        if t < self.max_len:
            return self._head_split(self._ring_tail(rows, i, t, lens))
        # c // head_dim: this rank's kv heads under head-parallel TP
        buf = torch.zeros((b, c // self.head_dim, t, self.head_dim),
                          dtype=rows.dtype, device=rows.device)
        buf[:, :, :t0] = self._head_split(rows)
        return buf

    def _head_split(self, rows: torch.Tensor) -> torch.Tensor:
        """Flat [B, T, Hkv*D] rows -> contiguous [B, Hkv, T, D]."""
        b, t, _ = rows.shape
        return rows.reshape(b, t, -1, self.head_dim).transpose(
            1, 2).contiguous()

    @staticmethod
    def _rows_of(buf: torch.Tensor) -> int:
        """A cache buffer's rows: [B, T, C] u8 or [B, Hkv, T, D] float."""
        return buf.shape[2] if buf.dim() == 4 else buf.shape[1]

    def _float_attention(self, i, qh: Tensor, k_cache, v_cache,
                         valid) -> Tensor:
        """The composed attention of layer i over its head-split float
        cache: ``av(smax(attn(q, k), valid_len=valid), v)`` for the query
        heads ``qh`` [B, H, m, D] against [B, Hkv, T, D].  Each kv head's g
        = H / Hkv query heads ride one product as g * m rows (a grouped
        view, no repeated cache).  ``valid`` [B or 1, 1, m, 1] (or
        broadcastable) gives each query row's live rows.  Returns [B, H, m,
        D]."""
        b, h, m, d = qh.data.shape
        hkv = k_cache.shape[1]
        g = h // hkv
        s = self._l("attn", i)(Tensor(qh.data.reshape(b, hkv, g * m, d)),
                               Tensor(k_cache))          # [B, Hkv, g*m, T]
        p = self._l("smax", i)(Tensor(s.data.reshape(b, h, m, -1)),
                               valid_len=valid)
        o = self._l("av", i)(Tensor(p.data.reshape(b, hkv, g * m, -1)),
                             Tensor(v_cache))
        return Tensor(o.data.reshape(b, h, m, d))

    @staticmethod
    def _float_valid(valid, m: int) -> torch.Tensor:
        """Row j's live length ``valid + j`` as [B or 1, 1, m, 1], the
        composed softmax's per-row mask (``valid`` 0-dim or [B])."""
        steps = torch.arange(m, dtype=valid.dtype, device=valid.device)
        return valid.reshape(-1, 1, 1, 1) + steps.reshape(1, 1, m, 1)

    def _decode_step(self, cache, pos, tok):
        """One cached decode step: tokens ``tok`` [B] at position ``pos``
        (an int, a 0-dim tensor, or a [B] tensor of per-row positions).
        Appends each layer's k/v row to ``cache`` in place (a ring layer's
        twice, ``_write_rows``) and returns (logit codes [B, V], cache):
        u8, or float under weight_only.
        Nothing depends on the host's view of ``pos``, so a captured step
        replays at every position, ring layers included.

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
        ring = {}
        for i in range(1, self.depth + 1):
            at, vi = self._write_rows(i, self._rows_of(cache[i][0]), pos,
                                      valid, ring)
            x = self._block_decode(i, x, vi, pos, rows, at, *cache[i])
        x = self.ln_f(x)
        return self._logits(x), cache

    def _write_rows(self, i, t: int, pos, valid, ring: dict):
        """Layer i's cache rows that position ``pos`` writes (int64, [k] for
        a 0-dim ``pos``, [B, k] for a [B] one) and its live length in rows:
        ``pos`` itself and ``valid`` for a full-length cache of ``t`` =
        max_len rows; for a ring, row ``pos - base`` and its mirror S rows
        below it (the row itself while it is below S), and ``valid -
        base``.  The rings of one (rows, window) share one computation a
        step (``ring`` holds it)."""
        if t >= self.max_len:
            return pos.reshape(-1, 1) if pos.dim() else pos.reshape(1), valid
        w = self._layer_window(i)
        if (t, w) not in ring:
            s = t - w
            base = self._ring_base(pos, t, w)
            row = pos - base
            at = torch.stack([row, torch.where(row >= s, row - s, row)], -1)
            ring[t, w] = at, (valid - base).to(torch.int32)
        return ring[t, w]

    @staticmethod
    def _append(buf, new, at, rows):
        """Write the [B, C] codes ``new`` into the rows ``at`` of ``buf``
        ([k] rows of every sequence, or with ``rows`` [B, k] rows of each);
        a row named twice gets the same codes twice.  A head-split float
        ``buf`` [B, Hkv, T, D] takes ``new`` as [B, Hkv * D]."""
        if buf.dim() == 4:
            b, hkv, _, d = buf.shape
            new = new.reshape(b, hkv, 1, d)
            if rows is None:
                buf.index_copy_(2, at, new.expand(-1, -1, at.shape[0], -1))
            else:                                # [B, k, Hkv, D] rows
                buf[rows[:, None], :, at] = new.transpose(1, 2).expand(
                    -1, at.shape[1], -1, -1)
            return
        if rows is None:
            buf.index_copy_(1, at, new.unsqueeze(1).expand(
                -1, at.shape[0], -1))
        else:
            buf[rows[:, None], at] = new.unsqueeze(1).expand(
                -1, at.shape[1], -1)

    @staticmethod
    def _append_rows(buf, new, pos):
        """Write the [B, m, C] codes ``new`` into rows pos..pos+m-1 of
        ``buf`` (``pos`` a 0-dim or [B] device tensor), in place; a
        head-split float ``buf`` [B, Hkv, T, D] takes [B, m, Hkv * D]."""
        steps = torch.arange(new.shape[1], device=buf.device)
        if buf.dim() == 4:
            b, hkv, _, d = buf.shape
            new = new.reshape(b, -1, hkv, d)             # [B, m, Hkv, D]
            if pos.dim() == 0:
                buf.index_copy_(2, pos + steps, new.transpose(1, 2))
            else:
                rows = torch.arange(b, device=buf.device)
                buf[rows[:, None], :, pos[:, None] + steps] = new
            return
        if pos.dim() == 0:
            buf.index_copy_(1, pos + steps, new)
        else:
            rows = torch.arange(buf.shape[0], device=buf.device)
            buf[rows[:, None], pos[:, None] + steps] = new

    def _block_decode(self, i, x, valid, pos, rows, at, k_cache, v_cache):
        h = self._l("ln1_", i)(x)
        q2, k2, v2 = self._qkv(i, h)
        self._append(k_cache, k2.data, at, rows)
        self._append(v_cache, v2.data, at, rows)
        if not q2.quantized:                     # the float cache
            qh = F.split_heads(q2.reshape(x.shape[0], 1, -1), self.heads)
            o = F.merge_heads(self._float_attention(
                i, qh, k_cache, v_cache, self._float_valid(valid, 1)))
            o = self._l("proj", i)(o.reshape(x.shape[0], -1))
            return self._mlp(i, self._l("add1_", i)(x, o))
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
        head's grid), or from float logits (``pick_float``)."""
        if codes.dtype != torch.uint8:
            return pick_float(codes, temps, seeds, pos, topps, topks)
        scale, zp = self._head_scale_zp()
        return pick_u8(codes, scale, zp, temps, seeds, pos, topps, topks)

    def generate(self, ids, steps: int, temperature: float = 0.0,
                 top_k: int | None = None, top_p: float | None = None,
                 seed: int = 0) -> np.ndarray:
        """Decode ``steps`` tokens after the prompt ``ids`` [B, T0]; returns
        int32 [B, steps] on the host.  Call after ``convert()``; a
        weight-only model decodes over the float cache.  ``temperature`` 0
        is greedy; above 0 each token is drawn from softmax(logits /
        temperature), optionally over the top_k codes (logits) and then the
        top_p nucleus (HF's order), with the draw keyed by (seed, row,
        position) (``row_seeds``, ``uniform_hash``): the port's stream, not
        the JAX package's.

        On the card the first decode step runs eagerly and the others
        replay it as a CUDA graph (``graphs.run_steps``); on the CPU they
        run as a loop.  Both give the same tokens.

        After ``shard()`` every rank of the mesh calls it with the same
        arguments: the prompt rows split over the data axis, and the TP
        roles apply at every step — head-local attention over a
        head-sharded u8 KV cache (each rank stores and reads only its
        heads' rows, 1/model_size of the cache), row-parallel proj/fc2
        summing their s32 partials.  Every rank returns all the rows'
        tokens; greedy tokens are bit-identical to the unsharded run.  A
        sampled run folds the data-shard index into the seed, so each shard
        draws its own stream: valid and repeatable tokens, not the
        unsharded run's draws.  The steps run eagerly, without a CUDA
        graph: gloo's collectives (ranks sharing one card) cannot be
        captured."""
        if not self.is_quant:
            raise RuntimeError("generate() requires a converted model")
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
        if self._mesh is None:
            with torch.no_grad():
                toks, program = self._decode_rows(
                    ids, steps, temperature, top_k, top_p, seed, True)
                toks = toks.cpu().numpy().astype(np.int32)
            del program
            return toks
        from ..parallel.sharding import all_gather_cat, data_rows, sharded
        pa = self._parallel_axes
        rows = data_rows(pa, b, "generate() batch")
        with torch.no_grad(), sharded(self):
            toks, _ = self._decode_rows(
                ids[rows], steps, temperature, top_k, top_p,
                seed + (pa.data_index << 32), False)
        return all_gather_cat(toks, pa.data_group, 0).cpu().numpy().astype(
            np.int32)

    def _decode_rows(self, ids: np.ndarray, steps: int, temperature, top_k,
                     top_p, seed: int, capture: bool):
        """``generate()``'s body on the prompt rows ``ids``: (int64 device
        tokens [B, steps], the captured program or None).  ``capture``
        replays the steps as a CUDA graph on the card; without it they
        run eagerly."""
        b, t0 = ids.shape
        dev = self.device
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

        if capture:
            return out, graphs.run_steps(step, steps - 1, dev)
        for _ in range(steps - 1):
            step()
        return out, None

    # -- cached multi-token extend --------------------------------------------
    def _extend_step(self, cache, pos, toks):
        """Tokens ``toks`` [B, m] (a device tensor) at positions
        pos..pos+m-1 against the KV cache: the cached generalization of
        ``_decode_step`` to m query rows.  ``pos`` is an int, a 0-dim or a
        [B] tensor (per-row positions: per-slot serving, per-row
        speculative acceptance).  Appends each layer's m k/v rows to
        ``cache`` in place and returns (logit codes [B, m, V], cache): u8,
        or float under weight_only.

        Row j's attention sees the cache columns < pos + j + 1: every
        earlier position and rows 0..j of this extend, written before
        attention runs.  The codes equal m ``_decode_step`` calls': the
        same integer matmuls on the same codes, and masked columns add
        exactly zero.  Where pos + m passes ``max_len`` the start is
        clamped to ``max_len - m``, as the JAX package's
        ``dynamic_update_slice`` clamps its write, so every write stays
        inside the cache."""
        b, m = toks.shape
        for i in range(1, self.depth + 1):
            if self._rows_of(cache[i][0]) < self.max_len:
                raise NotImplementedError(
                    "multi-token extends over a RING cache would need "
                    "mid-chunk compaction; spec decode / chunked prefill "
                    "require full-length caches (ring_cache=False)")
        dev = self.device
        pos = pos if isinstance(pos, torch.Tensor) else torch.tensor(pos)
        pos = pos.to(device=dev, dtype=torch.int64).clamp(
            0, self.max_len - m)
        x = self._stem(Tensor(toks.to(dev)), start=pos)
        x = x.reshape(b * m, self.dim)
        valid = (pos + 1).to(torch.int32)
        for i in range(1, self.depth + 1):
            x = self._block_extend(i, x, b, m, valid, pos, *cache[i])
        x = self.ln_f(x)
        return self._logits(x).reshape(b, m, self.vocab_size), cache

    def _block_extend(self, i, x, b, m, valid, pos, k_cache, v_cache):
        """One block over the m rows [B*m, C]: the k/v rows written at
        pos..pos+m-1, then every query row against the cache in one
        ``fused_extend_attention`` call."""
        h = self._l("ln1_", i)(x)
        q2, k2, v2 = self._qkv(i, h)
        self._append_rows(k_cache, k2.data.reshape(b, m, -1), pos)
        self._append_rows(v_cache, v2.data.reshape(b, m, -1), pos)
        if not q2.quantized:                     # the float cache
            qh = F.split_heads(q2.reshape(b, m, -1), self.heads)
            o = F.merge_heads(self._float_attention(
                i, qh, k_cache, v_cache, self._float_valid(valid, m)))
            o = self._l("proj", i)(o.reshape(b * m, -1))
            return self._mlp(i, self._l("add1_", i)(x, o))
        (ks, kzp), (vs, vzp) = self._kv_scales(i)
        o = fused_extend_attention(
            self._l("attn", i), self._l("smax", i), self._l("av", i),
            q2.reshape(b, m, -1), Tensor(k_cache, ks, kzp),
            Tensor(v_cache, vs, vzp), valid, self.head_dim)
        o = self._l("proj", i)(o.reshape(b * m, -1))
        return self._mlp(i, self._l("add1_", i)(x, o))

    def generate_speculative(self, draft, ids, steps: int, k: int = 4):
        """Greedy speculative decoding: ``draft`` proposes ``k`` tokens per
        macro-step, this model verifies all k+1 positions in one
        ``_extend_step``, and each row accepts its longest matching prefix
        plus the target's own correction token.  Every emitted token is
        the target's greedy argmax given the accepted prefix, so the
        output equals ``generate()`` token for token.  Returns int32 [B,
        steps] on the host.

        A rejected draft needs no rollback: rows past a sequence's live
        length are masked, and the next macro-step overwrites them.  The
        draft decodes k+1 steps (the extra one writes d_k's k/v row, for a
        fully accepted round); rows that have all their tokens freeze
        their position and park their output writes in the scratch tail
        of the output buffer.  ``draft`` must be a converted decoder over
        the same vocabulary on the same device (any family: a 2-layer gpt
        may draft for a llama); both need ``t0 + steps + k + 1 <=
        max_len``.

        On the card the macro-step is one captured CUDA graph over device
        buffers (position, token, emitted count, output), its first call
        eager (``graphs.run_until``), replayed until every row has
        ``steps`` tokens (the count is read every few replays; a replay
        after the last row is done changes nothing that is returned).  On
        the CPU the same body runs as a loop.

        A ``shard()``ed target (every rank calls it with the same
        arguments; JAX ``_sharded_spec_fn``): the prompt rows split over
        the data axis, the target runs its TP roles (head-sharded caches,
        row-parallel sums in the verify extend) and the draft, which must
        stay unsharded, computes the same thing on every rank.  The
        macro-steps run eagerly, and each data group stops on its own
        rows; the rows are gathered once after the loop, so every rank
        returns all of them, equal to greedy ``generate()``.

        Afterwards ``speculative_stats`` holds the run's ``macro_steps``,
        ``row_steps`` (a row's macro-steps while it still needed tokens)
        and ``emitted`` tokens over those row-steps (accepted drafts plus
        one correction each); on a sharded target also
        ``macro_steps_by_data_group``."""
        if not (self.is_quant and draft.is_quant):
            raise RuntimeError(
                "generate_speculative() requires converted target and "
                "draft models")
        if draft.vocab_size != self.vocab_size:
            raise ValueError(
                f"draft vocab {draft.vocab_size} != target vocab "
                f"{self.vocab_size}")
        if getattr(draft, "_mesh", None) is not None:
            raise NotImplementedError(
                "speculative decoding takes a replicated draft: a shard()ed "
                "draft is unsupported (as in the JAX package); shard the "
                "target only")
        if draft.device != self.device:
            raise ValueError(f"draft on {draft.device}, target on "
                             f"{self.device}")
        ids = np.asarray(ids)
        b, t0 = ids.shape
        pa = self._parallel_axes if self._mesh is not None else None
        if pa is not None and b % pa.data_size:
            raise ValueError(
                f"generate_speculative() on a ({pa.data_size}, "
                f"{pa.model_size}) mesh needs batch % {pa.data_size} == 0, "
                f"got {b}")
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        need = t0 + steps + k + 1
        if need > self.max_len or need > draft.max_len:
            raise ValueError(
                f"prompt {t0} + steps {steps} + draft depth {k} + 1 "
                f"exceeds max_len (target {self.max_len}, draft "
                f"{draft.max_len}) — speculative decoding needs k+1 "
                f"rows of overshoot headroom")
        if pa is None:
            with torch.no_grad():
                toks, stats = self._speculate(draft, ids, steps, k, True)
        else:
            from ..parallel.sharding import (all_gather_cat, data_rows,
                                             sharded)
            with torch.no_grad(), sharded(self):
                toks, stats = self._speculate(
                    draft, ids[data_rows(pa, b)], steps, k, False)
            # the rows, and each data group's counts, gathered once after
            # the loop; the group that ran longest sets the macro-steps
            toks = all_gather_cat(toks, pa.data_group, 0)
            stats = all_gather_cat(stats[None], pa.data_group, 0)
            by_group = [int(x) for x in stats[:, 0].cpu()]
            stats = torch.cat([stats[:, :1].max(0).values,
                               stats[:, 1:].sum(0)])
        self.speculative_stats = dict(zip(
            ("macro_steps", "row_steps", "emitted"),
            (int(x) for x in stats.cpu())))
        if pa is not None:
            self.speculative_stats["macro_steps_by_data_group"] = by_group
        return toks.cpu().numpy().astype(np.int32)

    def _speculate(self, draft, ids: np.ndarray, steps: int, k: int,
                   capture: bool):
        """``generate_speculative``'s body on the prompt rows ``ids``:
        (int64 device tokens [B, steps], the counts [macro-steps,
        row-steps, emitted]).  ``capture`` replays the macro-step as a CUDA
        graph on the card; without it (a sharded target, whose model-group
        collectives cannot be captured over gloo) the macro-steps run
        eagerly until this rank's rows are done: each data group stops on
        its own count, which is sound because no collective of the loop
        crosses the data axis."""
        b, t0 = ids.shape
        dev = self.device
        width = steps + k + 1
        prompt = Tensor(torch.tensor(ids.astype(np.int64), device=dev))
        codes0, tcache = self._prefill(prompt)
        _, dcache = draft._prefill(prompt)
        tok = codes0.argmax(-1)
        out = torch.zeros((b, width), dtype=torch.int64, device=dev)
        out[:, 0] = tok
        n_out = torch.ones((b,), dtype=torch.int64, device=dev)
        pos = torch.full((b,), t0, dtype=torch.int64, device=dev)
        cols = torch.arange(k + 1, device=dev)
        park = torch.full((b,), width - (k + 1), dtype=torch.int64,
                          device=dev)
        # macro-steps, active row-steps, tokens emitted
        counts = torch.zeros((3,), dtype=torch.int64, device=dev)
        one = torch.ones((), dtype=torch.int64, device=dev)

        def macro():
            # 1) the draft's k greedy tokens; step i writes the k/v of
            # its input token at pos + i, the (k+1)-th d_k's
            dtok, drafted = tok, []
            for i in range(k + 1):
                dcodes, _ = draft._decode_step(dcache, pos + i, dtok)
                dtok = dcodes.argmax(-1)
                drafted.append(dtok)
            dtoks = torch.stack(drafted[:k], 1)             # [B, k]
            # 2) the target verifies [tok, d_1..d_k] in one extend
            codes, _ = self._extend_step(
                tcache, pos, torch.cat([tok[:, None], dtoks], 1))
            g = codes.argmax(-1)                            # [B, k+1]
            # 3) the longest matching prefix plus the correction
            a = (dtoks == g[:, :k]).to(torch.int64).cumprod(1).sum(1)
            active = n_out < steps
            na = torch.where(active, a + 1, torch.zeros_like(a))
            # 4) all k+1 candidates at the row's offset (the first na
            # survive); finished rows write into the scratch tail
            off = torch.where(active, n_out, park)
            out.scatter_(1, off[:, None] + cols, g)
            tok.copy_(torch.where(active, g.gather(1, a[:, None])[:, 0],
                                  tok))
            pos.add_(na)
            n_out.add_(na)
            counts.add_(torch.stack([one, active.sum(), na.sum()]))

        def done():
            return bool(n_out.min() >= steps)

        if capture:
            # at full acceptance a macro-step emits k + 1 tokens
            program = graphs.run_until(
                macro, done, dev, first=-(-(steps - 1) // (k + 1)),
                every=4)
            toks = out[:, :steps].clone()
            del program
            return toks, counts
        while not done():
            macro()
        return out[:, :steps], counts


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
