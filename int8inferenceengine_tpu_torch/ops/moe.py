"""The mixture-of-experts MLP's arithmetic (counterpart of the JAX package's
``QuantMoE._route``, ``_experts`` and ``_experts_sparse``,
``layers.py:1829-1972``): top-k routing and the SwiGLU experts with their
weighted combine.

The JAX package leaves all of it to XLA (no ``pallas_call``), so the port
uses stock PyTorch: the s8 expert products run ``ops/weight_only.s8_matmul``
(``torch._int_mm`` on the card, exact float64 on the CPU), and the float
branches ``torch.matmul``.  ``experts`` counts its calls in ``.calls``.

* **The router** is float32 ``f @ router^T`` taken in float64 and rounded
  once (the card and the CPU add a float32 dot in other orders, and an ULP
  there moves a routing weight and every code after it), then the top-k
  mask that keeps *every* expert tied at the k-th logit (``logits >=
  kth``) and a softmax (``attention.softmax_last``: float64 exps and sum,
  rounded once).  Routing weights are exact zeros outside the top-k.
* **Dynamic W8A8 experts** (s8 weights, not plain weight-only): each token
  quantizes to s8 at its own scale (``quant.quantize_dynamic``), gate and
  up accumulate exactly in s32 (one product each against the experts'
  ``[E*H, K]`` view), ``acc * s_a * s_w`` dequantizes, ``silu(g) * u``
  requantizes per (token, expert) row, the down product accumulates
  exactly per expert, ``acc * s2 * s_w`` dequantizes.
* **Float experts** (FP32 before convert; plain ``weight_only`` dequantizes
  its s8 experts at each call): float32 products, expert by expert.
* **The combine** adds ``d_e * w[:, e]`` in expert order e = 0..E-1, each
  operation rounded on its own, so a skipped expert (sparse dispatch) adds
  exactly the zero that its zero routing weight adds densely: sparse and
  dense dispatch give the same codes.
"""

from __future__ import annotations

import torch

from .functional import ACTIVATIONS
from .quant import f32, quantize_dynamic
from .weight_only import s8_matmul

__all__ = ["route", "experts"]

_silu = ACTIVATIONS["silu"]


def route(f: torch.Tensor, router: torch.Tensor, top_k: int) -> torch.Tensor:
    """Top-k routing weights float32 [M, E] of tokens ``f`` [M, K] through
    ``router`` [E, K]: a softmax over the logits at or above the k-th
    largest (ties keep every tied expert), exact zeros elsewhere."""
    from .attention import softmax_last
    logits = torch.matmul(f.to(torch.float64),
                          router.to(torch.float64).t()).to(torch.float32)
    kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
    return softmax_last(torch.where(logits >= kth, logits,
                                    f32(float("-inf"), f.device)))


def _per_row(s: torch.Tensor, e: int) -> torch.Tensor:
    """Expert e's weight scale against its [M, rows] output: a 0-dim
    tensor (one scale an expert) or [1, rows] (one an expert row)."""
    return s[e] if s.dim() == 1 else s[e].reshape(1, -1)


def experts(f, wexp, gate, up, down, gs, us, ds, *, dynamic: bool,
            sparse: bool) -> torch.Tensor:
    """The experts' combined output float32 [M, K] for tokens ``f`` [M, K]
    and routing weights ``wexp`` [M, E].  ``gate``/``up`` [E, H, K] and
    ``down`` [E, K, H] are s8 with scales ``gs``/``us``/``ds`` ([E], or
    [E, rows] per expert row), or float32 with scales None.  ``dynamic``
    runs the s8 weights through the dynamic W8A8 products (else they
    dequantize to float32); ``sparse`` skips the experts that no token
    routes to, which costs one host sync for the routing mask."""
    experts.calls += 1
    m = f.shape[0]
    n_exp, hidden, _ = gate.shape
    if sparse:
        hit = (wexp > 0).any(0).cpu().tolist()
    else:
        hit = [True] * n_exp
    out = torch.zeros_like(f)
    if dynamic:
        a, s_a = quantize_dynamic(f, (1,))              # per token [M, 1]
        if not sparse:
            accg = s8_matmul(a, gate.reshape(n_exp * hidden, -1)).reshape(
                m, n_exp, hidden)
            accu = s8_matmul(a, up.reshape(n_exp * hidden, -1)).reshape(
                m, n_exp, hidden)
    for e in range(n_exp):
        if not hit[e]:
            continue
        if dynamic:
            if sparse:
                ag, au = s8_matmul(a, gate[e]), s8_matmul(a, up[e])
            else:
                ag, au = accg[:, e], accu[:, e]
            g = ag.to(torch.float32) * s_a * _per_row(gs, e)
            u = au.to(torch.float32) * s_a * _per_row(us, e)
            p8, s2 = quantize_dynamic(_silu(g) * u, (1,))
            d = s8_matmul(p8, down[e]).to(torch.float32) * s2 \
                * _per_row(ds, e)
        else:
            ge, ue, de = gate[e], up[e], down[e]
            if gs is not None:
                ge, ue, de = (w.to(torch.float32) * (s[e] if s.dim() == 1
                                                     else s[e][:, None])
                              for w, s in ((ge, gs), (ue, us), (de, ds)))
            h = _silu(torch.matmul(f, ge.t())) * torch.matmul(f, ue.t())
            d = torch.matmul(h, de.t())
        out = out + d * wexp[:, e:e + 1]
    return out


experts.calls = 0
