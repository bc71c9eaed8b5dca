"""Trained-LM accuracy: perplexity + next-token accuracy on REAL
trained weights.

No text corpus ships with the repository, so the task is procedural with
KNOWN structure: an order-2 Markov language over a small vocab (each
(prev2, prev1) state has 4 permitted successors with fixed probs [0.55,
0.25, 0.15, 0.05]).  The true per-token entropy is therefore computable in
closed form — perplexities have an absolute floor (exp(H) ~ 3.03) to be
read against, not just each other.  Order 2 matters: a first-order
predictor cannot reach the floor, so the model must actually use attention
(two tokens back), which is the quantized path under test.

Flow (the accuracy_synthetic recipe, LM edition):
  1. train the llama-architecture (or ``--family gemma``) TORCH twin on
     chain samples (AdamW) on the chosen device;
  2. load the trained state_dict into decoder variants, run the PTQ
     lifecycle, and measure held-out perplexity + next-token accuracy for:
     torch FP32 (oracle), engine FP32, INT8 trunc (reference-parity
     default), INT8 nearest, nearest+SmoothQuant, INT8 per-channel, W4
     weight-only, W4+GPTQ, W4A8 at groups of 128 and 256.

``--spec`` also trains a smaller draft on the same chain and measures the
draft-target INT8 greedy agreement (the acceptance driver) and that
speculative decoding equals greedy on the trained pair.

    python -m int8inferenceengine_tpu_torch.examples.accuracy_lm \
        [--steps 700] [--dim 128] [--family llama|gemma] [--spec] \
        [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from int8inferenceengine_tpu_torch import QuantConfig, models, tensor
from int8inferenceengine_tpu_torch.carry import export_state
from int8inferenceengine_tpu_torch.examples import add_device_arg, device_of
from int8inferenceengine_tpu_torch.models.gemma import torch_gemma
from int8inferenceengine_tpu_torch.models.llama import torch_llama
from int8inferenceengine_tpu_torch.utils import (gptq, smooth,
                                                 transformer_smooth_pairs)


def make_chain(vocab: int, rng: np.random.Generator):
    """Order-2 Markov language: successors[s2, s1] = 4 permitted next
    tokens (distinct), probs [0.55, 0.25, 0.15, 0.05]."""
    succ = np.zeros((vocab, vocab, 4), np.int64)
    for a in range(vocab):
        for b in range(vocab):
            succ[a, b] = rng.choice(vocab, size=4, replace=False)
    probs = np.array([0.55, 0.25, 0.15, 0.05])
    ent = -(probs * np.log(probs)).sum()
    return succ, probs, float(np.exp(ent))


def sample_chain(succ, probs, n_seq: int, seq_len: int,
                 rng: np.random.Generator):
    vocab = succ.shape[0]
    out = np.zeros((n_seq, seq_len), np.int64)
    out[:, 0] = rng.integers(0, vocab, n_seq)
    out[:, 1] = rng.integers(0, vocab, n_seq)
    for t in range(2, seq_len):
        choice = rng.choice(4, size=n_seq, p=probs)
        out[:, t] = succ[out[:, t - 2], out[:, t - 1], choice]
    return out


def torch_eval(net, ids):
    """The torch twin's float32 logits of ``ids`` as a host array."""
    dev = next(net.parameters()).device
    with torch.no_grad():
        logits = net(torch.tensor(ids, device=dev))
    return np.asarray(logits.cpu().numpy(), np.float32)


def metrics(logits: np.ndarray, ids: np.ndarray, skip: int = 2):
    """Perplexity + next-token top-1 accuracy, predictions for rows
    [skip-1, T-1) against targets [skip, T) (the first ``skip`` tokens
    are unpredictable by construction)."""
    x = logits[:, skip - 1:-1].astype(np.float64)
    tgt = ids[:, skip:]
    x = x - x.max(-1, keepdims=True)
    logp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    nll = -np.take_along_axis(logp, tgt[..., None], -1).mean()
    acc = (x.argmax(-1) == tgt).mean()
    return float(np.exp(nll)), float(acc)


def engine_logits(m, ids):
    """A model's logits of ``ids`` as host float32: a quantized output's
    codes dequantized as ``(code - zp) * scale`` in float32."""
    out = m(tensor(ids.astype(np.int32), device=m.device))
    data = out.data.cpu().numpy()
    if out.quantized:
        return (np.asarray(data, np.float32)
                - float(out.zero_point)) * float(out.scale)
    return np.asarray(data, np.float32)


def train(net, succ, probs, steps, batch, seq, vocab, rng, sched=True,
          log=None):
    """AdamW (cosine schedule when ``sched``) on chain samples drawn from
    ``rng``, on the net's device."""
    dev = next(net.parameters()).device
    opt = torch.optim.AdamW(net.parameters(), lr=3e-3, weight_decay=0.01)
    cosine = torch.optim.lr_scheduler.CosineAnnealingLR(opt, steps) \
        if sched else None
    lossf = torch.nn.CrossEntropyLoss()
    t0 = time.time()
    for step in range(steps):
        x = torch.tensor(sample_chain(succ, probs, batch, seq, rng),
                         device=dev)
        loss = lossf(net(x)[:, 1:-1].reshape(-1, vocab),
                     x[:, 2:].reshape(-1))
        opt.zero_grad()
        loss.backward()
        opt.step()
        if cosine is not None:
            cosine.step()
        if log is not None and (step % 100 == 0 or step == steps - 1):
            log(f"  step {step:4d} loss {float(loss.detach()):.3f} "
                f"({time.time()-t0:.0f}s)")
    return net


def weight_elements(model) -> int:
    """Elements of every layer parameter, in the JAX package's layouts."""
    return sum(int(np.prod(v.shape)) for st in export_state(model).values()
               for v in st["params"].values())


LEGS = [
    ("engine FP32", dict(quantize=False), QuantConfig()),
    ("INT8 trunc (default)", {}, QuantConfig()),
    ("INT8 nearest", {}, QuantConfig(rounding="nearest")),
    ("INT8 nearest + smooth", dict(use_smooth=True),
     QuantConfig(rounding="nearest")),
    ("INT8 nearest + per-channel", {},
     QuantConfig(rounding="nearest", weight_per_channel=True)),
    ("W4 weight-only", {}, QuantConfig(weight_only=True, weight_bits=4)),
    ("W4 + GPTQ", dict(use_gptq=True),
     QuantConfig(weight_only=True, weight_bits=4)),
    ("W4A8 static (g=128)", {},
     QuantConfig(weight_bits=4, rounding="nearest")),
    ("W4A8 static (g=256)", {},
     QuantConfig(weight_bits=4, rounding="nearest", w4_group=256)),
]


def select_legs(legs, spec: str | None):
    """``--legs``: comma-separated leg names, or substrings of them (a
    word that is not a whole leg name picks every leg that contains it)."""
    if not spec:
        return legs
    wanted = [w.strip() for w in spec.split(",")]
    names = [other[0] for other in legs]
    return [leg for leg in legs
            if any(w == leg[0] or (w not in names and w in leg[0])
                   for w in wanted)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--vocab", type=int, default=32)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--kv-heads", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--steps", type=int, default=700)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true",
                    help="tiny geometry + few steps (the test harness)")
    ap.add_argument("--legs", type=str, default=None,
                    help="comma-separated substring filter over lever "
                         "legs (default: all)")
    ap.add_argument("--spec", action="store_true",
                    help="also train a SMALLER draft on the same chain "
                         "and measure speculative-decoding acceptance "
                         "on real trained weights")
    ap.add_argument("--family", choices=("llama", "gemma"),
                    default="llama",
                    help="twin architecture: llama (default) or gemma "
                         "(sandwich norms, softcaps, GeGLU, alternating "
                         "windows): gemma's final softcap compresses "
                         "logit margins, so its INT8 claims need "
                         "trained-twin ppl, not toy argmax agreement")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    t_start = time.perf_counter()
    if args.quick:
        args.dim, args.depth, args.steps, args.batch = 64, 3, 260, 48

    rng = np.random.default_rng(args.seed)
    succ, probs, floor = make_chain(args.vocab, rng)
    print(f"entropy floor: ppl {floor:.2f}")

    geo = dict(vocab_size=args.vocab, max_len=args.seq, dim=args.dim,
               depth=args.depth, heads=args.heads, kv_heads=args.kv_heads)
    if args.family == "gemma":
        # alternating windows engage for real: window < seq
        geo["sliding_window"] = max(8, args.seq // 4)
        twin_fn, zoo_name = torch_gemma, "gemma_tiny"
    else:
        twin_fn, zoo_name = torch_llama, "llama_tiny"
    t0 = time.time()
    net = train(twin_fn(**geo, seed=args.seed).to(dev), succ, probs,
                args.steps, args.batch, args.seq, args.vocab, rng,
                log=lambda s: print(s, flush=True))
    train_s = time.time() - t0

    test = sample_chain(succ, probs, 64, args.seq,
                        np.random.default_rng(args.seed + 1))
    calib = sample_chain(succ, probs, 32, args.seq,
                         np.random.default_rng(args.seed + 2))
    t_ppl, t_acc = metrics(torch_eval(net, test), test)
    print(f"torch FP32: ppl {t_ppl:.3f} acc {t_acc:.3f}")
    state = net.state_dict()

    def build(config, quantize=True, use_smooth=False, use_gptq=False):
        m = models.build(zoo_name, **geo, config=config, device=dev)
        m.load(state)
        if not quantize:
            return m
        if use_smooth:
            smooth(m, transformer_smooth_pairs(m), calib.astype(np.int32))
        m.prepare()
        m(tensor(calib.astype(np.int32), device=dev))
        if use_gptq:
            gptq(m, calib.astype(np.int32))
        m.convert()
        return m

    results = {}
    for name, kw, cfg in select_legs(LEGS, args.legs):
        m = build(cfg, **kw)
        ppl, acc = metrics(engine_logits(m, test), test)
        results[name] = (ppl, acc)
        print(f"{name}: ppl {ppl:.3f} acc {acc:.3f}", flush=True)
        del m

    out = {"family": args.family, "geometry": geo, "steps": args.steps,
           "floor": floor, "torch": (t_ppl, t_acc), "results": results,
           "train_s": train_s}
    if args.spec:
        out["spec"] = speculative(args, geo, succ, probs, rng, test, calib,
                                  build, dev)
    out["wall_s"] = time.perf_counter() - t_start
    return out


def speculative(args, geo, succ, probs, rng, test, calib, build, dev):
    """Speculative decoding on REAL trained weights: a draft at ~1/4 the
    size trained on the same chain; the draft-target greedy agreement (the
    acceptance-rate driver) and target-exactness of
    ``generate_speculative`` end to end."""
    dgeo = dict(geo, dim=max(32, args.dim // 2),
                depth=max(1, args.depth // 2))
    dnet = train(torch_llama(**dgeo, seed=args.seed + 9).to(dev), succ,
                 probs, args.steps // 2, args.batch, args.seq, args.vocab,
                 rng, sched=False)
    d_ppl, d_acc = metrics(torch_eval(dnet, test), test)
    print(f"draft torch FP32 ({dgeo['dim']}d/{dgeo['depth']}L): "
          f"ppl {d_ppl:.3f} acc {d_acc:.3f}", flush=True)
    tgt = build(QuantConfig(rounding="nearest"))
    drf = models.build("llama_tiny", **dgeo, device=dev,
                       config=QuantConfig(rounding="nearest"))
    drf.load(dnet.state_dict())
    drf.prepare()
    drf(tensor(calib.astype(np.int32), device=dev))
    drf.convert()
    # acceptance driver: greedy agreement of draft vs target next-token
    # predictions on held-out text
    tl = engine_logits(tgt, test)[:, :-1].argmax(-1)
    dl = engine_logits(drf, test)[:, :-1].argmax(-1)
    a = float((tl == dl).mean())
    k = 4
    # memory-bound decode: the draft's step costs the WEIGHT-BYTE share f
    # of the target's
    f = weight_elements(drf) / weight_elements(tgt)
    exp_len = (1 - a ** (k + 1)) / (1 - a) if a < 1 else k + 1
    print(f"draft-target INT8 agreement a={a:.3f} -> expected "
          f"{exp_len:.2f} tokens/macro-step at k={k} (draft f={f:.2f} by "
          f"weight bytes)", flush=True)
    ids0 = test[:4, :8].astype(np.int32)
    spec = np.asarray(tgt.generate_speculative(drf, ids0, 16, k=k))
    greedy = np.asarray(tgt.generate(ids0, 16))
    equal = bool((spec == greedy).all())
    print(f"spec == greedy on trained models: {equal}", flush=True)
    return {"draft_ppl": d_ppl, "draft_acc": d_acc, "agreement": a, "k": k,
            "expected_tokens_per_macro_step": exp_len,
            "draft_weight_share": f, "spec_equals_greedy": equal,
            "draft_geometry": dgeo}


if __name__ == "__main__":
    main()
