"""Modern-LM serving tour: llama-family INT8 PTQ end to end.

The serving stack in one script — llama GQA decode, RMSNorm smoothing,
the accuracy configuration for many-boundary stacks
(rounding='nearest'), HF-named checkpoint ingestion (utils/hf.py),
speculative decoding (draft model, target-exact greedy), the
continuous-batching engine with multi-chunk syncing, the same engine over
a shard()ed llama on a (2, 2) mesh (head-sharded u8 slot caches) in a
spawned world of 4 ranks, W4A8 serving (4-bit weights on the u8
activation path), the MoE family, a quantized-artifact checkpoint
round-trip, and the expert-parallel forward of the MoE in a spawned world
of 4 ranks on a (2, 2) mesh (TP attention + EP experts; ``parallel/``).

    python -m int8inferenceengine_tpu_torch.examples.llm_serving \
        [--device cpu]
"""

import argparse
import re
import tempfile
import time

import numpy as np
import torch

import int8inferenceengine_tpu_torch as q
from int8inferenceengine_tpu_torch import QuantConfig, models, utils
from int8inferenceengine_tpu_torch.examples import add_device_arg, device_of
from int8inferenceengine_tpu_torch.models.text_decoder import \
    torch_text_decoder
from int8inferenceengine_tpu_torch.parallel import make_mesh
from int8inferenceengine_tpu_torch.parallel.launch import run_world
from int8inferenceengine_tpu_torch.serve import GenerationEngine

_HF_BLOCK = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
             "wv": "self_attn.v_proj", "proj": "self_attn.o_proj",
             "gate": "mlp.gate_proj", "up": "mlp.up_proj",
             "down": "mlp.down_proj", "ln1_": "input_layernorm",
             "ln2_": "post_attention_layernorm"}
_HF_TOP = {"embed.weight": "model.embed_tokens.weight",
           "ln_f.weight": "model.norm.weight",
           "head.weight": "lm_head.weight"}


def hf_named(state: dict) -> dict:
    """A llama twin's state dict under the names real llama exports use
    (``model.layers.N.self_attn.q_proj.weight``)."""
    out = {}
    for k, v in state.items():
        mm = re.match(r"(wq|wk|wv|proj|gate|up|down|ln1_|ln2_)(\d+)"
                      r"\.weight", k)
        if mm:
            out[f"model.layers.{int(mm.group(2)) - 1}"
                f".{_HF_BLOCK[mm.group(1)]}.weight"] = v
        else:
            out[_HF_TOP[k]] = v
    return out


def parallel_rank(moe_path: str, llama_path: str, prompt: np.ndarray, cfg,
                  device: str):
    """One rank of the two parallel legs: (the expert-parallel forward on
    ``prompt`` of the saved MoE sharded over a (2, 2) mesh (DP x TP
    attention + EP experts), the sharded-engine leg's tokens).  The
    engine leg: the saved llama sharded over a (2, 2) mesh and a
    ``GenerationEngine`` (2 slots) built on every rank; rank 0 submits
    ``prompt[0]`` for 8 tokens, the other ranks follow (their tokens are
    None)."""
    import torch.distributed as dist
    dev = device_of(device)
    mesh_dev = "cpu" if dev.type == "cpu" else None
    moe = models.build("moe_tiny", config=cfg, device=dev)
    utils.load(moe, moe_path)
    moe.shard(make_mesh((2, 2), devices=mesh_dev))
    moe_out = moe(q.tensor(prompt, device=dev)).numpy()
    del moe
    m = models.build("llama_tiny", config=cfg, device=dev)
    utils.load(m, llama_path)
    m.shard(make_mesh((2, 2), devices=mesh_dev))
    eng = GenerationEngine(m, slots=2, chunk_steps=8)
    try:
        toks = (eng.submit(prompt[0], 8).result(timeout=600)
                if dist.get_rank() == 0 else None)
    finally:
        eng.shutdown()
    return moe_out, toks


def calibrated(m, cal, dev):
    m.prepare()
    m(q.tensor(cal, device=dev))
    m.convert()
    return m


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    t_start = time.perf_counter()
    checks = {}
    rng = np.random.default_rng(0)
    cal = rng.integers(0, 1000, (8, 64)).astype(np.int32)
    prompt = rng.integers(0, 1000, (4, 12)).astype(np.int32)

    # --- llama-family target: RMSNorm / RoPE / GQA / SwiGLU -------------
    cfg = QuantConfig(rounding="nearest")   # the many-boundary setting
    tw = models.torch_twin("llama_tiny")
    m = models.build("llama_tiny", config=cfg, device=dev)
    m.load(tw.state_dict())
    with torch.no_grad():
        ref = tw(torch.tensor(prompt, dtype=torch.long)).numpy()
    checks["fp32_max_abs_diff"] = float(np.abs(
        m(q.tensor(prompt, device=dev)).numpy() - ref).max())
    print(f"llama FP32 parity: max |diff| = "
          f"{checks['fp32_max_abs_diff']:.2e}")

    # SmoothQuant-style RMSNorm smoothing, then calibrate + convert
    utils.smooth(m, utils.transformer_smooth_pairs(m), cal)
    calibrated(m, cal, dev)
    out8 = m(q.tensor(prompt, device=dev)).numpy()
    checks["int8_agreement"] = float(
        (out8[:, -1].argmax(-1) == ref[:, -1].argmax(-1)).mean())
    print(f"llama INT8 next-token agreement vs torch FP32: "
          f"{checks['int8_agreement']:.2f}")

    # greedy generate over the kv-compact u8 cache
    toks = m.generate(prompt, 10)
    print(f"generate: {toks.shape} tokens, row0 = {toks[0].tolist()}")

    # --- speculative decoding: small gpt draft, llama target ------------
    draft = models.build("gpt_tiny", dim=64, depth=1, heads=2, device=dev)
    draft.load(torch_text_decoder(dim=64, depth=1, heads=2).state_dict())
    calibrated(draft, cal, dev)
    spec = m.generate_speculative(draft, prompt, 10, k=4)
    checks["speculative_equals_greedy"] = bool(np.array_equal(spec, toks))
    print(f"speculative == greedy generate: "
          f"{checks['speculative_equals_greedy']}")

    # --- HF-named checkpoint ingestion ----------------------------------
    # real llama exports use model.layers.N.self_attn.q_proj.weight
    # naming; Module.load translates automatically (utils/hf.py)
    m_hf = models.build("llama_tiny", config=cfg, device=dev)
    m_hf.load(hf_named(tw.state_dict()))
    checks["hf_bit_identical"] = all(
        np.array_equal(getattr(m_hf, nm).weight.cpu().numpy(),
                       getattr(tw, nm).weight.detach().numpy())
        for nm in ("wq1", "gate1", "down1", "head"))
    print(f"HF-named state_dict loads bit-identically: "
          f"{checks['hf_bit_identical']}")

    # --- continuous-batching engine (multi-chunk syncing) ---------------
    eng = GenerationEngine(m, slots=2, chunk_steps=8, sync_chunks=4)
    try:
        futs = [eng.submit(prompt[i], 8) for i in range(4)]
        outs = [f.result(timeout=600) for f in futs]
        checks["engine_equals_generate"] = all(
            np.array_equal(outs[i], m.generate(prompt[i:i + 1], 8)[0])
            for i in range(4))
        print(f"engine (sync_chunks=4) == standalone generate: "
              f"{checks['engine_equals_generate']}")
        # per-request sampling filters (top_k AND top_p), per-request eos,
        # and streaming token output
        streamed = list(eng.submit_stream(
            prompt[0], 8, temperature=0.9, seed=7, top_k=20, top_p=0.9))
        again = eng.submit(prompt[0], 8, temperature=0.9, seed=7,
                           top_k=20, top_p=0.9).result(timeout=600)
        checks["stream_equals_resubmission"] = bool(
            np.array_equal(streamed, again))
        print(f"streamed sampled tokens (top_k=20, top_p=0.9) == "
              f"resubmission: {checks['stream_equals_resubmission']}")
    finally:
        eng.shutdown()

    # --- the engine over a shard()ed decoder: its llama (the leg runs in
    # the world of the expert-parallel leg, below) ------------------------
    m_tp = models.build("llama_tiny", config=cfg, device=dev)
    m_tp.load(tw.state_dict())
    calibrated(m_tp, cal, dev)
    want_tp = m_tp.generate(prompt[:1], 8)[0]

    # --- W4A8: 4-bit weights on the static u8 activation path -----------
    w4 = models.build("llama_tiny", device=dev,
                      config=QuantConfig(rounding="nearest",
                                         weight_bits=4, w4_group=256))
    w4.load(tw.state_dict())
    calibrated(w4, cal, dev)
    w4_out = w4(q.tensor(prompt, device=dev)).numpy()
    checks["w4a8_agreement"] = float(
        (w4_out[:, -1].argmax(-1) == ref[:, -1].argmax(-1)).mean())
    print(f"W4A8 (half the weight bytes, u8 serving glue) next-token "
          f"agreement: {checks['w4a8_agreement']:.2f}")

    # --- quantized-artifact checkpoint ----------------------------------
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/llama_int8.npz"
        utils.save(m, path)
        fresh = models.build("llama_tiny", config=cfg, device=dev)
        utils.load(fresh, path)
        checks["checkpoint_bit_exact"] = bool(
            np.array_equal(fresh.generate(prompt, 10), toks))
        print(f"checkpoint round-trip bit-exact: "
              f"{checks['checkpoint_bit_exact']}")

    # --- MoE family (expert parallelism: ROADMAP.md item 10) ------------
    moe = models.build("moe_tiny", config=cfg, device=dev)
    moe.load(models.torch_twin("moe_tiny").state_dict())
    calibrated(moe, cal, dev)
    base = moe(q.tensor(prompt, device=dev)).numpy()
    checks["moe_finite"] = bool(np.isfinite(base).all())
    # --- the parallel legs in one spawned world of 4 ranks: the MoE's
    # expert-parallel forward, the engine over the shard()ed llama -------
    with tempfile.TemporaryDirectory() as d:
        utils.save(moe, f"{d}/moe_int8.npz")
        utils.save(m_tp, f"{d}/llama_int8.npz")
        outs = run_world(parallel_rank, 4,
                         args=(f"{d}/moe_int8.npz", f"{d}/llama_int8.npz",
                               prompt, cfg, dev.type),
                         device=dev.type, timeout_s=600)
    checks["expert_parallel_bit_exact"] = all(
        np.array_equal(o, base) for o, _ in outs)
    print(f"expert-parallel forward bit-exact: "
          f"{checks['expert_parallel_bit_exact']}")
    checks["sharded_engine_equals_generate"] = bool(
        np.array_equal(outs[0][1], want_tp))
    print(f"SHARDED engine (TP (2,2) mesh, head-sharded u8 cache) "
          f"== generate: {checks['sharded_engine_equals_generate']}")
    checks["wall_s"] = time.perf_counter() - t_start
    return checks


if __name__ == "__main__":
    main()
