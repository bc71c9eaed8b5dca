"""PyTorch port vs JAX package: Hugging Face checkpoint ingest
(``utils/hf.py``), mirroring ``tests/test_hf_checkpoint.py`` and
``tests/test_bloom.py::test_hf_bloom_naming_loads`` at tiny widths (dim 64,
depth 2, 4 heads; vocab 97-211).

Each family's HF state dict is written here from seeded numpy weights in
the layouts the exporters use (llama nn.Linear [out, in]; gpt2's Conv1D
transposed with a fused ``c_attn`` and mask buffers; NeoX's and BLOOM's
per-head interleaved ``query_key_value``; phi's one LayerNorm a block;
OPT's positions offset by 2; gemma's four norms and tied head; derived
``rotary_emb.inv_freq`` buffers).

* ``detect`` and ``from_hf`` equal the JAX package's key for key and bit
  for bit, from numpy arrays and from torch tensors; an unknown key raises
  ``KeyError`` in both; ``from_hf_config`` gives the same class name and
  keyword arguments for all nine ``model_type``s and the same exception
  type on the same bad configs;
* ``Module.load`` of each family's HF dict gives the FP32 weights and
  logits of the natively named load bit for bit;
* ``load_pretrained`` reads a single safetensors file, a sharded set and
  ``pytorch_model.bin`` / ``.pt``; overrides win; a missing directory or
  weights raise ``FileNotFoundError``; as in the JAX package, a bfloat16
  safetensors file reads exactly as float32 and a bfloat16 ``.bin`` raises
  ``TypeError``; without ``device`` it builds on the card and raises
  without one;
* gemma2 (sharded), gpt_neox (``.bin``) and mistral (single file) loaded
  by both packages' ``load_pretrained``: FP32 logits within 1e-5 of the
  largest logit (the bound of each family's port test against its twin);
  the JAX package's converted state carried over (``load_jax_state``)
  gives its INT8 codes, equal for gemma2 and mistral and, for gpt_neox,
  under ``test_torch_neox``'s contract (at least 99% equal, within 2).
"""

import json
import re

import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

import int8inferenceengine_tpu as qj
from int8inferenceengine_tpu.utils import hf as jhf
import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch.carry import load_jax_state
from int8inferenceengine_tpu_torch.models import zoo as tzoo
from int8inferenceengine_tpu_torch.models.bloom import (BloomDecoder,
                                                        torch_bloom)
from int8inferenceengine_tpu_torch.models.gemma import (GemmaDecoder,
                                                        torch_gemma)
from int8inferenceengine_tpu_torch.models.llama import (LlamaDecoder,
                                                        torch_llama)
from int8inferenceengine_tpu_torch.models.neox import NeoXDecoder, torch_neox
from int8inferenceengine_tpu_torch.models.text_decoder import (
    TextDecoder, torch_text_decoder)
from int8inferenceengine_tpu_torch.utils import hf
from test_torch_text_decoder import jax_state
from test_torch_threads import one_torch_thread  # noqa: F401

NEAREST = dict(rounding="nearest")
HEADS = 4

# family: (port class, twin, geometry); the twin gives the shapes only
FAMILIES = {
    "llama": (LlamaDecoder, torch_llama,
              dict(vocab_size=211, max_len=32, dim=64, depth=2, heads=HEADS,
                   kv_heads=2, mlp_hidden=128)),
    "gemma": (GemmaDecoder, torch_gemma,
              dict(vocab_size=151, max_len=32, dim=64, depth=2, heads=HEADS,
                   kv_heads=2, mlp_hidden=128, sliding_window=8)),
    "gpt2": (TextDecoder, torch_text_decoder,
             dict(vocab_size=97, max_len=32, dim=64, depth=2, heads=HEADS)),
    "neox": (NeoXDecoder, torch_neox,
             dict(vocab_size=97, max_len=48, dim=64, depth=2, heads=HEADS)),
    "phi": (NeoXDecoder, torch_neox,
            dict(vocab_size=97, max_len=32, dim=64, depth=2, heads=HEADS,
                 rotary_pct=0.5)),
    "opt": (TextDecoder, torch_text_decoder,
            dict(vocab_size=101, max_len=32, dim=64, depth=2, heads=HEADS,
                 act="relu")),
    "bloom": (BloomDecoder, torch_bloom,
              dict(vocab_size=97, max_len=32, dim=64, depth=2, heads=HEADS)),
}
# families whose HF export has no head bias: the native twin's is zero
NO_HEAD_BIAS = ("gpt2", "neox", "opt", "bloom")

_LLAMA_TAILS = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
                "wv": "self_attn.v_proj", "proj": "self_attn.o_proj",
                "gate": "mlp.gate_proj", "up": "mlp.up_proj",
                "down": "mlp.down_proj", "ln1_": "input_layernorm",
                "ln2_": "post_attention_layernorm"}
_FUSED_TAILS = {"proj": "dense", "fc1_": "mlp.dense_h_to_4h",
                "fc2_": "mlp.dense_4h_to_h", "ln1_": "input_layernorm",
                "ln2_": "post_attention_layernorm"}
TAILS = {
    "llama": _LLAMA_TAILS,
    "gemma": dict(_LLAMA_TAILS, ln2_="pre_feedforward_layernorm",
                  postn1_="post_attention_layernorm",
                  postn2_="post_feedforward_layernorm"),
    "gpt2": {"ln1_": "ln_1", "ln2_": "ln_2", "proj": "attn.c_proj",
             "fc1_": "mlp.c_fc", "fc2_": "mlp.c_proj"},
    "neox": dict(_FUSED_TAILS, proj="attention.dense"),
    "bloom": dict(_FUSED_TAILS, proj="self_attention.dense"),
    "phi": {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
            "wv": "self_attn.v_proj", "proj": "self_attn.dense",
            "fc1_": "mlp.fc1", "fc2_": "mlp.fc2", "ln1_": "input_layernorm"},
    "opt": {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
            "wv": "self_attn.v_proj", "proj": "self_attn.out_proj",
            "fc1_": "fc1", "fc2_": "fc2", "ln1_": "self_attn_layer_norm",
            "ln2_": "final_layer_norm"},
}
PREFIX = {"llama": "model.layers.", "gemma": "model.layers.",
          "phi": "model.layers.", "gpt2": "transformer.h.",
          "neox": "gpt_neox.layers.", "opt": "model.decoder.layers.",
          "bloom": "transformer.h."}
TOP = {
    "llama": {"embed": "model.embed_tokens", "ln_f": "model.norm",
              "head": "lm_head"},
    "gemma": {"embed": "model.embed_tokens", "ln_f": "model.norm"},
    "gpt2": {"embed": "transformer.wte", "pe": "transformer.wpe",
             "ln_f": "transformer.ln_f", "head": "lm_head"},
    "neox": {"embed": "gpt_neox.embed_in",
             "ln_f": "gpt_neox.final_layer_norm", "head": "embed_out"},
    "phi": {"embed": "model.embed_tokens", "ln_f": "model.final_layernorm",
            "head": "lm_head"},
    "opt": {"embed": "model.decoder.embed_tokens",
            "ln_f": "model.decoder.final_layer_norm", "head": "lm_head"},
    "bloom": {"embed": "transformer.word_embeddings",
              "embed_ln": "transformer.word_embeddings_layernorm",
              "ln_f": "transformer.ln_f", "head": "lm_head"},
}
# derived buffers real exports carry, dropped on load
DERIVED = {"llama": ["self_attn.rotary_emb.inv_freq"],
           "gemma": ["self_attn.rotary_emb.inv_freq"],
           "phi": ["self_attn.rotary_emb.inv_freq"],
           "neox": ["attention.rotary_emb.inv_freq", "attention.bias",
                    "attention.masked_bias"],
           "gpt2": ["attn.bias", "attn.masked_bias"]}


def _ids(family, b, t, seed):
    return np.random.default_rng(seed).integers(
        0, FAMILIES[family][2]["vocab_size"], (b, t)).astype(np.int32)


def native(family, seed=0) -> dict:
    """Seeded numpy weights in the port's own names: N(0, 0.1), norm gains
    1 + N(0, 0.1) (gemma's unit-offset deltas N(0, 0.1)); the head bias is
    zero where the HF export has none, phi's ln2 is its ln1, gemma's head
    is its table."""
    _, twin, geo = FAMILIES[family]
    rng = np.random.default_rng(seed)
    out = {}
    for key, v in twin(**geo).state_dict().items():
        z = 0.1 * rng.standard_normal(tuple(v.shape), dtype=np.float32)
        gain = key.startswith(("ln", "postn", "embed_ln")) \
            and key.endswith("weight") and family != "gemma"
        out[key] = z + np.float32(1) if gain else z
    if family in NO_HEAD_BIAS:
        out["head.bias"] = np.zeros_like(out["head.bias"])
    if family == "phi":
        for i in (1, 2):
            for attr in ("weight", "bias"):
                out[f"ln2_{i}.{attr}"] = out[f"ln1_{i}.{attr}"].copy()
    if family == "gemma":
        out["head.weight"] = out["embed.weight"].copy()
    return out


def _interleave(q, k, v, heads):
    """NeoX's / BLOOM's fused layout: [H, 3, D] along the output axis."""
    parts = [a.reshape(heads, -1, *a.shape[1:]) for a in (q, k, v)]
    return np.stack(parts, axis=1).reshape(-1, *q.shape[1:])


def to_hf(family, nat, seed=1) -> dict:
    """``nat`` renamed and re-laid-out as the family's HF exporter writes
    it, with its derived buffers and (OPT) two leading position rows."""
    rng = np.random.default_rng(seed)
    out, fused = {}, {}
    for key, v in nat.items():
        name, attr = key.rsplit(".", 1)
        if key == "head.bias" and family in NO_HEAD_BIAS \
                or name == "head" and family == "gemma":
            continue             # a zero bias, or the tied head: not exported
        if name in TOP[family]:
            out[f"{TOP[family][name]}.{attr}"] = v
            continue
        if name == "pe" and family == "opt":
            pad = rng.standard_normal((2, v.shape[1]), dtype=np.float32)
            out["model.decoder.embed_positions.weight"] = np.concatenate(
                [pad, v])
            continue
        m = re.fullmatch(r"(wq|wk|wv|proj|gate|up|down|fc1_|fc2_|ln1_|ln2_|"
                         r"postn1_|postn2_)(\d+)", name)
        assert m, key
        kind, n = m.group(1), int(m.group(2)) - 1
        p = f"{PREFIX[family]}{n}."
        if kind in ("wq", "wk", "wv") and family in ("gpt2", "neox",
                                                    "bloom"):
            fused.setdefault((p, attr), {})[kind] = v
            continue
        if kind not in TAILS[family]:
            assert family == "phi" and kind == "ln2_", key
            continue             # phi's one norm: ln1 carries it
        tail = TAILS[family][kind]
        conv1d = (family == "gpt2" and attr == "weight"
                  and kind not in ("ln1_", "ln2_"))
        out[f"{p}{tail}.{attr}"] = v.T if conv1d else v
    for (p, attr), qkv in fused.items():
        q, k, v = qkv["wq"], qkv["wk"], qkv["wv"]
        if family == "gpt2":
            # Conv1D [in, 3 * dim]: q | k | v along OUT
            out[f"{p}attn.c_attn.{attr}"] = (
                np.concatenate([q.T, k.T, v.T], axis=1) if attr == "weight"
                else np.concatenate([q, k, v]))
        else:
            tail = ("attention" if family == "neox" else "self_attention")
            out[f"{p}{tail}.query_key_value.{attr}"] = _interleave(
                q, k, v, HEADS)
    for tail in DERIVED.get(family, []):
        out[f"{PREFIX[family]}0.{tail}"] = np.ones((8,), np.float32)
    return out


def _arr(v) -> np.ndarray:
    return v.detach().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _as_torch(d: dict) -> dict:
    """The dict as ``torch.load`` would give it: CPU tensors."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items()}


def _model(family, **kw):
    cls, _, geo = FAMILIES[family]
    return cls(**geo, config=qt.QuantConfig(**NEAREST), device="cpu", **kw)


def _fp32_params(model) -> dict:
    return {f"{name}.{attr}": getattr(layer, attr)
            for name, layer in model.named_layers()
            for attr in ("weight", "bias")
            if isinstance(getattr(layer, attr, None), torch.Tensor)}


@pytest.mark.parametrize("kind", ["numpy", "torch"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_from_hf_equals_jax(family, kind):
    d = to_hf(family, native(family))
    if kind == "torch":
        d = _as_torch(d)
    assert hf.detect(d.keys()) == jhf.detect(d.keys()) == family
    got = hf.from_hf(d, n_heads=HEADS)
    want = jhf.from_hf(d, n_heads=HEADS)
    assert list(got) == list(want)
    for key in want:
        a, b = _arr(got[key]), _arr(want[key])
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, key
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), key


@pytest.mark.parametrize("kind", ["numpy", "torch"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_hf_load_equals_native(family, kind):
    """``Module.load`` of the HF dict: every FP32 weight and the logits of
    the natively named load, bit for bit."""
    nat = native(family)
    d = to_hf(family, nat)
    m_nat, m_hf = _model(family), _model(family)
    m_nat.load(nat)
    m_hf.load(_as_torch(d) if kind == "torch" else d)
    want, got = _fp32_params(m_nat), _fp32_params(m_hf)
    assert list(got) == list(want)
    for key, v in want.items():
        assert torch.equal(got[key], v), key
    x = qt.tensor(_ids(family, 2, 12, 2), device="cpu")
    assert torch.equal(m_hf(x).data, m_nat(x).data)


def test_setters_take_views():
    """Transposed and split torch views load as their values."""
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.standard_normal((6, 9), dtype=np.float32))
    lin = qt.Linear(6, 3, device="cpu")
    lin.load_weight(w.t()[:3])
    assert lin.weight.is_contiguous() and torch.equal(lin.weight, w.t()[:3])
    lin.load_bias(w[1, ::3])
    assert torch.equal(lin.bias, w[1, ::3])
    lin.load_weight(np.asarray(w).T[3:6])
    assert torch.equal(lin.weight, w.t()[3:6])


def test_tied_head_stays_tied_only_in_what_is_loaded():
    """A tied export (no ``lm_head.weight``) loads the table as the head;
    calibrated and converted, the model's codes equal a natively loaded
    copy's whose head is a copy of the table: the head quantizes on its
    own."""
    nat = native("llama")
    d = to_hf("llama", nat)
    del d["lm_head.weight"]
    tied = _model("llama")
    tied.load(d)
    assert torch.equal(tied.head.weight, torch.from_numpy(
        nat["embed.weight"]))
    copy = dict(nat, **{"head.weight": nat["embed.weight"].copy()})
    ref = _model("llama")
    ref.load(copy)
    calib, x = _ids("llama", 2, 16, 3), _ids("llama", 2, 12, 4)
    for m in (tied, ref):
        m.prepare()
        m(qt.tensor(calib, device="cpu"))
        m.convert()
    assert tied.head.weight_scale == ref.head.weight_scale
    assert torch.equal(tied(qt.tensor(x, device="cpu")).data,
                       ref(qt.tensor(x, device="cpu")).data)


def test_detect_and_errors():
    cases = [["model.layers.0.self_attn.q_proj.weight"],
             ["transformer.wte.weight"], ["wq1.weight", "embed.weight"],
             ["embed_out.weight"], ["decoder.embed_tokens.weight"],
             ["model.layers.0.pre_feedforward_layernorm.weight"],
             ["model.layers.0.self_attn.dense.weight"],
             ["transformer.word_embeddings_layernorm.bias"],
             ["gpt_neox.layers.3.attention.dense.weight"], []]
    assert [hf.detect(k) for k in cases] == [jhf.detect(k) for k in cases]
    assert hf.detect(cases[0]) == "llama" and hf.detect(cases[1]) == "gpt2"
    assert hf.detect(cases[2]) is None
    bad = {"model.layers.0.self_attn.zzz.weight": np.zeros((2, 2),
                                                           np.float32)}
    for fn in (hf.from_hf, jhf.from_hf):
        with pytest.raises(KeyError):
            fn(bad)
        with pytest.raises(ValueError):
            fn({"wq1.weight": np.zeros((2, 2), np.float32)})


@pytest.mark.parametrize("family", list(FAMILIES))
def test_unknown_key_raises(family):
    """A key the family does not have raises ``KeyError`` in both packages
    and through ``Module.load``: nothing is dropped silently."""
    d = to_hf(family, native(family))
    d[f"{PREFIX[family]}1.mlp.extra_proj.weight"] = np.zeros(
        (2, 2), np.float32)
    for fn in (hf.from_hf, jhf.from_hf):
        with pytest.raises(KeyError, match="extra_proj"):
            fn(d, n_heads=HEADS)
    with pytest.raises(KeyError, match="extra_proj"):
        _model(family).load(d)


@pytest.mark.parametrize("family", ["neox", "bloom"])
def test_fused_qkv_needs_n_heads(family):
    d = to_hf(family, native(family))
    for fn in (hf.from_hf, jhf.from_hf):
        with pytest.raises(ValueError, match="n_heads"):
            fn(d)


def test_native_dicts_pass_through_unchanged():
    d = {"wq1.weight": np.zeros((4, 4), np.float32)}
    assert hf.maybe_from_hf(d) is d


def test_llama_hf_qkv_biases_qwen_style():
    """qwen2-style exports are llama-arch with qkv biases: they load into
    the (zero-initialized) Linear biases."""
    d = to_hf("llama", native("llama"))
    bq = np.random.default_rng(5).normal(scale=0.05, size=(64,)).astype(
        np.float32)
    d["model.layers.0.self_attn.q_proj.bias"] = bq
    m = _model("llama")
    m.load(d)
    assert torch.equal(m.wq1.bias, torch.from_numpy(bq))
    assert not m.wq2.bias.any()


# one config.json per model_type (published key names; tiny values)
CONFIGS = {
    "llama": {"model_type": "llama", "vocab_size": 211,
              "max_position_embeddings": 32, "hidden_size": 64,
              "num_hidden_layers": 2, "num_attention_heads": 4,
              "num_key_value_heads": 2, "intermediate_size": 128,
              "rope_theta": 500000.0, "rms_norm_eps": 1e-5},
    "mistral": {"model_type": "mistral", "vocab_size": 211,
                "max_position_embeddings": 32, "hidden_size": 64,
                "num_hidden_layers": 2, "num_attention_heads": 4,
                "num_key_value_heads": 2, "intermediate_size": 128,
                "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
                "sliding_window": 8},
    "qwen2": {"model_type": "qwen2", "vocab_size": 97,
              "max_position_embeddings": 32, "hidden_size": 64,
              "num_hidden_layers": 1, "num_attention_heads": 4,
              "num_key_value_heads": 2, "intermediate_size": 128,
              "use_sliding_window": True, "sliding_window": 8},
    "phi": {"model_type": "phi", "vocab_size": 51200, "hidden_size": 2048,
            "num_hidden_layers": 24, "num_attention_heads": 32,
            "partial_rotary_factor": 0.5, "rope_theta": 10000.0,
            "max_position_embeddings": 2048, "layer_norm_eps": 1e-5,
            "intermediate_size": 8192},
    "bloom": {"model_type": "bloom", "vocab_size": 1000, "hidden_size": 128,
              "n_layer": 2, "n_head": 4, "layer_norm_epsilon": 1e-5},
    "opt": {"model_type": "opt", "vocab_size": 101,
            "max_position_embeddings": 32, "hidden_size": 64,
            "num_hidden_layers": 2, "num_attention_heads": 4,
            "ffn_dim": 256, "activation_function": "relu",
            "do_layer_norm_before": True},
    "gpt2": {"model_type": "gpt2", "n_embd": 64, "n_layer": 2, "n_head": 4,
             "n_positions": 32, "vocab_size": 97},
    "gpt_neox": {"model_type": "gpt_neox", "hidden_size": 64,
                 "num_hidden_layers": 2, "num_attention_heads": 4,
                 "rotary_pct": 0.25, "rotary_emb_base": 10000,
                 "use_parallel_residual": True, "vocab_size": 97,
                 "max_position_embeddings": 48, "layer_norm_eps": 1e-5},
    "gemma2": {"model_type": "gemma2", "hidden_size": 64,
               "num_hidden_layers": 2, "num_attention_heads": 4,
               "num_key_value_heads": 2, "head_dim": 16,
               "intermediate_size": 128, "rope_theta": 10000.0,
               "sliding_window": 8, "attn_logit_softcapping": 50.0,
               "final_logit_softcapping": 30.0, "vocab_size": 151,
               "max_position_embeddings": 32, "rms_norm_eps": 1e-6},
}


@pytest.mark.parametrize("model_type", list(CONFIGS))
def test_from_hf_config_equals_jax(model_type):
    cfg = CONFIGS[model_type]
    cls, kw = hf.from_hf_config(cfg)
    jcls, jkw = jhf.from_hf_config(cfg)
    assert cls.__name__ == jcls.__name__ and kw == jkw
    assert cls.__module__.startswith("int8inferenceengine_tpu_torch.")


@pytest.mark.parametrize("bad", [
    {}, {"model_type": "mamba"},
    dict(CONFIGS["opt"], word_embed_proj_dim=32),
    dict(CONFIGS["opt"], do_layer_norm_before=False)])
def test_from_hf_config_refusals_equal_jax(bad):
    for fn in (hf.from_hf_config, jhf.from_hf_config):
        with pytest.raises(ValueError):
            fn(bad)


def test_mistral_null_window_and_qwen2_gate():
    """Newer mistral configs ship sliding_window: null (global attention);
    qwen2 windows only under use_sliding_window."""
    base = {k: v for k, v in CONFIGS["qwen2"].items()
            if k not in ("model_type", "use_sliding_window")}
    for cfg, want in [({"model_type": "mistral", **base,
                        "sliding_window": None}, None),
                      ({"model_type": "qwen2", **base}, None),
                      ({"model_type": "qwen2", "use_sliding_window": True,
                        **base}, 8)]:
        assert hf.from_hf_config(cfg)[1]["sliding_window"] == want
        assert jhf.from_hf_config(cfg)[1]["sliding_window"] == want


def test_build_from_hf_reads_what_the_weights_cannot_show():
    """The built models carry the config's window, softcaps, head_dim and
    rotary share; a mistral loaded onto a plain llama attends globally
    and gives other logits on a prompt longer than the window."""
    g = hf.build_from_hf(CONFIGS["gemma2"], device="cpu")
    assert (g.sliding_window, g.head_dim) == (8, 16)
    assert (g.attn_softcap, g.final_softcap) == (50.0, 30.0)
    n = hf.build_from_hf(CONFIGS["gpt_neox"], device="cpu")
    assert n.rq1.rotary_dim == 4
    d = to_hf("llama", native("llama"))
    m = hf.build_from_hf(CONFIGS["mistral"], d, device="cpu")
    assert m.sliding_window == 8
    glob = _model("llama")
    glob.load(d)
    x = qt.tensor(_ids("llama", 2, 24, 6), device="cpu")
    assert float((m(x).data - glob(x).data).abs().max()) > 1e-3


def test_mistral_tiny_registry():
    m = tzoo.build("mistral_tiny", config=qt.QuantConfig(**NEAREST),
                   device="cpu")
    tw = tzoo.torch_twin("mistral_tiny")
    m.load(tw.state_dict())
    assert m.sliding_window == 16
    x = np.random.default_rng(4).integers(0, 1000, (1, 32)).astype(np.int32)
    with torch.no_grad():
        ref = tw(torch.tensor(x.astype(np.int64))).numpy()
    out = m(qt.tensor(x, device="cpu")).numpy().reshape(1, 32, -1)
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


def test_opt_hf_config_load_and_decode():
    """OPT through ``build_from_hf``: the offset-2 positions sliced, the
    relu block; cached ``generate`` equals the full recompute."""
    nat = native("opt")
    m = hf.build_from_hf(CONFIGS["opt"], to_hf("opt", nat),
                         config=qt.QuantConfig(**NEAREST), device="cpu")
    assert m.act == "relu" and m.mlp_hidden == 256
    assert torch.equal(m.pe.weight, torch.from_numpy(nat["pe.weight"]))
    m.prepare()
    m(qt.tensor(_ids("opt", 2, 16, 10), device="cpu"))
    m.convert()
    ids = _ids("opt", 2, 5, 11)
    gen = m.generate(ids, 6)
    seq = ids.copy()
    for _ in range(6):
        codes = m(qt.tensor(seq, device="cpu")).data.numpy().reshape(
            seq.shape[0], seq.shape[1], -1)
        seq = np.concatenate([seq, codes[:, -1].argmax(-1).astype(
            np.int32)[:, None]], 1)
    assert (gen == seq[:, 5:]).all()


def _write(d, form, state, cfg):
    """An HF checkpoint directory: config.json and the weights as one
    safetensors file, a sharded set with its index, or a torch pickle."""
    d.mkdir(parents=True, exist_ok=True)
    (d / "config.json").write_text(json.dumps(cfg))
    if form == "single":
        save_file(state, str(d / "model.safetensors"))
    elif form == "sharded":
        keys = sorted(state)
        shards = {"model-00001-of-00002.safetensors": keys[::2],
                  "model-00002-of-00002.safetensors": keys[1::2]}
        for name, ks in shards.items():
            save_file({k: state[k] for k in ks}, str(d / name))
        (d / "model.safetensors.index.json").write_text(json.dumps(
            {"weight_map": {k: n for n, ks in shards.items() for k in ks}}))
    else:
        torch.save(_as_torch(state), str(d / f"pytorch_model.{form}"))
    return d


def _mistral_dir(tmp_path, form):
    nat = native("llama")
    return nat, _write(tmp_path / form, form, to_hf("llama", nat),
                       CONFIGS["mistral"])


@pytest.mark.parametrize("form", ["single", "sharded", "bin", "pt"])
def test_load_pretrained_forms(tmp_path, form):
    """Every file form gives the natively loaded model's logits bit for
    bit."""
    nat, d = _mistral_dir(tmp_path, form)
    m = hf.load_pretrained(d, config=qt.QuantConfig(**NEAREST), device="cpu")
    assert isinstance(m, LlamaDecoder) and m.sliding_window == 8
    ref = _model("llama", sliding_window=8)
    ref.load(nat)
    x = qt.tensor(_ids("llama", 2, 16, 12), device="cpu")
    assert torch.equal(m(x).data, ref(x).data)


def test_load_pretrained_overrides_and_missing(tmp_path):
    _, d = _mistral_dir(tmp_path, "single")
    m = hf.load_pretrained(d, config=qt.QuantConfig(), device="cpu",
                           max_len=16, sliding_window=4)
    assert (m.max_len, m.sliding_window) == (16, 4)
    for fn in (hf.load_pretrained, jhf.load_pretrained):
        with pytest.raises(FileNotFoundError):
            fn(tmp_path / "nope")
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "config.json").write_text(json.dumps(CONFIGS["mistral"]))
    for fn in (hf.load_pretrained, jhf.load_pretrained):
        with pytest.raises(FileNotFoundError):
            fn(empty)


def test_load_pretrained_builds_on_the_card(tmp_path, monkeypatch):
    """With no ``device`` the model is built on the card; without one it
    raises, as every entry point of the port does."""
    _, d = _mistral_dir(tmp_path, "single")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hf.load_pretrained(d)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hf.build_from_hf(CONFIGS["mistral"])


def _bf16_dir(tmp_path, form):
    """The llama leg's HF dict rounded to bfloat16, as one safetensors file
    or a torch pickle."""
    d = tmp_path / form
    d.mkdir()
    (d / "config.json").write_text(json.dumps(CONFIGS["mistral"]))
    state = {k: v.to(torch.bfloat16) for k, v in _as_torch(
        to_hf("llama", native("llama"))).items()}
    if form == "single":
        from safetensors.torch import save_file as save_torch
        save_torch(state, str(d / "model.safetensors"))
    else:
        torch.save(state, str(d / "pytorch_model.bin"))
    return d, state


def test_bfloat16_safetensors_read_like_jax(tmp_path):
    """The JAX package reads a bfloat16 safetensors file (jax registers
    ml_dtypes' bfloat16 with numpy, which safetensors' numpy reader then
    uses); the port reads it too, through torch's reader, widened exactly
    to float32: the same weights, bit for bit."""
    d, state = _bf16_dir(tmp_path, "single")
    m = hf.load_pretrained(d, device="cpu")
    jm = jhf.load_pretrained(d)
    assert torch.equal(m.wq1.weight, state[
        "model.layers.0.self_attn.q_proj.weight"].float())
    for name, layer in jm.named_layers():
        for attr, v in layer.params.items():
            np.testing.assert_array_equal(
                getattr(getattr(m, name), attr).numpy(), np.asarray(v))


def test_bfloat16_pickle_refused_like_jax(tmp_path):
    """A bfloat16 ``pytorch_model.bin`` raises ``TypeError`` in both
    packages: numpy has no bfloat16 for ``Tensor.numpy()``."""
    d, _ = _bf16_dir(tmp_path, "bin")
    with pytest.raises(TypeError):
        hf.load_pretrained(d, device="cpu")
    with pytest.raises(TypeError):
        jhf.load_pretrained(d)


# the three families held against the JAX package's HF-loaded model:
# (model_type, weight-name family, config, file form)
JAX_LEGS = {
    "gemma2": ("gemma", CONFIGS["gemma2"], "sharded"),
    "gpt_neox": ("neox", CONFIGS["gpt_neox"], "bin"),
    "mistral": ("llama", CONFIGS["mistral"], "single"),
}


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """Per leg: its directory, the JAX model's FP32 logits on the
    calibration ids (its calibration forward), its converted state and
    its INT8 codes."""
    out = {}
    for mt, (family, cfg, form) in JAX_LEGS.items():
        d = _write(tmp_path_factory.mktemp(mt), form,
                   to_hf(family, native(family)), cfg)
        calib, x = _ids(family, 2, 16, 20), _ids(family, 3, 16, 21)
        jm = jhf.load_pretrained(d, config=qj.QuantConfig(**NEAREST))
        jm.prepare()
        fp32 = np.asarray(jm(qj.tensor(calib)).data)
        jm.convert()
        out[mt] = dict(dir=d, calib=calib, x=x, fp32=fp32,
                       state=jax_state(jm),
                       codes=np.asarray(jm(qj.tensor(x)).data))
    return out


@pytest.mark.parametrize("mt", list(JAX_LEGS))
def test_fp32_logits_equal_jax(jax_ref, mt):
    ref = jax_ref[mt]
    m = hf.load_pretrained(ref["dir"], config=qt.QuantConfig(**NEAREST),
                           device="cpu")
    got = m(qt.tensor(ref["calib"], device="cpu")).numpy()
    assert got.shape == ref["fp32"].shape
    np.testing.assert_allclose(got, ref["fp32"], rtol=0,
                               atol=1e-5 * np.abs(ref["fp32"]).max())


@pytest.mark.parametrize("mt", list(JAX_LEGS))
def test_int8_codes_equal_jax(jax_ref, mt):
    ref = jax_ref[mt]
    cfg = JAX_LEGS[mt][1]
    m = hf.build_from_hf(cfg, config=qt.QuantConfig(**NEAREST), device="cpu")
    load_jax_state(m, ref["state"])
    got = m(qt.tensor(ref["x"], device="cpu")).data.numpy()
    want = ref["codes"]
    assert got.shape == want.shape and len(np.unique(want)) > 32
    steps = np.abs(got.astype(np.int32) - want.astype(np.int32))
    if mt == "gpt_neox":
        assert steps.max() <= 2 and (steps == 0).mean() >= 0.99
    else:
        assert steps.max() == 0
