"""Hugging Face checkpoints: name adaptation and directory ingest
(counterpart of ``int8inferenceengine_tpu.utils.hf``).

The engine's core workflow is ingesting somebody else's trained torch
checkpoint.  The decoder families here name their layers their own way
(``wq{i}``, ``gate{i}``, ... — ``models/llama.py``,
``models/text_decoder.py``), so an HF-exported state dict
(``model.layers.0.self_attn.q_proj.weight``) needs a name adapter:

* :func:`detect` sniffs the naming family from the key set: llama,
  gemma, gpt2, neox, phi, opt or bloom;
* :func:`from_hf` returns an equivalent state dict in this package's
  names, with the differences that are not names:
    - the ``model.`` / ``transformer.`` / ``gpt_neox.`` prefixes are
      optional; derived buffers (``rotary_emb.inv_freq``, gpt2's and
      NeoX's ``attn.bias`` / ``masked_bias`` causal masks) are dropped;
    - gpt2's Conv1D weights are stored transposed ([in, out]), and its
      fused ``c_attn`` splits into wq/wk/wv along OUT before the
      transpose;
    - NeoX's and BLOOM's fused ``query_key_value`` is interleaved per
      head ([H, 3, D]), so the split needs ``n_heads``;
    - phi's one LayerNorm a block loads into both ``ln1_i`` and ``ln2_i``;
    - OPT's learned positions are offset by 2: rows 0 and 1 are sliced off;
    - without ``lm_head.weight`` the head is tied to the token table;
    - gemma's norm gains are offsets from 1 and load unchanged (the block
      applies ``1 + w``);
  an unknown key raises ``KeyError``: nothing is dropped silently;
* ``Module.load`` calls :func:`maybe_from_hf`, so an HF state dict loads
  directly; keys already in this package's names pass through unchanged;
* :func:`from_hf_config` maps a ``config.json`` to the family's class and
  its keyword arguments (mistral's window, gemma-2's softcaps and
  ``head_dim``, NeoX's ``rotary_pct`` live only there);
  :func:`build_from_hf` and :func:`load_pretrained` build the model and
  load the weights in one call.

Values may be numpy arrays or CPU torch tensors (``torch.load``'s);
what is transposed or split comes back as a numpy view of the same bits,
and the rest as it came.  Blocks are 1-based here: ``wq1`` is HF layer 0.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

__all__ = ["detect", "from_hf", "maybe_from_hf", "from_hf_config",
           "build_from_hf", "load_pretrained"]


def _np(v) -> np.ndarray:
    """A numpy view of an array or a CPU torch tensor (no copy)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _t(v) -> np.ndarray:
    """Transpose a gpt2 Conv1D weight ([in, out] -> Linear's [out, in])."""
    return _np(v).T


def _split3(v, axis: int) -> list:
    """Split a fused-QKV tensor into thirds along ``axis``."""
    n = v.shape[axis]
    if n % 3:
        raise ValueError(f"fused c_attn dim {n} not divisible by 3")
    return np.split(_np(v), 3, axis=axis)


def _split_qkv_interleaved(v, n_heads: int, axis: int) -> list:
    """De-interleave a NeoX/BLOOM fused qkv tensor, whose fused axis is
    laid out [H, 3, D] (per-head q, k, v triples).  Returns [q, k, v]."""
    arr = _np(v)
    n = arr.shape[axis]
    if n % (3 * n_heads):
        raise ValueError(
            f"fused query_key_value dim {n} not divisible by "
            f"3 * n_heads ({n_heads})")
    d = n // (3 * n_heads)
    shp = list(arr.shape)
    shp[axis:axis + 1] = [n_heads, 3, d]
    a4 = arr.reshape(shp)
    parts = []
    for j in range(3):
        pj = np.take(a4, j, axis=axis + 1)             # [.., H, D, ..]
        shp2 = list(pj.shape)
        shp2[axis:axis + 2] = [n_heads * d]
        parts.append(pj.reshape(shp2))
    return parts


_LLAMA_PAT = re.compile(r"^(?:model\.)?layers\.(\d+)\.")
_GPT2_PAT = re.compile(r"^(?:transformer\.)?h\.(\d+)\.")
_NEOX_PAT = re.compile(r"^(?:gpt_neox\.)?layers\.(\d+)\.")
_OPT_PAT = re.compile(r"^(?:model\.)?decoder\.layers\.(\d+)\.")
_BLOOM_PAT = re.compile(r"^(?:transformer\.)?h\.(\d+)\.(?=self_attention|"
                        r"input_layernorm|post_attention_layernorm|mlp)")

# per-block llama tails -> this package's layer names (1-based {i})
_LLAMA_BLOCK = {
    "input_layernorm.weight": "ln1_{i}.weight",
    "self_attn.q_proj.weight": "wq{i}.weight",
    "self_attn.k_proj.weight": "wk{i}.weight",
    "self_attn.v_proj.weight": "wv{i}.weight",
    "self_attn.o_proj.weight": "proj{i}.weight",
    "post_attention_layernorm.weight": "ln2_{i}.weight",
    "mlp.gate_proj.weight": "gate{i}.weight",
    "mlp.up_proj.weight": "up{i}.weight",
    "mlp.down_proj.weight": "down{i}.weight",
    # qkv/o biases of some llama-arch exports (qwen2)
    "self_attn.q_proj.bias": "wq{i}.bias",
    "self_attn.k_proj.bias": "wk{i}.bias",
    "self_attn.v_proj.bias": "wv{i}.bias",
    "self_attn.o_proj.bias": "proj{i}.bias",
}

# gemma-2 block tails: llama's attention and MLP names, but four norms:
# post_attention_layernorm is the sandwich norm (postn1), not llama's
# pre-MLP norm (ln2 = pre_feedforward_layernorm here)
_GEMMA_BLOCK = {
    "input_layernorm.weight": "ln1_{i}.weight",
    "self_attn.q_proj.weight": "wq{i}.weight",
    "self_attn.k_proj.weight": "wk{i}.weight",
    "self_attn.v_proj.weight": "wv{i}.weight",
    "self_attn.o_proj.weight": "proj{i}.weight",
    "post_attention_layernorm.weight": "postn1_{i}.weight",
    "pre_feedforward_layernorm.weight": "ln2_{i}.weight",
    "post_feedforward_layernorm.weight": "postn2_{i}.weight",
    "mlp.gate_proj.weight": "gate{i}.weight",
    "mlp.up_proj.weight": "up{i}.weight",
    "mlp.down_proj.weight": "down{i}.weight",
}

_LLAMA_TOP = {
    "model.embed_tokens.weight": "embed.weight",
    "embed_tokens.weight": "embed.weight",
    "model.norm.weight": "ln_f.weight",
    "norm.weight": "ln_f.weight",
    "lm_head.weight": "head.weight",
}

# gpt2 per-block tails (Conv1D weights transpose; c_attn splits)
_GPT2_BLOCK_DIRECT = {
    "ln_1.weight": "ln1_{i}.weight",
    "ln_1.bias": "ln1_{i}.bias",
    "ln_2.weight": "ln2_{i}.weight",
    "ln_2.bias": "ln2_{i}.bias",
}
_GPT2_BLOCK_CONV1D = {
    "attn.c_proj.weight": "proj{i}.weight",
    "mlp.c_fc.weight": "fc1_{i}.weight",
    "mlp.c_proj.weight": "fc2_{i}.weight",
}
_GPT2_BLOCK_BIAS = {
    "attn.c_proj.bias": "proj{i}.bias",
    "mlp.c_fc.bias": "fc1_{i}.bias",
    "mlp.c_proj.bias": "fc2_{i}.bias",
}
_GPT2_TOP = {
    "wte.weight": "embed.weight",
    "transformer.wte.weight": "embed.weight",
    "wpe.weight": "pe.weight",
    "transformer.wpe.weight": "pe.weight",
    "ln_f.weight": "ln_f.weight",
    "ln_f.bias": "ln_f.bias",
    "transformer.ln_f.weight": "ln_f.weight",
    "transformer.ln_f.bias": "ln_f.bias",
    "lm_head.weight": "head.weight",
}

# gpt_neox per-block tails; the fused query_key_value is split apart
_NEOX_BLOCK = {
    "input_layernorm.weight": "ln1_{i}.weight",
    "input_layernorm.bias": "ln1_{i}.bias",
    "post_attention_layernorm.weight": "ln2_{i}.weight",
    "post_attention_layernorm.bias": "ln2_{i}.bias",
    "attention.dense.weight": "proj{i}.weight",
    "attention.dense.bias": "proj{i}.bias",
    "mlp.dense_h_to_4h.weight": "fc1_{i}.weight",
    "mlp.dense_h_to_4h.bias": "fc1_{i}.bias",
    "mlp.dense_4h_to_h.weight": "fc2_{i}.weight",
    "mlp.dense_4h_to_h.bias": "fc2_{i}.bias",
}
_NEOX_TOP = {
    "gpt_neox.embed_in.weight": "embed.weight",
    "embed_in.weight": "embed.weight",
    "gpt_neox.final_layer_norm.weight": "ln_f.weight",
    "gpt_neox.final_layer_norm.bias": "ln_f.bias",
    "final_layer_norm.weight": "ln_f.weight",
    "final_layer_norm.bias": "ln_f.bias",
    "embed_out.weight": "head.weight",
}

# phi (microsoft/phi-1, 1.5, 2): the NeoX topology (parallel residual,
# partial rotary, biased LayerNorm MHA + gelu MLP) with llama-style q/k/v
# names and ONE LayerNorm a block, which feeds both branches: it loads into
# ln1_{i} AND ln2_{i} (the same function on NeoXDecoder's two-norm block)
_PHI_BLOCK = {
    "self_attn.q_proj.weight": ("wq{i}.weight",),
    "self_attn.q_proj.bias": ("wq{i}.bias",),
    "self_attn.k_proj.weight": ("wk{i}.weight",),
    "self_attn.k_proj.bias": ("wk{i}.bias",),
    "self_attn.v_proj.weight": ("wv{i}.weight",),
    "self_attn.v_proj.bias": ("wv{i}.bias",),
    "self_attn.dense.weight": ("proj{i}.weight",),
    "self_attn.dense.bias": ("proj{i}.bias",),
    "input_layernorm.weight": ("ln1_{i}.weight", "ln2_{i}.weight"),
    "input_layernorm.bias": ("ln1_{i}.bias", "ln2_{i}.bias"),
    "mlp.fc1.weight": ("fc1_{i}.weight",),
    "mlp.fc1.bias": ("fc1_{i}.bias",),
    "mlp.fc2.weight": ("fc2_{i}.weight",),
    "mlp.fc2.bias": ("fc2_{i}.bias",),
}
_PHI_TOP = {
    "model.embed_tokens.weight": "embed.weight",
    "model.final_layernorm.weight": "ln_f.weight",
    "model.final_layernorm.bias": "ln_f.bias",
    "final_layernorm.weight": "ln_f.weight",
    "final_layernorm.bias": "ln_f.bias",
    "lm_head.weight": "head.weight",
    "lm_head.bias": "head.bias",
}

# OPT (facebook/opt-*): pre-LN MHA + ReLU MLP; self_attn_layer_norm is the
# pre-attention norm, the block's final_layer_norm the pre-MLP one
_OPT_BLOCK = {
    "self_attn_layer_norm.weight": "ln1_{i}.weight",
    "self_attn_layer_norm.bias": "ln1_{i}.bias",
    "self_attn.q_proj.weight": "wq{i}.weight",
    "self_attn.q_proj.bias": "wq{i}.bias",
    "self_attn.k_proj.weight": "wk{i}.weight",
    "self_attn.k_proj.bias": "wk{i}.bias",
    "self_attn.v_proj.weight": "wv{i}.weight",
    "self_attn.v_proj.bias": "wv{i}.bias",
    "self_attn.out_proj.weight": "proj{i}.weight",
    "self_attn.out_proj.bias": "proj{i}.bias",
    "final_layer_norm.weight": "ln2_{i}.weight",
    "final_layer_norm.bias": "ln2_{i}.bias",
    "fc1.weight": "fc1_{i}.weight",
    "fc1.bias": "fc1_{i}.bias",
    "fc2.weight": "fc2_{i}.weight",
    "fc2.bias": "fc2_{i}.bias",
}
_OPT_TOP = {
    "model.decoder.embed_tokens.weight": "embed.weight",
    "decoder.embed_tokens.weight": "embed.weight",
    "model.decoder.final_layer_norm.weight": "ln_f.weight",
    "model.decoder.final_layer_norm.bias": "ln_f.bias",
    "decoder.final_layer_norm.weight": "ln_f.weight",
    "decoder.final_layer_norm.bias": "ln_f.bias",
    "lm_head.weight": "head.weight",
}
_OPT_POS = ("model.decoder.embed_positions.weight",
            "decoder.embed_positions.weight")

# BLOOM: the gpt block with no positions (ALiBi) and NeoX's per-head
# interleaved fused query_key_value
_BLOOM_BLOCK = {
    "input_layernorm.weight": "ln1_{i}.weight",
    "input_layernorm.bias": "ln1_{i}.bias",
    "post_attention_layernorm.weight": "ln2_{i}.weight",
    "post_attention_layernorm.bias": "ln2_{i}.bias",
    "self_attention.dense.weight": "proj{i}.weight",
    "self_attention.dense.bias": "proj{i}.bias",
    "mlp.dense_h_to_4h.weight": "fc1_{i}.weight",
    "mlp.dense_h_to_4h.bias": "fc1_{i}.bias",
    "mlp.dense_4h_to_h.weight": "fc2_{i}.weight",
    "mlp.dense_4h_to_h.bias": "fc2_{i}.bias",
}
_BLOOM_TOP = {
    "transformer.word_embeddings.weight": "embed.weight",
    "word_embeddings.weight": "embed.weight",
    "transformer.word_embeddings_layernorm.weight": "embed_ln.weight",
    "transformer.word_embeddings_layernorm.bias": "embed_ln.bias",
    "word_embeddings_layernorm.weight": "embed_ln.weight",
    "word_embeddings_layernorm.bias": "embed_ln.bias",
    "transformer.ln_f.weight": "ln_f.weight",
    "transformer.ln_f.bias": "ln_f.bias",
    "lm_head.weight": "head.weight",
}

# each family: (top-level map, block prefix, block map, fused-qkv tail
# prefix (per-head interleaved), derived buffers' tails: a name ending in
# "." is a prefix); any other family name is read as gpt2
_FAMILIES = {
    "llama": (_LLAMA_TOP, _LLAMA_PAT, _LLAMA_BLOCK, None,
              ("self_attn.rotary_emb.",)),
    # gemma: its own map first, then llama's (qkv biases)
    "gemma": (_LLAMA_TOP, _LLAMA_PAT, {**_LLAMA_BLOCK, **_GEMMA_BLOCK},
              None, ("self_attn.rotary_emb.",)),
    "phi": (_PHI_TOP, _LLAMA_PAT, _PHI_BLOCK, None,
            ("self_attn.rotary_emb.",)),
    "opt": (_OPT_TOP, _OPT_PAT, _OPT_BLOCK, None, ()),
    "neox": (_NEOX_TOP, _NEOX_PAT, _NEOX_BLOCK, "attention.query_key_value.",
             ("attention.rotary_emb.", "attention.bias",
              "attention.masked_bias")),
    "bloom": (_BLOOM_TOP, _BLOOM_PAT, _BLOOM_BLOCK,
              "self_attention.query_key_value.", ()),
    "gpt2": (_GPT2_TOP, _GPT2_PAT,
             {**_GPT2_BLOCK_DIRECT, **_GPT2_BLOCK_BIAS}, None,
             ("attn.bias", "attn.masked_bias")),
}
_FUSED_NAME = {"neox": "NeoX", "bloom": "BLOOM"}


def detect(keys) -> str | None:
    """The naming family of an HF-exported key set ('gemma', 'bloom',
    'phi', 'opt', 'neox', 'llama' or 'gpt2'), else None (this package's
    own names pass through untouched).  gemma is llama-named except for its
    four-norm blocks: ``pre_feedforward_layernorm`` tells them apart."""
    keys = list(keys)
    if any("pre_feedforward_layernorm" in k for k in keys):
        return "gemma"
    if any("word_embeddings_layernorm" in k for k in keys):
        return "bloom"
    if any(".self_attn.dense." in k or "final_layernorm" in k
           for k in keys):
        return "phi"              # llama-like names, dense / one-LN block
    if any(_OPT_PAT.match(k) for k in keys) \
            or any(k in _OPT_TOP or k in _OPT_POS for k in keys
                   if "decoder." in k):
        return "opt"
    if any(_NEOX_PAT.match(k) and ".attention." in k for k in keys) \
            or any(k in _NEOX_TOP for k in keys):
        return "neox"
    for k in keys:
        if _LLAMA_PAT.match(k) or k in ("model.embed_tokens.weight",
                                        "embed_tokens.weight"):
            return "llama"
        if _GPT2_PAT.match(k) or k in ("transformer.wte.weight",
                                       "wte.weight"):
            return "gpt2"
    return None


def _block_entries(arch: str, tail: str, v, n_heads):
    """[(name format, value)] of one block tail (empty for a derived
    buffer), or None for a tail the family does not have."""
    _, _, block, fused, derived = _FAMILIES[arch]
    if any(tail == p or p.endswith(".") and tail.startswith(p)
           for p in derived):
        return []
    if tail in block:
        fmts = block[tail]
        return [(f, v) for f in (fmts if isinstance(fmts, tuple)
                                 else (fmts,))]
    if fused and tail in (fused + "weight", fused + "bias"):
        if n_heads is None:
            raise ValueError(
                f"{_FUSED_NAME[arch]} fused query_key_value needs n_heads "
                "(Module.load passes it automatically)")
        attr = tail.rsplit(".", 1)[1]
        return [(f"{name}{{i}}.{attr}", part) for name, part in zip(
            ("wq", "wk", "wv"), _split_qkv_interleaved(v, n_heads, 0))]
    if arch == "gpt2":
        if tail in _GPT2_BLOCK_CONV1D:
            return [(_GPT2_BLOCK_CONV1D[tail], _t(v))]
        if tail == "attn.c_attn.weight":
            # Conv1D [in, 3 * dim]: split along OUT, then transpose
            return [(f"{name}{{i}}.weight", part.T) for name, part in zip(
                ("wq", "wk", "wv"), _split3(v, axis=1))]
        if tail == "attn.c_attn.bias":
            return [(f"{name}{{i}}.bias", part) for name, part in zip(
                ("wq", "wk", "wv"), _split3(v, axis=0))]
    return None


def from_hf(state_dict: dict, arch: str | None = None,
            n_heads: int | None = None) -> dict:
    """Translate an HF state dict into this package's names (see the
    module docstring for what else changes).  Unknown keys raise
    ``KeyError``: dropping a weight silently would give a wrong model with
    no error."""
    arch = arch or detect(state_dict.keys())
    if arch is None:
        raise ValueError("state_dict does not look HF-exported; "
                         "load it directly")
    if arch not in _FAMILIES:
        arch = "gpt2"
    top, pat = _FAMILIES[arch][:2]
    out = {}
    for key, v in state_dict.items():
        if arch == "opt" and key in _OPT_POS:
            # OPT's learned positions are offset by 2 (rows 0 and 1 are
            # fairseq's pad artifacts): row p is position p after the slice
            out["pe.weight"] = _np(v)[2:]
            continue
        if key in top:
            out[top[key]] = v
            continue
        m = pat.match(key)
        entries = (_block_entries(arch, key[m.end():], v, n_heads)
                   if m else None)
        if entries is None:
            raise KeyError(f"unrecognized HF {arch} key: {key}")
        for fmt, value in entries:
            out[fmt.format(i=int(m.group(1)) + 1)] = value
    if "head.weight" not in out and "embed.weight" in out:
        # tied embeddings: the token table is the head's [vocab, dim]
        # weight as it stands; the head still quantizes on its own
        out["head.weight"] = out["embed.weight"]
    return out


def maybe_from_hf(state_dict: dict, model=None) -> dict:
    """:func:`from_hf` when the keys look HF-exported, else the dict
    itself (``Module.load``'s hook; ``model.heads`` is the ``n_heads`` of
    the fused-qkv de-interleave)."""
    arch = detect(state_dict.keys())
    if arch is None:
        return state_dict
    return from_hf(state_dict, arch, n_heads=getattr(model, "heads", None))


def from_hf_config(cfg: dict):
    """Map an HF ``config.json`` dict to ``(model_class, kwargs)``.

    The weight names cannot show everything: mistral's ``sliding_window``,
    gemma-2's softcaps and ``head_dim`` and NeoX's ``rotary_pct`` live only
    in the config, and a mistral checkpoint is named exactly as a llama
    one, so loading it onto a plain llama would attend globally without
    an error.

    >>> cls, kw = from_hf_config(json.load(open("config.json")))
    >>> model = cls(**kw, config=QuantConfig())

    ``model_type``: llama, mistral and qwen2 (llama's class; mistral's
    window, qwen2's only under ``use_sliding_window``), phi (NeoX's class,
    parallel residual forced), bloom, opt (not its 350m projections, not
    post-LN), gpt2, gpt_neox and gemma2.  Another type raises
    ``ValueError``.  Keys absent from the config keep the class's
    defaults."""
    from ..models.bloom import BloomDecoder
    from ..models.gemma import GemmaDecoder
    from ..models.llama import LlamaDecoder
    from ..models.neox import NeoXDecoder
    from ..models.text_decoder import TextDecoder

    mt = cfg.get("model_type")
    if mt is None:
        raise ValueError("HF config has no model_type")

    def pick(kwmap):
        return {dst: cfg[src] for src, dst in kwmap.items() if src in cfg}

    if mt in ("llama", "mistral", "qwen2"):
        kw = pick({"vocab_size": "vocab_size",
                   "max_position_embeddings": "max_len",
                   "hidden_size": "dim",
                   "num_hidden_layers": "depth",
                   "num_attention_heads": "heads",
                   "num_key_value_heads": "kv_heads",
                   "intermediate_size": "mlp_hidden",
                   "rope_theta": "rope_base",
                   "rms_norm_eps": "eps"})
        if mt in ("mistral", "qwen2"):
            # null in newer mistral configs = full attention; qwen2 gates
            # the window behind use_sliding_window
            sw = cfg.get("sliding_window")
            if mt == "qwen2" and not cfg.get("use_sliding_window", False):
                sw = None
            kw["sliding_window"] = sw
        return LlamaDecoder, kw
    if mt == "phi":
        kw = pick({"vocab_size": "vocab_size",
                   "max_position_embeddings": "max_len",
                   "hidden_size": "dim",
                   "num_hidden_layers": "depth",
                   "num_attention_heads": "heads",
                   "partial_rotary_factor": "rotary_pct",
                   "rope_theta": "rope_base",
                   "layer_norm_eps": "eps"})
        kw["use_parallel_residual"] = True      # phi is always parallel
        return NeoXDecoder, kw
    if mt == "bloom":
        # ALiBi has no position table, so a BLOOM config carries no
        # maximum length: the caller's max_len=, else the class default
        return BloomDecoder, pick({"vocab_size": "vocab_size",
                                   "hidden_size": "dim",
                                   "n_layer": "depth",
                                   "num_hidden_layers": "depth",
                                   "n_head": "heads",
                                   "num_attention_heads": "heads",
                                   "layer_norm_epsilon": "eps"})
    if mt == "opt":
        if cfg.get("word_embed_proj_dim",
                   cfg.get("hidden_size")) != cfg.get("hidden_size"):
            raise ValueError(
                "OPT checkpoints with word_embed_proj_dim != hidden_size "
                "(the 350m in/out projections) are unsupported")
        if not cfg.get("do_layer_norm_before", True):
            raise ValueError(
                "post-LN OPT variants (do_layer_norm_before=False) are "
                "unsupported; this family builds the pre-LN block")
        kw = pick({"vocab_size": "vocab_size",
                   "max_position_embeddings": "max_len",
                   "hidden_size": "dim",
                   "num_hidden_layers": "depth",
                   "num_attention_heads": "heads",
                   "ffn_dim": "mlp_hidden",
                   "activation_function": "act"})
        kw.setdefault("act", "relu")
        return TextDecoder, kw
    if mt == "gpt2":
        return TextDecoder, pick({"vocab_size": "vocab_size",
                                  "n_positions": "max_len",
                                  "n_embd": "dim",
                                  "n_layer": "depth",
                                  "n_head": "heads"})
    if mt == "gpt_neox":
        return NeoXDecoder, pick({"vocab_size": "vocab_size",
                                  "max_position_embeddings": "max_len",
                                  "hidden_size": "dim",
                                  "num_hidden_layers": "depth",
                                  "num_attention_heads": "heads",
                                  "rotary_pct": "rotary_pct",
                                  "rotary_emb_base": "rope_base",
                                  "use_parallel_residual":
                                      "use_parallel_residual",
                                  "layer_norm_eps": "eps"})
    if mt == "gemma2":
        return GemmaDecoder, pick({"vocab_size": "vocab_size",
                                   "max_position_embeddings": "max_len",
                                   "hidden_size": "dim",
                                   "num_hidden_layers": "depth",
                                   "num_attention_heads": "heads",
                                   "num_key_value_heads": "kv_heads",
                                   "head_dim": "head_dim",
                                   "intermediate_size": "mlp_hidden",
                                   "rope_theta": "rope_base",
                                   "sliding_window": "sliding_window",
                                   "attn_logit_softcapping": "attn_softcap",
                                   "final_logit_softcapping":
                                       "final_softcap",
                                   "rms_norm_eps": "eps"})
    raise ValueError(f"unsupported HF model_type: {mt!r} (supported: "
                     "llama, mistral, qwen2, gpt2, gpt_neox, gemma2, opt, "
                     "bloom, phi)")


def build_from_hf(cfg: dict, state_dict: dict | None = None, config=None,
                  **overrides):
    """Build the family of ``cfg`` (:func:`from_hf_config`) and load
    ``state_dict`` through the name adapter.  ``overrides`` win over the
    config's values, ``device=`` among them: without it the model is built
    on the card (and raises where there is none)."""
    cls, kw = from_hf_config(cfg)
    kw.update(overrides)
    if config is not None:
        kw["config"] = config
    model = cls(**kw)
    if state_dict is not None:
        model.load(state_dict)
    return model


_SINGLE_FILES = ("model.safetensors", "pytorch_model.bin", "pytorch_model.pt")


def _read_weights(d: str) -> dict:
    """The state dict of an HF directory: a sharded set through
    ``model.safetensors.index.json``, else the first of ``_SINGLE_FILES``
    there, as numpy arrays (``checkpoint.read_state_dict``'s)."""
    from .checkpoint import read_state_dict
    idx = os.path.join(d, "model.safetensors.index.json")
    if os.path.isfile(idx):
        with open(idx) as f:
            shard_of = json.load(f)["weight_map"]
        state = {}
        for shard in sorted(set(shard_of.values())):
            state.update(read_state_dict(os.path.join(d, shard)))
        return state
    for name in _SINGLE_FILES:
        p = os.path.join(d, name)
        if not os.path.isfile(p):
            continue
        if name.endswith(".bin"):
            # torch's pickle under another extension; .numpy() refuses
            # what numpy cannot hold (bfloat16), as the safetensors
            # reader does
            sd = torch.load(p, map_location="cpu", weights_only=True)
            return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
                    for k, v in sd.items()}
        return read_state_dict(p)
    raise FileNotFoundError(
        f"no model.safetensors / pytorch_model.bin / "
        f"model.safetensors.index.json under {d!r}")


def load_pretrained(path, config=None, **overrides):
    """Load an HF checkpoint directory in one call: read ``config.json``,
    the weights (a sharded set through ``model.safetensors.index.json``, a
    single ``model.safetensors``, or ``pytorch_model.bin`` / ``.pt``), build
    the family (:func:`from_hf_config`: window, softcap and rotary settings
    included) and load through the name adapter, each array moved to the
    model's device once:

    >>> m = load_pretrained("path/to/mistral-7b",
    ...                     config=QuantConfig(rounding="nearest"))

    ``overrides`` win over config.json (``max_len=2048`` serves a shorter
    context than the checkpoint's; ``device="cpu"`` builds on the CPU,
    the card otherwise).  A bfloat16 file raises ``TypeError`` (numpy has
    no bfloat16), as in the JAX package."""
    d = str(path)
    cfg_path = os.path.join(d, "config.json")
    if not os.path.isfile(cfg_path):
        raise FileNotFoundError(f"no config.json under {d!r}")
    with open(cfg_path) as f:
        cfg = json.load(f)
    return build_from_hf(cfg, _read_weights(d), config=config, **overrides)
