"""HuggingFace Llama / Mistral / Mixtral checkpoint conversion:
counterpart of ``mpi_operator_tpu/models/convert.py``.

Maps a transformers ``LlamaForCausalLM`` / ``MistralForCausalLM`` /
``MixtralForCausalLM`` state dict straight onto the port's LlamaModel
state dict.  An HF ``Linear`` weight is already [out, in], the port's
layout, so the attention and dense MLP weights are taken as they are;
Mixtral's per-expert ``w1``/``w3`` [F, D] and ``w2`` [D, F] are
transposed and stacked into ``ops/moe.py``'s [E, D, F] / [E, F, D].
The RoPE convention (rotate-half) and RMSNorm epsilon match 1:1.

Every checkpoint tensor must be consumed (rotary ``inv_freq`` buffers
excepted): an unexpected key (a bias-bearing variant, a layer-count
mismatch) raises instead of giving a silently wrong model.  A
tied-embedding checkpoint (no ``lm_head.weight``) reuses the embedding.

``transformers`` is never imported here: the functions take a state
dict (torch tensors or arrays) and a config object.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from .llama import LlamaConfig


def _convert_hf_common(state_dict, config: LlamaConfig, dtype,
                       ffn_fn: Callable) -> Dict[str, torch.Tensor]:
    """Embeddings, head, norms and attention plus the every-tensor-
    consumed rule; ``ffn_fn(get, hf, key, sd)`` fills one layer's
    feed_forward entries (dense or MoE).  Matmul weights and the
    embedding in ``dtype`` (default ``config.dtype``), norm scales and
    the router in ``config.param_dtype``."""
    dtype = dtype or config.dtype
    consumed = set()

    def get(name, dt=dtype) -> torch.Tensor:
        w = state_dict[name]
        consumed.add(name)
        w = w.detach() if isinstance(w, torch.Tensor) else \
            torch.from_numpy(np.array(w))
        return w.to("cpu", torch.float32).to(dt).contiguous()

    norm = config.param_dtype
    embedding = get("model.embed_tokens.weight")
    sd = {"tok_embeddings.weight": embedding,
          "norm.scale": get("model.norm.weight", norm)}
    if "lm_head.weight" in state_dict:
        sd["output.weight"] = get("lm_head.weight")
    else:
        sd["output.weight"] = embedding.clone()   # tie_word_embeddings
    for i in range(config.n_layers):
        hf, key = f"model.layers.{i}", f"layers.{i}"
        for ours, theirs in (("wq", "q_proj"), ("wk", "k_proj"),
                             ("wv", "v_proj"), ("wo", "o_proj")):
            sd[f"{key}.attention.{ours}.weight"] = get(
                f"{hf}.self_attn.{theirs}.weight")
        sd[f"{key}.attention_norm.scale"] = get(
            f"{hf}.input_layernorm.weight", norm)
        sd[f"{key}.ffn_norm.scale"] = get(
            f"{hf}.post_attention_layernorm.weight", norm)
        ffn_fn(get, hf, f"{key}.feed_forward", sd)

    leftover = [k for k in state_dict
                if k not in consumed and not k.endswith("inv_freq")]
    if leftover:
        raise ValueError(
            f"unconverted checkpoint tensors (config mismatch or"
            f" unsupported variant): {sorted(leftover)[:8]}...")
    return sd


def convert_hf_llama(state_dict, config: LlamaConfig,
                     dtype: Optional[torch.dtype] = None
                     ) -> Dict[str, torch.Tensor]:
    """``LlamaForCausalLM`` / ``MistralForCausalLM`` state dict -> the
    port's LlamaModel state dict on the CPU (``load_state_dict`` it)."""
    def ffn(get, hf, key, sd):
        for ours, theirs in (("w1", "gate_proj"), ("w3", "up_proj"),
                             ("w2", "down_proj")):
            sd[f"{key}.{ours}.weight"] = get(f"{hf}.mlp.{theirs}.weight")

    return _convert_hf_common(state_dict, config, dtype, ffn)


def convert_hf_mixtral(state_dict, config: LlamaConfig,
                       dtype: Optional[torch.dtype] = None
                       ) -> Dict[str, torch.Tensor]:
    """``MixtralForCausalLM`` state dict -> the MoE LlamaModel's
    (config.n_experts > 1).  Both sides route softmax -> top-k ->
    renormalise (``MixtralSparseMoeBlock.forward``), and the model's
    cached path routes drop-free, so its logits compare with
    transformers' own."""
    if config.n_experts <= 1:
        raise ValueError("convert_hf_mixtral needs config.n_experts > 1")

    def ffn(get, hf, key, sd):
        moe = f"{hf}.block_sparse_moe"
        sd[f"{key}.router.weight"] = get(f"{moe}.gate.weight",
                                         config.param_dtype)
        for name in ("w1", "w3", "w2"):
            sd[f"{key}.{name}"] = torch.stack([
                get(f"{moe}.experts.{e}.{name}.weight").t()
                for e in range(config.n_experts)]).contiguous()

    return _convert_hf_common(state_dict, config, dtype, ffn)


def config_from_hf(hf_config, **overrides) -> LlamaConfig:
    """A LlamaConfig (``dtype=torch.float32``) from a transformers
    Llama, Mistral or Mixtral config: Mistral's ``sliding_window``,
    llama3 ``rope_scaling`` and Mixtral's ``num_local_experts`` ->
    ``n_experts``."""
    if getattr(hf_config, "num_local_experts", 0) > 1:
        overrides = {**dict(
            n_experts=hf_config.num_local_experts,
            top_k=hf_config.num_experts_per_tok), **overrides}
    rope_scaling = getattr(hf_config, "rope_scaling", None)
    if rope_scaling is not None:
        rope_type = rope_scaling.get("rope_type",
                                     rope_scaling.get("type", ""))
        if rope_type != "llama3":
            raise NotImplementedError(
                f"rope_scaling type {rope_type!r} not supported")
    return LlamaConfig(**{**dict(
        rope_scaling=rope_scaling,
        sliding_window=getattr(hf_config, "sliding_window", None),
        vocab_size=hf_config.vocab_size,
        dim=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=hf_config.num_key_value_heads,
        hidden_dim=hf_config.intermediate_size,
        norm_eps=hf_config.rms_norm_eps,
        rope_theta=getattr(hf_config, "rope_theta", 10000.0),
        max_seq_len=hf_config.max_position_embeddings,
        dtype=torch.float32,
    ), **overrides})
