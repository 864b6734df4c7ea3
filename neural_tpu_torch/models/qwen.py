"""Qwen family: config and HF tensor maps (port of
``neural_tpu/models/qwen.py``). Qwen2 is Llama's maps plus q/k/v biases;
Qwen v1 (remote code) has the fused ``c_attn`` with its bias, split here,
and an MLP whose ``w2`` is the gate and ``w1`` the up projection, with
``intermediate_size`` counting both halves. Qwen3 and Qwen2-MoE raise,
each naming the gap of the JAX package, the port's reference."""
from __future__ import annotations

import dataclasses

from . import llama as llama_mod
from ._defuse import split_concat
from .config import ModelConfig

# Why the port refuses Qwen3: the JAX package, its reference, cannot import
# it either (ROADMAP §C)
QWEN3_FAULT = (
    "qwen3: the JAX package, the port's reference, does not run Qwen3: its "
    "qwen.config_from_hf sets qkv_bias=True for every type past v1, and "
    "Qwen3 has no q/k/v biases (a tiny Qwen3ForCausalLM raises KeyError "
    "'model.layers.0.self_attn.q_proj.bias' in neural_tpu.convert."
    "from_hf_model), and no family maps q_norm/k_norm onto the graph's "
    "qk_norm")


# Why the port refuses Qwen2-MoE: the JAX package does not run it either
# (ROADMAP §C)
QWEN2_MOE_GAP = (
    "qwen2_moe: the JAX package, the port's reference, does not run "
    "Qwen2-MoE: its registry (neural_tpu/convert/hf.py ARCH_MODULES) has no "
    "'qwen2_moe', so its from_hf_model raises KeyError; its ModelConfig has "
    "no shared-expert field (Qwen2-MoE adds a gated shared expert to every "
    "layer); and the Llama config path reads num_local_experts, which "
    "Qwen2-MoE's config names num_experts")


def config_from_hf(c) -> ModelConfig:
    """Map a Qwen2Config, or a Qwen v1 config (read as attributes: v1's
    checkpoints carry their own remote code, and its config.json must have
    every field read here)."""
    mt = getattr(c, "model_type", "qwen2")
    if mt == "qwen3":
        raise NotImplementedError(QWEN3_FAULT)
    if mt == "qwen2_moe":
        raise NotImplementedError(QWEN2_MOE_GAP)
    if mt == "qwen":  # v1
        D = c.hidden_size
        return ModelConfig(
            arch="qwen", vocab_size=c.vocab_size, hidden_size=D,
            n_layers=c.num_hidden_layers, n_heads=c.num_attention_heads,
            n_kv_heads=c.num_attention_heads,
            head_dim=D // c.num_attention_heads,
            intermediate_size=c.intermediate_size // 2,
            norm_type="rmsnorm", norm_eps=c.layer_norm_epsilon,
            act="silu", mlp_gated=True, qkv_bias=True,
            rope_style="neox",
            rope_theta=getattr(c, "rotary_emb_base", 10000.0),
            max_seq_len=c.max_position_embeddings,
            eos_token_id=getattr(c, "eos_token_id", 151643) or 151643,
            bos_token_id=getattr(c, "bos_token_id", 151643) or 151643,
        )
    return dataclasses.replace(llama_mod.config_from_hf(c), arch=mt,
                               qkv_bias=True)


def preprocess_state_dict(sd, cfg: ModelConfig):
    """Qwen v1: split each layer's fused c_attn weight and bias."""
    if cfg.arch != "qwen":
        return sd
    for i in range(cfg.n_layers):
        base = f"transformer.h.{i}.attn.c_attn."
        if base + "weight" not in sd:
            continue
        q, k, v = split_concat(sd.pop(base + "weight"), cfg.q_dim,
                               cfg.kv_dim)
        qb, kb, vb = split_concat(sd.pop(base + "bias"), cfg.q_dim,
                                  cfg.kv_dim)
        sd.update({base + "_q": q, base + "_k": k, base + "_v": v,
                   base + "_qb": qb, base + "_kb": kb, base + "_vb": vb})
    return sd


def hf_layer_map(i: int, cfg: ModelConfig):
    """Our layer-param name → (HF tensor name, transpose?)."""
    if cfg.arch == "qwen":  # v1
        p = f"transformer.h.{i}."
        a = p + "attn.c_attn."
        return {
            "attn_norm_w": (p + "ln_1.weight", False),
            "wq": (a + "_q", True), "bq": (a + "_qb", False),
            "wk": (a + "_k", True), "bk": (a + "_kb", False),
            "wv": (a + "_v", True), "bv": (a + "_vb", False),
            "wo": (p + "attn.c_proj.weight", True),
            "ffn_norm_w": (p + "ln_2.weight", False),
            "w_gate": (p + "mlp.w2.weight", True),
            "w_up": (p + "mlp.w1.weight", True),
            "w_down": (p + "mlp.c_proj.weight", True),
        }
    m = llama_mod.hf_layer_map(i, cfg)
    p = f"model.layers.{i}.self_attn."
    m.update({"bq": (p + "q_proj.bias", False),
              "bk": (p + "k_proj.bias", False),
              "bv": (p + "v_proj.bias", False)})
    return m


def hf_top_map(cfg: ModelConfig):
    if cfg.arch == "qwen":
        return {
            "embed": ("transformer.wte.weight", False),
            "final_norm_w": ("transformer.ln_f.weight", False),
            "lm_head": ("lm_head.weight", True),
        }
    return llama_mod.hf_top_map(cfg)


QUANT_TENSORS = llama_mod.QUANT_TENSORS
