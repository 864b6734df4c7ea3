"""LLaMA family: config and HF tensor maps (port of
``neural_tpu/models/llama.py``; the MoE variants are not ported)."""
from __future__ import annotations

from typing import Any, Dict

from .config import ModelConfig


def config_from_hf(c) -> ModelConfig:
    """Map a transformers LlamaConfig / MistralConfig (read as attributes,
    so no import of transformers is needed). Mistral's ``sliding_window``
    is not read, as the JAX package's ``config_from_hf`` does not read it:
    neither package applies Mistral's window."""
    model_type = getattr(c, "model_type", "llama")
    n_kv = getattr(c, "num_key_value_heads", None) or c.num_attention_heads
    head_dim = getattr(c, "head_dim", None) or (
        c.hidden_size // c.num_attention_heads)
    n_experts = getattr(c, "num_local_experts", 0) or 0
    return ModelConfig(
        arch=model_type,
        vocab_size=c.vocab_size,
        hidden_size=c.hidden_size,
        n_layers=c.num_hidden_layers,
        n_heads=c.num_attention_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        intermediate_size=getattr(c, "intermediate_size", 4 * c.hidden_size),
        norm_type="rmsnorm",
        norm_eps=getattr(c, "rms_norm_eps", 1e-5),
        act=getattr(c, "hidden_act", "silu"),
        mlp_gated=True,
        rope_style="neox",
        rope_theta=getattr(c, "rope_theta", 10000.0),
        rope_scaling=getattr(c, "rope_scaling", None),
        tie_word_embeddings=getattr(c, "tie_word_embeddings", False),
        max_seq_len=getattr(c, "max_position_embeddings", 4096),
        n_experts=n_experts,
        n_experts_active=getattr(c, "num_experts_per_tok", 0) or 0,
        bos_token_id=getattr(c, "bos_token_id", 1) or 1,
        # int or list; ModelConfig normalizes it into eos_token_ids
        eos_token_id=getattr(c, "eos_token_id", 2) or 2,
    )


def hf_layer_map(i: int, cfg: ModelConfig) -> Dict[str, Any]:
    """Our layer-param name → (HF tensor name, transpose?)."""
    if cfg.is_moe:
        raise NotImplementedError("MoE (Mixtral) layers are a later slice")
    p = f"model.layers.{i}."
    return {
        "attn_norm_w": (p + "input_layernorm.weight", False),
        "wq": (p + "self_attn.q_proj.weight", True),
        "wk": (p + "self_attn.k_proj.weight", True),
        "wv": (p + "self_attn.v_proj.weight", True),
        "wo": (p + "self_attn.o_proj.weight", True),
        "ffn_norm_w": (p + "post_attention_layernorm.weight", False),
        "w_gate": (p + "mlp.gate_proj.weight", True),
        "w_up": (p + "mlp.up_proj.weight", True),
        "w_down": (p + "mlp.down_proj.weight", True),
    }


def hf_top_map(cfg: ModelConfig) -> Dict[str, Any]:
    m = {
        "embed": ("model.embed_tokens.weight", False),
        "final_norm_w": ("model.norm.weight", False),
    }
    if not cfg.tie_word_embeddings:
        m["lm_head"] = ("lm_head.weight", True)
    return m


QUANT_TENSORS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                 "lm_head")
