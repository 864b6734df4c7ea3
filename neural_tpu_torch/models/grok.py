"""Grok-1: config and HF tensor maps (port of ``neural_tpu/models/grok.py``).
A mixture of 8 experts a layer, top 2, with tanh-GELU SwiGLU experts,
attention and final-logit softcaps of 30, post-attention and post-MoE RMS
norms, an embedding scale (``embedding_multiplier_scale``, applied as a
bf16 scalar) and ``attn_output_multiplier`` as the attention's scale. The
tensor names are the community HF conversion's (keyfan/grok-1-hf), whose
config class is its own remote code: its ``config.json`` is read as a
``convert.files.RemoteConfig``.
"""
from __future__ import annotations

from .config import ModelConfig


def config_from_hf(c) -> ModelConfig:
    D = c.hidden_size
    return ModelConfig(
        arch="grok", vocab_size=c.vocab_size, hidden_size=D,
        n_layers=c.num_hidden_layers, n_heads=c.num_attention_heads,
        n_kv_heads=c.num_key_value_heads,
        head_dim=getattr(c, "head_dim", D // c.num_attention_heads),
        intermediate_size=c.intermediate_size,
        norm_type="rmsnorm", norm_eps=c.rms_norm_eps,
        act="gelu_tanh", mlp_gated=True,
        rope_style="neox", rope_theta=getattr(c, "rope_theta", 10000.0),
        attn_softcap=30.0, logit_softcap=30.0,
        attn_scale=getattr(c, "attn_output_multiplier", None),
        post_attn_norm=True, post_ffn_norm=True,
        embed_scale=getattr(c, "embedding_multiplier_scale", 1.0),
        n_experts=getattr(c, "num_experts", 8),
        n_experts_active=getattr(c, "num_experts_per_tok", 2),
        max_seq_len=getattr(c, "max_position_embeddings", 8192),
        bos_token_id=1, eos_token_id=2,
    )


def hf_layer_map(i: int, cfg: ModelConfig):
    p = f"model.layers.{i}."
    m = {
        "attn_norm_w": (p + "pre_attn_norm.weight", False),
        "post_attn_norm_w": (p + "post_attn_norm.weight", False),
        "wq": (p + "attn.q_proj.weight", True),
        "wk": (p + "attn.k_proj.weight", True),
        "wv": (p + "attn.v_proj.weight", True),
        "wo": (p + "attn.o_proj.weight", True),
        "ffn_norm_w": (p + "pre_moe_norm.weight", False),
        "post_ffn_norm_w": (p + "post_moe_norm.weight", False),
        "router": (p + "moe_block.gate.weight", True),
    }
    for e in range(cfg.n_experts):
        ep = p + f"moe_block.experts.{e}."
        m[f"experts.{e}.w_gate"] = (ep + "linear.weight", True)
        m[f"experts.{e}.w_up"] = (ep + "linear_v.weight", True)
        m[f"experts.{e}.w_down"] = (ep + "linear_1.weight", True)
    return m


def hf_top_map(cfg: ModelConfig):
    return {
        "embed": ("model.embed_tokens.weight", False),
        "final_norm_w": ("model.norm.weight", False),
        "lm_head": ("lm_head.weight", True),
    }


QUANT_TENSORS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                 "lm_head")
