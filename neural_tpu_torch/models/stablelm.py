"""StableLM: config and HF tensor maps (port of
``neural_tpu/models/stablelm.py``). LayerNorms with biases, NeoX RoPE on
the first ``partial_rotary_factor`` of the head, a gated SiLU MLP and
optional q/k/v biases."""
from __future__ import annotations

from .config import ModelConfig


def config_from_hf(c) -> ModelConfig:
    """Map a transformers StableLmConfig (read as attributes)."""
    D = c.hidden_size
    H = c.num_attention_heads
    Dh = D // H
    return ModelConfig(
        arch="stablelm", vocab_size=c.vocab_size, hidden_size=D,
        n_layers=c.num_hidden_layers, n_heads=H,
        n_kv_heads=c.num_key_value_heads, head_dim=Dh,
        intermediate_size=c.intermediate_size,
        norm_type="layernorm", norm_eps=c.layer_norm_eps,
        act="silu", mlp_gated=True,
        qkv_bias=bool(getattr(c, "use_qkv_bias", False)),
        rope_style="neox",
        rope_dim=int(Dh * c.partial_rotary_factor),
        rope_theta=c.rope_theta,
        max_seq_len=c.max_position_embeddings,
        bos_token_id=getattr(c, "bos_token_id", 0) or 0,
        eos_token_id=getattr(c, "eos_token_id", 0) or 0,
    )


def hf_layer_map(i: int, cfg: ModelConfig):
    """Our layer-param name → (HF tensor name, transpose?)."""
    p = f"model.layers.{i}."
    m = {
        "attn_norm_w": (p + "input_layernorm.weight", False),
        "attn_norm_b": (p + "input_layernorm.bias", False),
        "wq": (p + "self_attn.q_proj.weight", True),
        "wk": (p + "self_attn.k_proj.weight", True),
        "wv": (p + "self_attn.v_proj.weight", True),
        "wo": (p + "self_attn.o_proj.weight", True),
        "ffn_norm_w": (p + "post_attention_layernorm.weight", False),
        "ffn_norm_b": (p + "post_attention_layernorm.bias", False),
        "w_gate": (p + "mlp.gate_proj.weight", True),
        "w_up": (p + "mlp.up_proj.weight", True),
        "w_down": (p + "mlp.down_proj.weight", True),
    }
    if cfg.qkv_bias:
        m.update({"bq": (p + "self_attn.q_proj.bias", False),
                  "bk": (p + "self_attn.k_proj.bias", False),
                  "bv": (p + "self_attn.v_proj.bias", False)})
    return m


def hf_top_map(cfg: ModelConfig):
    return {
        "embed": ("model.embed_tokens.weight", False),
        "final_norm_w": ("model.norm.weight", False),
        "final_norm_b": ("model.norm.bias", False),
        "lm_head": ("lm_head.weight", True),
    }


QUANT_TENSORS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                 "lm_head")
