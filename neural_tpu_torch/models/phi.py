"""Phi family: config and HF tensor maps (port of
``neural_tpu/models/phi.py``). Phi-1.5/2: NeoX RoPE on the first
``partial_rotary_factor`` of the head, a parallel residual with one shared
LayerNorm, biases on every projection, a tanh-GELU MLP and a biased
lm_head. Phi-3: Llama's graph with the fused ``qkv_proj`` and
``gate_up_proj``, split here, and longrope scaling."""
from __future__ import annotations

from ._defuse import split_concat, split_rows
from .config import ModelConfig


def config_from_hf(c) -> ModelConfig:
    """Map a transformers PhiConfig / Phi3Config (read as attributes)."""
    mt = getattr(c, "model_type", "phi")
    D = c.hidden_size
    H = c.num_attention_heads
    Dh = D // H
    if mt == "phi3":
        return ModelConfig(
            arch="phi3", vocab_size=c.vocab_size, hidden_size=D,
            n_layers=c.num_hidden_layers, n_heads=H,
            n_kv_heads=c.num_key_value_heads, head_dim=Dh,
            intermediate_size=c.intermediate_size,
            norm_type="rmsnorm", norm_eps=c.rms_norm_eps,
            act="silu", mlp_gated=True,
            rope_style="neox", rope_theta=c.rope_theta,
            rope_scaling=getattr(c, "rope_scaling", None),
            tie_word_embeddings=bool(getattr(c, "tie_word_embeddings",
                                             False)),
            max_seq_len=c.max_position_embeddings,
            bos_token_id=getattr(c, "bos_token_id", 1) or 1,
            eos_token_id=getattr(c, "eos_token_id", 32000) or 32000,
        )
    return ModelConfig(
        arch="phi", vocab_size=c.vocab_size, hidden_size=D,
        n_layers=c.num_hidden_layers, n_heads=H,
        n_kv_heads=getattr(c, "num_key_value_heads", None) or H,
        head_dim=Dh, intermediate_size=c.intermediate_size,
        norm_type="layernorm", norm_eps=c.layer_norm_eps,
        act="gelu_tanh", mlp_gated=False, mlp_bias=True,
        qkv_bias=True, o_bias=True,
        rope_style="neox",
        rope_dim=int(Dh * getattr(c, "partial_rotary_factor", 0.5)),
        rope_theta=getattr(c, "rope_theta", 10000.0),
        parallel_residual=True,  # one shared LayerNorm
        max_seq_len=c.max_position_embeddings,
        bos_token_id=getattr(c, "bos_token_id", 1) or 1,
        eos_token_id=getattr(c, "eos_token_id", 2) or 2,
    )


def preprocess_state_dict(sd, cfg: ModelConfig):
    """Phi-3: split each layer's qkv_proj and gate_up_proj."""
    if cfg.arch != "phi3":
        return sd
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        qkv = p + "self_attn.qkv_proj.weight"
        if qkv in sd:
            q, k, v = split_concat(sd.pop(qkv), cfg.q_dim, cfg.kv_dim)
            sd.update({p + "self_attn._q": q, p + "self_attn._k": k,
                       p + "self_attn._v": v})
        gu = p + "mlp.gate_up_proj.weight"
        if gu in sd:
            g, u = split_rows(sd.pop(gu), cfg.intermediate_size)
            sd[p + "mlp._gate"], sd[p + "mlp._up"] = g, u
    return sd


def hf_layer_map(i: int, cfg: ModelConfig):
    """Our layer-param name → (HF tensor name, transpose?)."""
    p = f"model.layers.{i}."
    if cfg.arch == "phi3":
        return {
            "attn_norm_w": (p + "input_layernorm.weight", False),
            "wq": (p + "self_attn._q", True),
            "wk": (p + "self_attn._k", True),
            "wv": (p + "self_attn._v", True),
            "wo": (p + "self_attn.o_proj.weight", True),
            "ffn_norm_w": (p + "post_attention_layernorm.weight", False),
            "w_gate": (p + "mlp._gate", True),
            "w_up": (p + "mlp._up", True),
            "w_down": (p + "mlp.down_proj.weight", True),
        }
    return {
        "attn_norm_w": (p + "input_layernorm.weight", False),
        "attn_norm_b": (p + "input_layernorm.bias", False),
        "wq": (p + "self_attn.q_proj.weight", True),
        "bq": (p + "self_attn.q_proj.bias", False),
        "wk": (p + "self_attn.k_proj.weight", True),
        "bk": (p + "self_attn.k_proj.bias", False),
        "wv": (p + "self_attn.v_proj.weight", True),
        "bv": (p + "self_attn.v_proj.bias", False),
        "wo": (p + "self_attn.dense.weight", True),
        "bo": (p + "self_attn.dense.bias", False),
        "w_up": (p + "mlp.fc1.weight", True),
        "b_up": (p + "mlp.fc1.bias", False),
        "w_down": (p + "mlp.fc2.weight", True),
        "b_down": (p + "mlp.fc2.bias", False),
    }


def hf_top_map(cfg: ModelConfig):
    if cfg.arch == "phi3":
        m = {
            "embed": ("model.embed_tokens.weight", False),
            "final_norm_w": ("model.norm.weight", False),
        }
        if not cfg.tie_word_embeddings:
            m["lm_head"] = ("lm_head.weight", True)
        return m
    return {
        "embed": ("model.embed_tokens.weight", False),
        "final_norm_w": ("model.final_layernorm.weight", False),
        "final_norm_b": ("model.final_layernorm.bias", False),
        "lm_head": ("lm_head.weight", True),
        "lm_head_b": ("lm_head.bias", False),
    }


QUANT_TENSORS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                 "lm_head")
