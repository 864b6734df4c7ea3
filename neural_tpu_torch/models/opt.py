"""OPT: config and HF tensor maps (port of ``neural_tpu/models/opt.py``).
Learned position embeddings read at position + 2, pre-LayerNorms with
biases, biases on every projection, a ReLU MLP, no RoPE."""
from __future__ import annotations

from .config import ModelConfig


def config_from_hf(c) -> ModelConfig:
    """Map a transformers OPTConfig (read as attributes)."""
    D = c.hidden_size
    if getattr(c, "word_embed_proj_dim", D) != D:
        raise NotImplementedError(
            "OPT's projected-embedding variants (opt-350m) are not run by "
            "the JAX package either")
    return ModelConfig(
        arch="opt", vocab_size=c.vocab_size, hidden_size=D,
        n_layers=c.num_hidden_layers, n_heads=c.num_attention_heads,
        n_kv_heads=c.num_attention_heads, head_dim=D // c.num_attention_heads,
        intermediate_size=c.ffn_dim,
        norm_type="layernorm", norm_eps=1e-5,
        act="relu" if c.activation_function == "relu"
        else c.activation_function,
        mlp_gated=False, mlp_bias=True, qkv_bias=True, o_bias=True,
        rope_style="none", learned_pos_emb=True, pos_offset=2,
        tie_word_embeddings=bool(getattr(c, "tie_word_embeddings", True)),
        max_seq_len=c.max_position_embeddings,
        bos_token_id=getattr(c, "bos_token_id", 2) or 2,
        eos_token_id=getattr(c, "eos_token_id", 2) or 2,
    )


def hf_layer_map(i: int, cfg: ModelConfig):
    """Our layer-param name → (HF tensor name, transpose?)."""
    p = f"model.decoder.layers.{i}."
    return {
        "attn_norm_w": (p + "self_attn_layer_norm.weight", False),
        "attn_norm_b": (p + "self_attn_layer_norm.bias", False),
        "wq": (p + "self_attn.q_proj.weight", True),
        "bq": (p + "self_attn.q_proj.bias", False),
        "wk": (p + "self_attn.k_proj.weight", True),
        "bk": (p + "self_attn.k_proj.bias", False),
        "wv": (p + "self_attn.v_proj.weight", True),
        "bv": (p + "self_attn.v_proj.bias", False),
        "wo": (p + "self_attn.out_proj.weight", True),
        "bo": (p + "self_attn.out_proj.bias", False),
        "ffn_norm_w": (p + "final_layer_norm.weight", False),
        "ffn_norm_b": (p + "final_layer_norm.bias", False),
        "w_up": (p + "fc1.weight", True),
        "b_up": (p + "fc1.bias", False),
        "w_down": (p + "fc2.weight", True),
        "b_down": (p + "fc2.bias", False),
    }


def hf_top_map(cfg: ModelConfig):
    m = {
        "embed": ("model.decoder.embed_tokens.weight", False),
        "pos_embed": ("model.decoder.embed_positions.weight", False),
        "final_norm_w": ("model.decoder.final_layer_norm.weight", False),
        "final_norm_b": ("model.decoder.final_layer_norm.bias", False),
    }
    if not cfg.tie_word_embeddings:
        m["lm_head"] = ("lm_head.weight", True)
    return m


QUANT_TENSORS = ("wq", "wk", "wv", "wo", "w_up", "w_down", "lm_head")
