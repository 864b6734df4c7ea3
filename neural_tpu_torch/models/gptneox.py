"""GPT-NeoX, Pythia, Dolly, Polyglot: config and HF tensor maps (port of
``neural_tpu/models/gptneox.py``). The per-head-interleaved fused
``query_key_value`` with its bias, split here; NeoX RoPE on the first
``rotary_pct`` of the head; LayerNorms with biases; biases on every
projection; a non-gated GELU MLP; a parallel (``use_parallel_residual``)
or serial residual, each branch with its own norm."""
from __future__ import annotations

from ._defuse import split_interleaved
from .config import ModelConfig


def config_from_hf(c) -> ModelConfig:
    """Map a transformers GPTNeoXConfig (read as attributes)."""
    D = c.hidden_size
    Dh = D // c.num_attention_heads
    return ModelConfig(
        arch="gpt_neox", vocab_size=c.vocab_size, hidden_size=D,
        n_layers=c.num_hidden_layers, n_heads=c.num_attention_heads,
        n_kv_heads=c.num_attention_heads, head_dim=Dh,
        intermediate_size=c.intermediate_size,
        norm_type="layernorm", norm_eps=c.layer_norm_eps,
        act="gelu" if c.hidden_act == "gelu" else c.hidden_act,
        mlp_gated=False, mlp_bias=True, qkv_bias=True, o_bias=True,
        rope_style="neox", rope_dim=int(Dh * c.rotary_pct),
        rope_theta=getattr(c, "rotary_emb_base", 10000.0),
        parallel_residual=bool(c.use_parallel_residual),
        max_seq_len=c.max_position_embeddings,
        bos_token_id=getattr(c, "bos_token_id", 0) or 0,
        eos_token_id=getattr(c, "eos_token_id", 0) or 0,
    )


def preprocess_state_dict(sd, cfg: ModelConfig):
    """Split each layer's fused query_key_value weight and bias."""
    for i in range(cfg.n_layers):
        base = f"gpt_neox.layers.{i}.attention.query_key_value."
        if base + "weight" not in sd:
            continue
        q, k, v = split_interleaved(sd.pop(base + "weight"), cfg.n_heads,
                                    cfg.head_dim)
        qb, kb, vb = split_interleaved(sd.pop(base + "bias"), cfg.n_heads,
                                       cfg.head_dim)
        sd.update({base + "_q": q, base + "_k": k, base + "_v": v,
                   base + "_qb": qb, base + "_kb": kb, base + "_vb": vb})
    return sd


def hf_layer_map(i: int, cfg: ModelConfig):
    """Our layer-param name → (HF tensor name, transpose?)."""
    p = f"gpt_neox.layers.{i}."
    a = p + "attention.query_key_value."
    return {
        "attn_norm_w": (p + "input_layernorm.weight", False),
        "attn_norm_b": (p + "input_layernorm.bias", False),
        "ffn_norm_w": (p + "post_attention_layernorm.weight", False),
        "ffn_norm_b": (p + "post_attention_layernorm.bias", False),
        "wq": (a + "_q", True), "bq": (a + "_qb", False),
        "wk": (a + "_k", True), "bk": (a + "_kb", False),
        "wv": (a + "_v", True), "bv": (a + "_vb", False),
        "wo": (p + "attention.dense.weight", True),
        "bo": (p + "attention.dense.bias", False),
        "w_up": (p + "mlp.dense_h_to_4h.weight", True),
        "b_up": (p + "mlp.dense_h_to_4h.bias", False),
        "w_down": (p + "mlp.dense_4h_to_h.weight", True),
        "b_down": (p + "mlp.dense_4h_to_h.bias", False),
    }


def hf_top_map(cfg: ModelConfig):
    return {
        "embed": ("gpt_neox.embed_in.weight", False),
        "final_norm_w": ("gpt_neox.final_layer_norm.weight", False),
        "final_norm_b": ("gpt_neox.final_layer_norm.bias", False),
        "lm_head": ("embed_out.weight", True),
    }


QUANT_TENSORS = ("wq", "wk", "wv", "wo", "w_up", "w_down", "lm_head")
