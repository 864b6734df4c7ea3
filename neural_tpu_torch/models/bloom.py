"""Bloom: config and HF tensor maps (port of ``neural_tpu/models/bloom.py``).
ALiBi attention with no rotary positions, LayerNorms with biases, a
LayerNorm on the embedding output, the per-head-interleaved fused QKV with
its biases, biases on every projection, a non-gated tanh-GELU MLP, tied
embeddings."""
from __future__ import annotations

from ._defuse import split_interleaved
from .config import ModelConfig


def config_from_hf(c) -> ModelConfig:
    """Map a transformers BloomConfig (read as attributes, so no import of
    transformers is needed)."""
    D = c.hidden_size
    return ModelConfig(
        arch="bloom", vocab_size=c.vocab_size, hidden_size=D,
        n_layers=c.n_layer, n_heads=c.n_head, n_kv_heads=c.n_head,
        head_dim=D // c.n_head, intermediate_size=4 * D,
        norm_type="layernorm", norm_eps=c.layer_norm_epsilon,
        act="gelu_tanh", mlp_gated=False, mlp_bias=True,
        qkv_bias=True, o_bias=True,
        rope_style="none", use_alibi=True,
        tie_word_embeddings=True,
        max_seq_len=2048,
        bos_token_id=getattr(c, "bos_token_id", 1) or 1,
        eos_token_id=getattr(c, "eos_token_id", 2) or 2,
    )


def preprocess_state_dict(sd, cfg: ModelConfig):
    """Split each layer's fused query_key_value weight and bias."""
    for i in range(cfg.n_layers):
        base = f"transformer.h.{i}.self_attention.query_key_value."
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
    p = f"transformer.h.{i}."
    a = p + "self_attention.query_key_value."
    return {
        "attn_norm_w": (p + "input_layernorm.weight", False),
        "attn_norm_b": (p + "input_layernorm.bias", False),
        "wq": (a + "_q", True), "bq": (a + "_qb", False),
        "wk": (a + "_k", True), "bk": (a + "_kb", False),
        "wv": (a + "_v", True), "bv": (a + "_vb", False),
        "wo": (p + "self_attention.dense.weight", True),
        "bo": (p + "self_attention.dense.bias", False),
        "ffn_norm_w": (p + "post_attention_layernorm.weight", False),
        "ffn_norm_b": (p + "post_attention_layernorm.bias", False),
        "w_up": (p + "mlp.dense_h_to_4h.weight", True),
        "b_up": (p + "mlp.dense_h_to_4h.bias", False),
        "w_down": (p + "mlp.dense_4h_to_h.weight", True),
        "b_down": (p + "mlp.dense_4h_to_h.bias", False),
    }


def hf_top_map(cfg: ModelConfig):
    return {
        "embed": ("transformer.word_embeddings.weight", False),
        "embed_norm_w": ("transformer.word_embeddings_layernorm.weight",
                         False),
        "embed_norm_b": ("transformer.word_embeddings_layernorm.bias", False),
        "final_norm_w": ("transformer.ln_f.weight", False),
        "final_norm_b": ("transformer.ln_f.bias", False),
    }


QUANT_TENSORS = ("wq", "wk", "wv", "wo", "w_up", "w_down")
