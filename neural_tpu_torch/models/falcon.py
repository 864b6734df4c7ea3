"""Falcon: config and HF tensor maps (port of
``neural_tpu/models/falcon.py``). Falcon-7B: multi-query attention and a
parallel residual with one shared LayerNorm; the new decoder architecture
of 40B/180B: grouped KV heads and a parallel residual whose MLP has its own
norm (``ln_attn`` / ``ln_mlp``). The fused ``query_key_value`` is split
here (``split_falcon``); the embedding is tied; exact GELU."""
from __future__ import annotations

from ._defuse import split_falcon
from .config import ModelConfig


def config_from_hf(c) -> ModelConfig:
    """Map a transformers FalconConfig (read as attributes)."""
    D = c.hidden_size
    H = c.num_attention_heads
    Dh = D // H
    new_arch = bool(getattr(c, "new_decoder_architecture", False))
    if new_arch:
        n_kv = c.num_kv_heads
    elif getattr(c, "multi_query", True):
        n_kv = 1
    else:
        n_kv = H
    return ModelConfig(
        arch="falcon", vocab_size=c.vocab_size, hidden_size=D,
        n_layers=c.num_hidden_layers, n_heads=H, n_kv_heads=n_kv,
        head_dim=Dh, intermediate_size=getattr(c, "ffn_hidden_size", 4 * D),
        norm_type="layernorm", norm_eps=c.layer_norm_epsilon,
        act="gelu", mlp_gated=False, mlp_bias=bool(c.bias),
        qkv_bias=bool(c.bias), o_bias=bool(c.bias),
        rope_style="neox", rope_theta=getattr(c, "rope_theta", 10000.0),
        parallel_residual=bool(getattr(c, "parallel_attn", True)),
        tie_word_embeddings=True,
        max_seq_len=getattr(c, "max_position_embeddings", 2048),
        bos_token_id=getattr(c, "bos_token_id", 11) or 11,
        eos_token_id=getattr(c, "eos_token_id", 11) or 11,
    )


def _is_new_arch(cfg: ModelConfig) -> bool:
    """The new decoder architecture, told from the config as the JAX
    package tells it: grouped KV (1 < n_kv < n_heads)."""
    return 1 < cfg.n_kv_heads < cfg.n_heads


def preprocess_state_dict(sd, cfg: ModelConfig):
    """Split each layer's query_key_value (and bias) and rename the new
    architecture's ln_attn / ln_mlp to the classic names."""
    new_arch = _is_new_arch(cfg) or "transformer.h.0.ln_attn.weight" in sd
    multi_query = cfg.n_kv_heads == 1
    for i in range(cfg.n_layers):
        base = f"transformer.h.{i}.self_attention.query_key_value."
        if base + "weight" not in sd:
            continue
        split = lambda w: split_falcon(w, cfg.n_heads, cfg.n_kv_heads,
                                       cfg.head_dim, new_arch, multi_query)
        q, k, v = split(sd.pop(base + "weight"))
        sd.update({base + "_q": q, base + "_k": k, base + "_v": v})
        if base + "bias" in sd:
            qb, kb, vb = split(sd.pop(base + "bias"))
            sd.update({base + "_qb": qb, base + "_kb": kb, base + "_vb": vb})
        p = f"transformer.h.{i}."
        if p + "ln_attn.weight" in sd:
            for new, old in (("input_layernorm", "ln_attn"),
                             ("post_attention_layernorm", "ln_mlp")):
                for leaf in ("weight", "bias"):
                    sd[f"{p}{new}.{leaf}"] = sd.pop(f"{p}{old}.{leaf}")
    return sd


def hf_layer_map(i: int, cfg: ModelConfig):
    """Our layer-param name → (HF tensor name, transpose?)."""
    p = f"transformer.h.{i}."
    a = p + "self_attention.query_key_value."
    m = {
        "attn_norm_w": (p + "input_layernorm.weight", False),
        "attn_norm_b": (p + "input_layernorm.bias", False),
        "wq": (a + "_q", True),
        "wk": (a + "_k", True),
        "wv": (a + "_v", True),
        "wo": (p + "self_attention.dense.weight", True),
        "w_up": (p + "mlp.dense_h_to_4h.weight", True),
        "w_down": (p + "mlp.dense_4h_to_h.weight", True),
    }
    if cfg.qkv_bias:
        m.update({"bq": (a + "_qb", False), "bk": (a + "_kb", False),
                  "bv": (a + "_vb", False),
                  "bo": (p + "self_attention.dense.bias", False),
                  "b_up": (p + "mlp.dense_h_to_4h.bias", False),
                  "b_down": (p + "mlp.dense_4h_to_h.bias", False)})
    if _is_new_arch(cfg):
        # the MLP's own norm (a parallel residual with two norms)
        m["ffn_norm_w"] = (p + "post_attention_layernorm.weight", False)
        m["ffn_norm_b"] = (p + "post_attention_layernorm.bias", False)
    return m


def hf_top_map(cfg: ModelConfig):
    return {
        "embed": ("transformer.word_embeddings.weight", False),
        "final_norm_w": ("transformer.ln_f.weight", False),
        "final_norm_b": ("transformer.ln_f.bias", False),
    }


QUANT_TENSORS = ("wq", "wk", "wv", "wo", "w_up", "w_down")
