"""StarCoder / GPT-BigCode: config and HF tensor maps (port of
``neural_tpu/models/starcoder.py``). Multi-query attention through the
straight-concatenated ``c_attn`` with its bias, split here; learned
position embeddings; LayerNorms with biases; biases on every projection; a
tanh-GELU MLP; a tied embedding."""
from __future__ import annotations

from ._defuse import split_concat
from .config import ModelConfig


def config_from_hf(c) -> ModelConfig:
    """Map a transformers GPTBigCodeConfig (read as attributes)."""
    D = c.n_embd
    H = c.n_head
    return ModelConfig(
        arch="gpt_bigcode", vocab_size=c.vocab_size, hidden_size=D,
        n_layers=c.n_layer, n_heads=H,
        n_kv_heads=1 if c.multi_query else H,
        head_dim=D // H, intermediate_size=c.n_inner or 4 * D,
        norm_type="layernorm", norm_eps=c.layer_norm_epsilon,
        act="gelu_tanh", mlp_gated=False, mlp_bias=True,
        qkv_bias=True, o_bias=True,
        rope_style="none", learned_pos_emb=True,
        tie_word_embeddings=True,
        max_seq_len=c.n_positions,
        bos_token_id=getattr(c, "bos_token_id", 0) or 0,
        eos_token_id=getattr(c, "eos_token_id", 0) or 0,
    )


def preprocess_state_dict(sd, cfg: ModelConfig):
    """Split each layer's fused c_attn weight and bias."""
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
    p = f"transformer.h.{i}."
    a = p + "attn.c_attn."
    return {
        "attn_norm_w": (p + "ln_1.weight", False),
        "attn_norm_b": (p + "ln_1.bias", False),
        "wq": (a + "_q", True), "bq": (a + "_qb", False),
        "wk": (a + "_k", True), "bk": (a + "_kb", False),
        "wv": (a + "_v", True), "bv": (a + "_vb", False),
        "wo": (p + "attn.c_proj.weight", True),
        "bo": (p + "attn.c_proj.bias", False),
        "ffn_norm_w": (p + "ln_2.weight", False),
        "ffn_norm_b": (p + "ln_2.bias", False),
        "w_up": (p + "mlp.c_fc.weight", True),
        "b_up": (p + "mlp.c_fc.bias", False),
        "w_down": (p + "mlp.c_proj.weight", True),
        "b_down": (p + "mlp.c_proj.bias", False),
    }


def hf_top_map(cfg: ModelConfig):
    return {
        "embed": ("transformer.wte.weight", False),
        "pos_embed": ("transformer.wpe.weight", False),
        "final_norm_w": ("transformer.ln_f.weight", False),
        "final_norm_b": ("transformer.ln_f.bias", False),
    }


QUANT_TENSORS = ("wq", "wk", "wv", "wo", "w_up", "w_down")
