"""ChatGLM-1 (THUDM/chatglm-6b): config and HF tensor maps (port of the v1
part of ``neural_tpu/models/chatglm.py``).

The GLM prefix-LM graph: LayerNorms with biases, the per-head-interleaved
fused QKV with its biases, biases on every projection, a non-gated
tanh-GELU MLP, DeepNorm residuals (alpha = sqrt(2L) on the normed branch
input), the 2-D GLM RoPE on the two halves of the head, and bidirectional
attention over the prompt except its final token's key (``prefix_lm``).
ChatGLM-2/3 and GLM-4 (``position_encoding_2d`` absent) need the partial
interleaved RoPE and raise.
"""
from __future__ import annotations

import numpy as np

from ._defuse import split_interleaved
from .config import ModelConfig


def config_from_hf(c) -> ModelConfig:
    """Map a ChatGLM-1 config (read as attributes: the checkpoints carry
    their own remote code)."""
    if not getattr(c, "position_encoding_2d", False):
        raise NotImplementedError(
            "ChatGLM-2/3 and GLM-4 need the partial interleaved (gptj) RoPE, "
            "a later slice; the port runs ChatGLM-1")
    D = c.hidden_size
    H = c.num_attention_heads
    Dh = D // H
    return ModelConfig(
        arch="chatglm1", vocab_size=c.vocab_size,
        hidden_size=D, n_layers=c.num_layers, n_heads=H, n_kv_heads=H,
        head_dim=Dh,
        intermediate_size=getattr(c, "inner_hidden_size", 4 * D),
        norm_type="layernorm", norm_eps=c.layernorm_epsilon,
        act="gelu_tanh", mlp_gated=False, mlp_bias=True,
        qkv_bias=True, o_bias=True,
        rope_style="glm1", rope_dim=Dh // 2,
        prefix_lm=True,
        residual_alpha=float(np.sqrt(2.0 * c.num_layers)),
        max_seq_len=getattr(c, "max_sequence_length", 2048),
        bos_token_id=getattr(c, "bos_token_id", 130004),
        eos_token_id=getattr(c, "eos_token_id", 130005),
    )


def _check_v1(cfg: ModelConfig):
    if cfg.arch != "chatglm1":
        raise NotImplementedError(f"{cfg.arch!r}: the port runs ChatGLM-1 "
                                  "only")


def preprocess_state_dict(sd, cfg: ModelConfig):
    """Split each layer's fused query_key_value weight and bias."""
    _check_v1(cfg)
    for i in range(cfg.n_layers):
        base = f"transformer.layers.{i}.attention.query_key_value."
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
    _check_v1(cfg)
    p = f"transformer.layers.{i}."
    a = p + "attention.query_key_value."
    return {
        "attn_norm_w": (p + "input_layernorm.weight", False),
        "attn_norm_b": (p + "input_layernorm.bias", False),
        "wq": (a + "_q", True), "bq": (a + "_qb", False),
        "wk": (a + "_k", True), "bk": (a + "_kb", False),
        "wv": (a + "_v", True), "bv": (a + "_vb", False),
        "wo": (p + "attention.dense.weight", True),
        "bo": (p + "attention.dense.bias", False),
        "ffn_norm_w": (p + "post_attention_layernorm.weight", False),
        "ffn_norm_b": (p + "post_attention_layernorm.bias", False),
        "w_up": (p + "mlp.dense_h_to_4h.weight", True),
        "b_up": (p + "mlp.dense_h_to_4h.bias", False),
        "w_down": (p + "mlp.dense_4h_to_h.weight", True),
        "b_down": (p + "mlp.dense_4h_to_h.bias", False),
    }


def hf_top_map(cfg: ModelConfig):
    _check_v1(cfg)
    return {
        "embed": ("transformer.word_embeddings.weight", False),
        "final_norm_w": ("transformer.final_layernorm.weight", False),
        "final_norm_b": ("transformer.final_layernorm.bias", False),
        "lm_head": ("lm_head.weight", True),
    }


QUANT_TENSORS = ("wq", "wk", "wv", "wo", "w_up", "w_down", "lm_head")
