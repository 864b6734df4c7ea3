"""ChatGLM 1/2/3 and GLM-4: config and HF tensor maps (port of
``neural_tpu/models/chatglm.py``; the checkpoints carry their own remote
code, so config.json must have every field read here).

v2/3/4: RMS norms, grouped multi-query attention (``multi_query_group_num``
KV heads) with the straight-concatenated fused QKV and its bias, a SwiGLU
MLP packed as one ``[2I, D]`` ``dense_h_to_4h`` (gate first), both split
here, and GPT-J-style (interleaved) RoPE on the first half of the head.

v1 (THUDM/chatglm-6b, told by ``position_encoding_2d``): the GLM
prefix-LM graph: LayerNorms with biases, the per-head-interleaved fused
QKV with its biases, biases on every projection, a non-gated tanh-GELU
MLP, DeepNorm residuals (alpha = sqrt(2L) on the normed branch input), the
2-D GLM RoPE on the two halves of the head, and bidirectional attention
over the prompt except its final token's key (``prefix_lm``).
"""
from __future__ import annotations

import numpy as np

from ._defuse import split_concat, split_interleaved, split_rows
from .config import ModelConfig


def config_from_hf(c) -> ModelConfig:
    """Map a ChatGLM config (read as attributes)."""
    if getattr(c, "position_encoding_2d", False):
        return _config_v1(c)
    D = c.hidden_size
    H = c.num_attention_heads
    Dh = D // H
    n_kv = (c.multi_query_group_num
            if getattr(c, "multi_query_attention", False) else H)
    return ModelConfig(
        arch="chatglm", vocab_size=c.padded_vocab_size,
        hidden_size=D, n_layers=c.num_layers, n_heads=H, n_kv_heads=n_kv,
        head_dim=Dh, intermediate_size=c.ffn_hidden_size,
        norm_type="rmsnorm", norm_eps=c.layernorm_epsilon,
        act="silu", mlp_gated=True,
        qkv_bias=bool(getattr(c, "add_qkv_bias", True)),
        rope_style="gptj",           # interleaved pairs
        rope_dim=Dh // 2,            # on the first half of the head
        rope_theta=10000.0 * getattr(c, "rope_ratio", 1.0),
        max_seq_len=getattr(c, "seq_length", 8192),
        bos_token_id=1, eos_token_id=2,
    )


def _config_v1(c) -> ModelConfig:
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


def _preprocess_v1(sd, cfg: ModelConfig):
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


def _layer_map_v1(i: int, cfg: ModelConfig):
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


def _top_map_v1(cfg: ModelConfig):
    return {
        "embed": ("transformer.word_embeddings.weight", False),
        "final_norm_w": ("transformer.final_layernorm.weight", False),
        "final_norm_b": ("transformer.final_layernorm.bias", False),
        "lm_head": ("lm_head.weight", True),
    }


def preprocess_state_dict(sd, cfg: ModelConfig):
    """Split each layer's fused q/k/v (v1: interleaved per head; v2/3:
    concatenated, with the bias) and v2/3's packed gate|up."""
    if cfg.arch == "chatglm1":
        return _preprocess_v1(sd, cfg)
    for i in range(cfg.n_layers):
        p = f"transformer.encoder.layers.{i}."
        qkv = p + "self_attention.query_key_value."
        if qkv + "weight" in sd:
            q, k, v = split_concat(sd.pop(qkv + "weight"), cfg.q_dim,
                                   cfg.kv_dim)
            sd.update({qkv + "_q": q, qkv + "_k": k, qkv + "_v": v})
            if qkv + "bias" in sd:
                qb, kb, vb = split_concat(sd.pop(qkv + "bias"), cfg.q_dim,
                                          cfg.kv_dim)
                sd.update({qkv + "_qb": qb, qkv + "_kb": kb,
                           qkv + "_vb": vb})
        h4 = p + "mlp.dense_h_to_4h.weight"
        if h4 in sd:
            g, u = split_rows(sd.pop(h4), cfg.intermediate_size)
            sd[p + "mlp._gate"], sd[p + "mlp._up"] = g, u
    return sd


def hf_layer_map(i: int, cfg: ModelConfig):
    """Our layer-param name → (HF tensor name, transpose?)."""
    if cfg.arch == "chatglm1":
        return _layer_map_v1(i, cfg)
    p = f"transformer.encoder.layers.{i}."
    a = p + "self_attention.query_key_value."
    m = {
        "attn_norm_w": (p + "input_layernorm.weight", False),
        "wq": (a + "_q", True),
        "wk": (a + "_k", True),
        "wv": (a + "_v", True),
        "wo": (p + "self_attention.dense.weight", True),
        "ffn_norm_w": (p + "post_attention_layernorm.weight", False),
        "w_gate": (p + "mlp._gate", True),
        "w_up": (p + "mlp._up", True),
        "w_down": (p + "mlp.dense_4h_to_h.weight", True),
    }
    if cfg.qkv_bias:
        m.update({"bq": (a + "_qb", False), "bk": (a + "_kb", False),
                  "bv": (a + "_vb", False)})
    return m


def hf_top_map(cfg: ModelConfig):
    if cfg.arch == "chatglm1":
        return _top_map_v1(cfg)
    return {
        "embed": ("transformer.embedding.word_embeddings.weight", False),
        "final_norm_w": ("transformer.encoder.final_layernorm.weight", False),
        "lm_head": ("transformer.output_layer.weight", True),
    }


QUANT_TENSORS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                 "lm_head")
