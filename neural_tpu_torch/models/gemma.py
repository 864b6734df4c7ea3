"""Gemma 1/2: config and HF tensor maps (port of
``neural_tpu/models/gemma.py``). (1+w) RMS norms, a sqrt(D) embedding scale,
tied embeddings, a head dim apart from hidden / heads; Gemma-2 adds pre/post
FFN norms, the post-attention norm, the attention and final logit softcaps,
``query_pre_attn_scalar`` as the attention scale, and sliding-window
attention on the even layers."""
from __future__ import annotations

import numpy as np

from .config import ModelConfig


def config_from_hf(c) -> ModelConfig:
    """Map a transformers GemmaConfig / Gemma2Config (read as attributes,
    so no import of transformers is needed)."""
    mt = getattr(c, "model_type", "gemma")
    D = c.hidden_size
    common = dict(
        vocab_size=c.vocab_size, hidden_size=D,
        n_layers=c.num_hidden_layers, n_heads=c.num_attention_heads,
        n_kv_heads=c.num_key_value_heads, head_dim=c.head_dim,
        intermediate_size=c.intermediate_size,
        norm_type="rmsnorm", norm_eps=c.rms_norm_eps, norm_offset=1.0,
        act="gelu_tanh", mlp_gated=True,
        rope_style="neox", rope_theta=c.rope_theta,
        tie_word_embeddings=True,
        embed_scale=float(np.sqrt(D)),
        max_seq_len=c.max_position_embeddings,
        bos_token_id=getattr(c, "bos_token_id", 2) or 2,
        eos_token_id=getattr(c, "eos_token_id", 1) or 1,
    )
    if mt == "gemma2":
        return ModelConfig(
            arch="gemma2",
            post_attn_norm=True, post_ffn_norm=True,
            attn_softcap=float(getattr(c, "attn_logit_softcapping", 0) or 0),
            logit_softcap=float(getattr(c, "final_logit_softcapping", 0) or 0),
            attn_scale=float(getattr(c, "query_pre_attn_scalar",
                                     c.head_dim)) ** -0.5,
            sliding_window=int(getattr(c, "sliding_window", 0) or 0),
            **common)
    return ModelConfig(arch="gemma", **common)


def layer_flags(cfg: ModelConfig):
    """Per-layer flags, stacked [L]: Gemma-2 alternates sliding (even) and
    global (odd) layers."""
    if cfg.arch == "gemma2" and cfg.sliding_window:
        return {"use_sliding": np.asarray(
            [i % 2 == 0 for i in range(cfg.n_layers)])}
    return {}


def hf_layer_map(i: int, cfg: ModelConfig):
    """Our layer-param name → (HF tensor name, transpose?)."""
    p = f"model.layers.{i}."
    m = {
        "attn_norm_w": (p + "input_layernorm.weight", False),
        "wq": (p + "self_attn.q_proj.weight", True),
        "wk": (p + "self_attn.k_proj.weight", True),
        "wv": (p + "self_attn.v_proj.weight", True),
        "wo": (p + "self_attn.o_proj.weight", True),
        "w_gate": (p + "mlp.gate_proj.weight", True),
        "w_up": (p + "mlp.up_proj.weight", True),
        "w_down": (p + "mlp.down_proj.weight", True),
    }
    if cfg.arch == "gemma2":
        m["post_attn_norm_w"] = (p + "post_attention_layernorm.weight", False)
        m["ffn_norm_w"] = (p + "pre_feedforward_layernorm.weight", False)
        m["post_ffn_norm_w"] = (p + "post_feedforward_layernorm.weight", False)
    else:
        m["ffn_norm_w"] = (p + "post_attention_layernorm.weight", False)
    return m


def hf_top_map(cfg: ModelConfig):
    return {
        "embed": ("model.embed_tokens.weight", False),
        "final_norm_w": ("model.norm.weight", False),
    }


QUANT_TENSORS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
