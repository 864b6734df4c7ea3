"""Baichuan 7B and 13B: config and HF tensor maps (port of
``neural_tpu/models/baichuan.py``). Llama-like with the fused ``W_pack``
q/k/v, split here; 7B rotates with NeoX RoPE, 13B has no RoPE and takes
ALiBi. The checkpoints carry their own remote code: config.json must have
every field read here."""
from __future__ import annotations

from ._defuse import split_concat
from .config import ModelConfig


def config_from_hf(c) -> ModelConfig:
    D = c.hidden_size
    # Baichuan-13B: ALiBi, no RoPE; told by its position type or by its
    # width and length, as the JAX package tells it
    use_alibi = getattr(c, "position_embedding", "rope") == "alibi" or \
        getattr(c, "model_max_length", 4096) >= 8192 and D == 5120
    return ModelConfig(
        arch="baichuan", vocab_size=c.vocab_size, hidden_size=D,
        n_layers=c.num_hidden_layers, n_heads=c.num_attention_heads,
        n_kv_heads=c.num_attention_heads,
        head_dim=D // c.num_attention_heads,
        intermediate_size=c.intermediate_size,
        norm_type="rmsnorm", norm_eps=c.rms_norm_eps,
        act="silu", mlp_gated=True,
        rope_style="none" if use_alibi else "neox",
        use_alibi=use_alibi,
        max_seq_len=getattr(c, "model_max_length", 4096),
        bos_token_id=getattr(c, "bos_token_id", 1) or 1,
        eos_token_id=getattr(c, "eos_token_id", 2) or 2,
    )


def preprocess_state_dict(sd, cfg: ModelConfig):
    """Split each layer's fused W_pack weight."""
    for i in range(cfg.n_layers):
        base = f"model.layers.{i}.self_attn.W_pack."
        if base + "weight" not in sd:
            continue
        q, k, v = split_concat(sd.pop(base + "weight"), cfg.q_dim,
                               cfg.kv_dim)
        sd.update({base + "_q": q, base + "_k": k, base + "_v": v})
    return sd


def hf_layer_map(i: int, cfg: ModelConfig):
    """Our layer-param name → (HF tensor name, transpose?)."""
    p = f"model.layers.{i}."
    a = p + "self_attn.W_pack."
    return {
        "attn_norm_w": (p + "input_layernorm.weight", False),
        "wq": (a + "_q", True),
        "wk": (a + "_k", True),
        "wv": (a + "_v", True),
        "wo": (p + "self_attn.o_proj.weight", True),
        "ffn_norm_w": (p + "post_attention_layernorm.weight", False),
        "w_gate": (p + "mlp.gate_proj.weight", True),
        "w_up": (p + "mlp.up_proj.weight", True),
        "w_down": (p + "mlp.down_proj.weight", True),
    }


def hf_top_map(cfg: ModelConfig):
    return {
        "embed": ("model.embed_tokens.weight", False),
        "final_norm_w": ("model.norm.weight", False),
        "lm_head": ("lm_head.weight", True),
    }


QUANT_TENSORS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                 "lm_head")
