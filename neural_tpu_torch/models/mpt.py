"""MPT: config and HF tensor maps (port of ``neural_tpu/models/mpt.py``).
ALiBi attention with no rotary positions, LayerNorms without bias, a
straight-concat fused Wqkv, no biases, a non-gated exact-GELU MLP, tied
embeddings."""
from __future__ import annotations

from ._defuse import split_concat
from .config import ModelConfig


def config_from_hf(c) -> ModelConfig:
    """Map a transformers MptConfig (read as attributes, so no import of
    transformers is needed)."""
    D = c.d_model
    attn_cfg = getattr(c, "attn_config", None)
    get = (attn_cfg.__dict__.get if hasattr(attn_cfg, "__dict__")
           else (attn_cfg or {}).get)
    kv_heads = get("kv_n_heads", c.n_heads) or c.n_heads
    return ModelConfig(
        arch="mpt", vocab_size=c.vocab_size, hidden_size=D,
        n_layers=c.n_layers, n_heads=c.n_heads, n_kv_heads=kv_heads,
        head_dim=D // c.n_heads,
        intermediate_size=int(c.expansion_ratio * D),
        norm_type="layernorm", norm_eps=1e-5,
        act="gelu", mlp_gated=False,
        rope_style="none", use_alibi=bool(get("alibi", True)),
        tie_word_embeddings=True,
        max_seq_len=c.max_seq_len,
        bos_token_id=0, eos_token_id=0,
    )


def preprocess_state_dict(sd, cfg: ModelConfig):
    """Split each layer's fused Wqkv weight."""
    for i in range(cfg.n_layers):
        base = f"transformer.blocks.{i}.attn.Wqkv."
        if base + "weight" not in sd:
            continue
        q, k, v = split_concat(sd.pop(base + "weight"), cfg.q_dim,
                               cfg.kv_dim)
        sd.update({base + "_q": q, base + "_k": k, base + "_v": v})
    return sd


def hf_layer_map(i: int, cfg: ModelConfig):
    """Our layer-param name → (HF tensor name, transpose?)."""
    p = f"transformer.blocks.{i}."
    a = p + "attn.Wqkv."
    return {
        "attn_norm_w": (p + "norm_1.weight", False),
        "wq": (a + "_q", True),
        "wk": (a + "_k", True),
        "wv": (a + "_v", True),
        "wo": (p + "attn.out_proj.weight", True),
        "ffn_norm_w": (p + "norm_2.weight", False),
        "w_up": (p + "ffn.up_proj.weight", True),
        "w_down": (p + "ffn.down_proj.weight", True),
    }


def hf_top_map(cfg: ModelConfig):
    return {
        "embed": ("transformer.wte.weight", False),
        "final_norm_w": ("transformer.norm_f.weight", False),
    }


QUANT_TENSORS = ("wq", "wk", "wv", "wo", "w_up", "w_down")
