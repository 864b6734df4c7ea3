"""GPT-J: config and HF tensor maps (port of ``neural_tpu/models/gptj.py``).
A parallel residual with one shared LayerNorm, GPT-J (interleaved) RoPE on
the first ``rotary_dim`` of the head, bias-free q/k/v/o, a biased tanh-GELU
MLP and a biased lm_head."""
from __future__ import annotations

from .config import ModelConfig


def config_from_hf(c) -> ModelConfig:
    """Map a transformers GPTJConfig (read as attributes)."""
    D = c.n_embd
    return ModelConfig(
        arch="gptj", vocab_size=c.vocab_size, hidden_size=D,
        n_layers=c.n_layer, n_heads=c.n_head, n_kv_heads=c.n_head,
        head_dim=D // c.n_head,
        intermediate_size=c.n_inner or 4 * D,
        norm_type="layernorm", norm_eps=c.layer_norm_epsilon,
        act="gelu_tanh", mlp_gated=False, mlp_bias=True,
        rope_style="gptj", rope_dim=c.rotary_dim,
        parallel_residual=True,
        max_seq_len=c.n_positions,
        bos_token_id=getattr(c, "bos_token_id", 50256) or 50256,
        eos_token_id=getattr(c, "eos_token_id", 50256) or 50256,
    )


def hf_layer_map(i: int, cfg: ModelConfig):
    """Our layer-param name → (HF tensor name, transpose?): no ffn_norm,
    the MLP reads ln_1's output too."""
    p = f"transformer.h.{i}."
    return {
        "attn_norm_w": (p + "ln_1.weight", False),
        "attn_norm_b": (p + "ln_1.bias", False),
        "wq": (p + "attn.q_proj.weight", True),
        "wk": (p + "attn.k_proj.weight", True),
        "wv": (p + "attn.v_proj.weight", True),
        "wo": (p + "attn.out_proj.weight", True),
        "w_up": (p + "mlp.fc_in.weight", True),
        "b_up": (p + "mlp.fc_in.bias", False),
        "w_down": (p + "mlp.fc_out.weight", True),
        "b_down": (p + "mlp.fc_out.bias", False),
    }


def hf_top_map(cfg: ModelConfig):
    return {
        "embed": ("transformer.wte.weight", False),
        "final_norm_w": ("transformer.ln_f.weight", False),
        "final_norm_b": ("transformer.ln_f.bias", False),
        "lm_head": ("lm_head.weight", True),
        "lm_head_b": ("lm_head.bias", False),
    }


QUANT_TENSORS = ("wq", "wk", "wv", "wo", "w_up", "w_down", "lm_head")
