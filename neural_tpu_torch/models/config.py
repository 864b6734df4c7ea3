"""Unified decoder-transformer configuration.

The port's own copy of ``neural_tpu/models/config.py``, kept field for
field so one configuration describes a model in both packages. The port's
graph (models/transformer.py) implements every knob (norm offsets, GELU
and ReLU, post norms, embedding scale, softcaps, sliding window, LayerNorm
with or without bias, projection and lm_head biases, the non-gated MLP,
ALiBi, learned positions, NeoX and GPT-J RoPE on all or part of the head,
ChatGLM-1's 2-D GLM RoPE, prefix-LM mask and DeepNorm ``residual_alpha``,
parallel residuals, qk-norm, and the routed experts of ``n_experts`` /
``n_experts_active`` / ``moe_norm_topk``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32          # < n_heads → GQA; 1 → MQA (falcon)
    head_dim: int = 128
    intermediate_size: int = 11008

    # norms
    norm_type: str = "rmsnorm"    # "layernorm"
    norm_eps: float = 1e-5
    norm_offset: float = 0.0      # 1.0 → gemma (1+w)
    post_attn_norm: bool = False  # extra norm on attn output (gemma2-style)

    # mlp
    act: str = "silu"             # "gelu", "gelu_tanh", "relu"
    mlp_gated: bool = True        # llama w1/w3 gate ⊗ up; False → 2-layer MLP
    mlp_bias: bool = False

    # attention
    qkv_bias: bool = False        # qwen, phi, gptj-style archs with bias
    o_bias: bool = False
    attn_scale: Optional[float] = None  # default 1/sqrt(head_dim)
    use_alibi: bool = False       # mpt, bloom
    attn_softcap: float = 0.0     # grok/gemma2 tanh soft capping
    qk_norm: bool = False         # per-head q/k rmsnorm (some qwen2/stablelm)

    # positions
    rope_style: str = "neox"      # "gptj" interleaved, "none"
    rope_theta: float = 10000.0
    rope_dim: Optional[int] = None   # partial rotary (gptj/gptneox/phi/stablelm)
    rope_scaling: Optional[tuple] = None  # frozen dict items for hashability
    learned_pos_emb: bool = False  # opt, bloom? (bloom uses alibi), starcoder
    pos_offset: int = 0            # opt: +2

    # structure
    parallel_residual: bool = False  # gptj/gptneox/phi: attn+mlp share input
    tie_word_embeddings: bool = False
    embed_scale: float = 1.0      # gemma: sqrt(hidden)
    logit_softcap: float = 0.0
    final_norm: bool = True
    # ChatGLM v1 (GLM prefix-LM graph, reference models/chatglm/chatglm.cpp):
    # bidirectional attention over the prompt except its final token's key,
    # 2-D GLM RoPE (rope_style="glm1"), and DeepNorm-style residuals
    # x = alpha * norm_out + branch_out with alpha = sqrt(2 * n_layers).
    prefix_lm: bool = False
    residual_alpha: float = 1.0

    sliding_window: int = 0       # mistral/gemma2 local attention window
    post_ffn_norm: bool = False   # gemma2 post-feedforward norm

    # MoE (mixtral, grok)
    n_experts: int = 0
    n_experts_active: int = 0
    moe_norm_topk: bool = True    # renormalize top-k router probs

    # generation defaults
    max_seq_len: int = 4096
    bos_token_id: int = 1
    # ``eos_token_id`` may be passed as an int OR a list/tuple (HF
    # Llama-3-Instruct ships ``eos_token_id: [128001, 128009]`` — the
    # reference special-cases this at neural_speed/__init__.py:345-348 by
    # adding <|eot_id|> to the stop set). __post_init__ normalizes:
    # ``eos_token_id`` stays the primary int (GGUF writer, back-compat),
    # any remaining ids land in ``extra_eos_ids``, and the
    # ``eos_token_ids`` property is the full stop set used by every
    # stop/mask check. Storing only the EXTRAS keeps
    # ``dataclasses.replace(cfg, eos_token_id=x)`` well-behaved (the old
    # primary does not linger in the stop set). All jit-static-safe.
    eos_token_id: int = 2
    extra_eos_ids: tuple = ()

    # decode-attention S-block size (kernel tuning; None → 512). Small
    # fills want small blocks (DMA tracks fill at block granularity),
    # large fills want large blocks (fewer serialized online-softmax grid
    # steps). decode_loop sets it from its fill hint; measured crossover
    # ~384 on v5e (scripts/exp_attn_blk.py).
    decode_blk_s: Optional[int] = None

    def __post_init__(self):
        if isinstance(self.rope_scaling, dict):
            object.__setattr__(self, "rope_scaling",
                               tuple(sorted(self.rope_scaling.items())))
        # Normalize eos: accept int | list | tuple in eos_token_id; the
        # primary stays an int, the rest merge into extra_eos_ids.
        eid = self.eos_token_id
        if isinstance(eid, (list, tuple)):
            ids = tuple(int(t) for t in eid) or (2,)
            object.__setattr__(self, "eos_token_id", ids[0])
        else:
            ids = (int(eid),)
        extra = tuple(int(t) for t in (self.extra_eos_ids or ()))
        # Llama-3 (vocab 128256): <|eot_id|> (128009) always terminates a
        # chat turn even when the checkpoint lists only <|end_of_text|>.
        # Applied HERE so every load path agrees — HF, GGUF, and NTPU
        # checkpoint reload (the round-5 HF-only placement left
        # GGUF-loaded Llama-3 running past <|eot_id|>). Reference:
        # neural_speed/__init__.py:423-434 __get_special_eos_id.
        if self.arch in ("llama", "mistral", "mixtral") \
                and self.vocab_size == 128256:
            extra = extra + (128009,)
        extra = tuple(dict.fromkeys(ids[1:] + extra))  # ordered de-dup
        object.__setattr__(self, "extra_eos_ids",
                           tuple(t for t in extra if t != ids[0]))

    @property
    def eos_token_ids(self) -> tuple:
        """Full stop set: primary eos + arch/checkpoint extras."""
        return (self.eos_token_id,) + self.extra_eos_ids

    @property
    def rope_scaling_dict(self) -> Optional[Dict[str, Any]]:
        return dict(self.rope_scaling) if self.rope_scaling else None

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0
