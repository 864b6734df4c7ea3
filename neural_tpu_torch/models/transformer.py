"""The decoder graph, Llama subset (port of ``neural_tpu/models/transformer.py``
:41-225 and :359-714).

Embedding → per layer [RMS pre-norm → q/k/v → RoPE → cache append at each
row's ``start`` → GQA attention (f32, cast back to the activation dtype) →
output projection → residual → RMS pre-norm → SwiGLU MLP → residual] →
final norm → lm_head, optionally on one row per sequence
(``logit_positions``). Parameter names are the JAX package's.

Every projection is a :class:`QLinear` holding the at-rest native-pack
buffers; bf16 (unquantized) projections are a later slice. A tied lm_head
is a torch product with the embedding, as the JAX package leaves it to
XLA.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.qtensor import QTensor
from ..ops.attention import attend
from ..ops.norms import rms_norm
from ..ops.qmatmul import qmatmul
from ..ops.rope import apply_rope, rope_cos_sin
from .config import ModelConfig

LINEARS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


class QLinear(nn.Module):
    """A quantized ``[K, N]`` weight at rest: ``planes`` (uint8 [K/2, N]
    native-pack nibbles) and ``scales`` (bf16 [G, N]) buffers plus its
    QuantConfig."""

    def __init__(self, qt: QTensor):
        super().__init__()
        if len(qt.planes) != 1 or not qt.cfg.native_pack:
            raise ValueError("QLinear holds the native-pack layout; convert "
                             "with core.qtensor.to_native_packed first")
        if qt.perm is not None or qt.zeros is not None:
            raise NotImplementedError(
                "asymmetric and act-order weights are a later slice")
        self.cfg = qt.cfg
        self.register_buffer("planes", qt.planes[0])
        self.register_buffer("scales", qt.scales)

    @property
    def qt(self) -> QTensor:
        return QTensor((self.planes,), self.scales, None, None, self.cfg)

    def forward(self, x: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return qmatmul(x, self.qt, out_dtype)


class LlamaBlock(nn.Module):
    """One decoder layer. ``weights`` maps the JAX names to QTensors (the
    projections) and tensors (the norm weights)."""

    def __init__(self, cfg: ModelConfig, weights: Dict[str, object]):
        super().__init__()
        self.cfg = cfg
        for name in LINEARS:
            setattr(self, name, QLinear(weights[name]))
        self.register_buffer("attn_norm_w", weights["attn_norm_w"])
        self.register_buffer("ffn_norm_w", weights["ffn_norm_w"])

    def forward(self, x, k_layer, v_layer, positions, cos, sin):
        """x [B, T, D]; k_layer/v_layer this layer's cache [B, Hkv, S, Dh],
        written in place at ``positions`` [B, T]."""
        cfg = self.cfg
        B, T, _ = x.shape
        Dh = cfg.head_dim
        h = rms_norm(x, self.attn_norm_w, cfg.norm_eps, cfg.norm_offset)
        q = self.wq(h).reshape(B, T, -1, Dh)
        k = self.wk(h).reshape(B, T, -1, Dh)
        v = self.wv(h).reshape(B, T, -1, Dh)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        # append only the new tokens, at each row's own offset (no host
        # sync: the positions stay on the device)
        rows = torch.arange(B, device=x.device)[:, None]
        k_layer[rows, :, positions] = k.to(k_layer.dtype)
        v_layer[rows, :, positions] = v.to(v_layer.dtype)
        out = attend(q, k_layer, v_layer, positions, cfg).to(x.dtype)
        x = x + self.wo(out)
        h2 = rms_norm(x, self.ffn_norm_w, cfg.norm_eps, cfg.norm_offset)
        return x + self.w_down(F.silu(self.w_gate(h2)) * self.w_up(h2))


class Transformer(nn.Module):
    """The Llama decoder: ``embed``, ``layers``, ``final_norm_w``,
    ``lm_head`` (absent when tied to the embedding) and the RoPE table."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, object]):
        super().__init__()
        unsupported = [n for n, on in (
            ("arch", cfg.arch not in ("llama", "mistral")),
            ("norm_type", cfg.norm_type != "rmsnorm"),
            ("act", cfg.act != "silu"), ("mlp_gated", not cfg.mlp_gated),
            ("biases", cfg.qkv_bias or cfg.o_bias or cfg.mlp_bias),
            ("qk_norm", cfg.qk_norm), ("rope_style", cfg.rope_style != "neox"),
            ("rope_dim", cfg.rope_dim is not None),
            ("learned_pos_emb", cfg.learned_pos_emb),
            ("parallel_residual", cfg.parallel_residual),
            ("embed_scale", cfg.embed_scale != 1.0),
            ("logit_softcap", cfg.logit_softcap),
            ("final_norm", not cfg.final_norm),
            ("post_norms", cfg.post_attn_norm or cfg.post_ffn_norm),
            ("residual_alpha", cfg.residual_alpha != 1.0),
            ("moe", cfg.is_moe)) if on]
        if unsupported:
            raise NotImplementedError(
                f"graph features {unsupported} belong to the model-zoo slice")
        self.cfg = cfg
        self.layers = nn.ModuleList(LlamaBlock(cfg, lp)
                                    for lp in params["layers"])
        self.register_buffer("embed", params["embed"])
        self.register_buffer("final_norm_w", params["final_norm_w"])
        self.register_buffer("rope_inv_freqs", params["rope_inv_freqs"])
        lm_head = params.get("lm_head")
        self.lm_head = None if lm_head is None else QLinear(lm_head)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens: torch.Tensor, start: torch.Tensor, cache,
                logits_dtype: torch.dtype = torch.float32,
                logit_positions: Optional[torch.Tensor] = None):
        """tokens [B, T]; start [B] (cache write offset per row); cache a
        :class:`~neural_tpu_torch.runtime.kvcache.KVCache`, updated in place.
        ``logit_positions`` [B]: the one token per row whose logits are
        wanted — the lm_head then runs on [B, 1, D]. Returns logits
        [B, T, V] (or [B, 1, V])."""
        cfg = self.cfg
        B, T = tokens.shape
        positions = start[:, None].long() + torch.arange(
            T, device=tokens.device)[None, :]
        x = self.embed[tokens.long()].to(torch.bfloat16)
        cos, sin = rope_cos_sin(positions, self.rope_inv_freqs)
        for l, blk in enumerate(self.layers):
            x = blk(x, cache.k[l], cache.v[l], positions, cos, sin)
        if logit_positions is not None:
            rows = torch.arange(B, device=x.device)[:, None]
            x = x[rows, logit_positions.long()[:, None]]
        x = rms_norm(x, self.final_norm_w, cfg.norm_eps, cfg.norm_offset)
        if self.lm_head is None:          # tied embeddings
            logits = x.to(torch.float32) @ self.embed.to(torch.bfloat16) \
                .to(torch.float32).T
        else:
            logits = self.lm_head(x, torch.float32)
        return logits.to(torch.float32).to(logits_dtype)
