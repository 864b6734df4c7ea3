"""The decoder graph, Llama subset (port of ``neural_tpu/models/transformer.py``
:41-225 and :359-714).

Embedding → per layer [RMS pre-norm → q/k/v → RoPE → cache append at each
row's ``start`` → GQA attention (f32, cast back to the activation dtype) →
output projection → residual → RMS pre-norm → SwiGLU MLP → residual] →
final norm → lm_head, optionally on one row per sequence
(``logit_positions``). Parameter names are the JAX package's.

The cache is a contiguous :class:`~neural_tpu_torch.runtime.kvcache.KVCache`
(bf16, or int8: the append quantizes with ``quantize_kv`` and writes the
scale rows too) or a paged
:class:`~neural_tpu_torch.runtime.paged.PagedKVCache` (the append goes
through ``paged_update_kv``, attention through ``attend_paged``), as in
``neural_tpu/models/transformer.py:462-494``.

Every projection is a :class:`QLinear`: a quantized weight at rest
(``core.qtensor.to_native``) or a bf16 one. A tied lm_head is a torch
product with the embedding, as the JAX package leaves it to XLA.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.qtensor import QTensor
from ..ops.attention import attend, quantize_kv
from ..ops.norms import rms_norm
from ..ops.paged_attention import attend_paged, paged_update_kv
from ..ops.qmatmul import qmatmul
from ..ops.rope import apply_rope, rope_cos_sin
from .config import ModelConfig

LINEARS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


class QLinear(nn.Module):
    """A ``[K, N]`` projection: a QTensor at rest (its planes, scales and
    zero-points as buffers, plus its QuantConfig) multiplied by
    :func:`~neural_tpu_torch.ops.qmatmul.qmatmul`, or an unquantized bf16
    weight (``weight_dtype=None``), a plain ``torch.matmul`` as the JAX
    package leaves it to XLA."""

    def __init__(self, w):
        super().__init__()
        if isinstance(w, torch.Tensor):
            self.cfg = None
            self.register_buffer("weight", w)
            return
        if w.perm is not None:
            raise NotImplementedError("act-order weights are a later slice")
        self.cfg = w.cfg
        self.n_planes = len(w.planes)
        for i, p in enumerate(w.planes):
            self.register_buffer("planes" if i == 0 else f"planes_{i}", p)
        self.register_buffer("scales", w.scales)
        self.register_buffer("zeros", w.zeros)

    @property
    def qt(self) -> QTensor:
        planes = tuple(getattr(self, "planes" if i == 0 else f"planes_{i}")
                       for i in range(self.n_planes))
        return QTensor(planes, self.scales, self.zeros, None, self.cfg)

    def forward(self, x: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        out_dtype = out_dtype or x.dtype
        if self.cfg is not None:
            return qmatmul(x, self.qt, out_dtype)
        if out_dtype == torch.float32:
            return x.to(torch.float32) @ self.weight.to(torch.float32)
        return torch.matmul(x.to(self.weight.dtype), self.weight).to(out_dtype)


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

    def forward(self, x, kv, positions, cos, sin):
        """x [B, T, D]; ``kv`` this layer's
        :class:`~neural_tpu_torch.runtime.kvcache.LayerKV`, written in place
        at ``positions`` [B, T]."""
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
        if kv.table is not None:
            paged_update_kv(kv.k, kv.v, kv.k_scale, kv.v_scale,
                            k.transpose(1, 2), v.transpose(1, 2), kv.table,
                            positions[:, 0])
            out = attend_paged(q, kv.k, kv.v, kv.k_scale, kv.v_scale,
                               kv.table, positions, cfg)
        else:
            rows = torch.arange(B, device=x.device)[:, None]
            if kv.k_scale is not None:
                k, ks = quantize_kv(k)                 # scales [B, T, Hkv]
                v, vs = quantize_kv(v)
                kv.k_scale[rows, :, positions] = ks
                kv.v_scale[rows, :, positions] = vs
            kv.k[rows, :, positions] = k.to(kv.k.dtype)
            kv.v[rows, :, positions] = v.to(kv.v.dtype)
            out = attend(q, kv.k, kv.v, positions, cfg, kv.k_scale,
                         kv.v_scale)
        out = out.to(x.dtype)
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
        :class:`~neural_tpu_torch.runtime.kvcache.KVCache` or
        :class:`~neural_tpu_torch.runtime.paged.PagedKVCache`, updated in
        place.
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
            x = blk(x, cache.layer(l), positions, cos, sin)
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
