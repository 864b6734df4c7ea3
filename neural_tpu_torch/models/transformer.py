"""The decoder graph, Llama and Gemma 1/2 subset (port of
``neural_tpu/models/transformer.py`` :41-225 and :359-714).

Embedding (times Gemma's bf16 embedding scale) → per layer [RMS pre-norm →
q/k/v → RoPE → cache append at each row's ``start`` → GQA attention (f32,
cast back to the activation dtype; the config's softcap, the layer's
sliding window) → output projection → (post-attention norm) → residual →
RMS pre-norm → gated MLP (SiLU or tanh GELU) → (post-FFN norm) → residual]
→ final norm → lm_head (then Gemma-2's final softcap, in f32), optionally
on one row per sequence (``logit_positions``). RMS norms scale by
``w + norm_offset`` (Gemma: 1 + w). Parameter names are the JAX
package's.

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

from functools import partial
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
ACTS = {"silu": F.silu, "gelu_tanh": partial(F.gelu, approximate="tanh")}


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


class Block(nn.Module):
    """One decoder layer. ``weights`` maps the JAX names to QTensors (the
    projections), tensors (the norm weights) and, for Gemma-2, the 0-d
    bool ``use_sliding`` flag."""

    def __init__(self, cfg: ModelConfig, weights: Dict[str, object]):
        super().__init__()
        self.cfg = cfg
        for name in LINEARS:
            setattr(self, name, QLinear(weights[name]))
        norms = ["attn_norm_w", "ffn_norm_w"]
        norms += ["post_attn_norm_w"] if cfg.post_attn_norm else []
        norms += ["post_ffn_norm_w"] if cfg.post_ffn_norm else []
        for name in norms:
            self.register_buffer(name, weights[name])
        self.act = ACTS[cfg.act]
        flag = weights.get("use_sliding")
        if flag is not None:
            self.register_buffer("use_sliding", flag)
        # the layer's sliding window, read here once as a Python int: a
        # device flag read in forward would sync the host inside the
        # decode step's CUDA graph. Without a per-layer flag the config's
        # window holds for every layer, as in the JAX package.
        self.window = cfg.sliding_window \
            if flag is None or bool(flag) else 0

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
                               kv.table, positions, cfg, self.window)
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
                         kv.v_scale, self.window)
        out = self.wo(out.to(x.dtype))
        if cfg.post_attn_norm:
            out = rms_norm(out, self.post_attn_norm_w, cfg.norm_eps,
                           cfg.norm_offset)
        x = x + out
        h2 = rms_norm(x, self.ffn_norm_w, cfg.norm_eps, cfg.norm_offset)
        mlp = self.w_down(self.act(self.w_gate(h2)) * self.w_up(h2))
        if cfg.post_ffn_norm:
            mlp = rms_norm(mlp, self.post_ffn_norm_w, cfg.norm_eps,
                           cfg.norm_offset)
        return x + mlp


class Transformer(nn.Module):
    """The decoder: ``embed``, ``layers``, ``final_norm_w``, ``lm_head``
    (absent when tied to the embedding) and the RoPE table."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, object]):
        super().__init__()
        unsupported = [n for n, on in (
            ("arch", cfg.arch not in ("llama", "mistral", "gemma",
                                      "gemma2")),
            ("norm_type", cfg.norm_type != "rmsnorm"),
            ("act", cfg.act not in ACTS), ("mlp_gated", not cfg.mlp_gated),
            ("biases", cfg.qkv_bias or cfg.o_bias or cfg.mlp_bias),
            ("qk_norm", cfg.qk_norm), ("rope_style", cfg.rope_style != "neox"),
            ("rope_dim", cfg.rope_dim is not None),
            ("learned_pos_emb", cfg.learned_pos_emb),
            ("parallel_residual", cfg.parallel_residual),
            ("final_norm", not cfg.final_norm),
            ("residual_alpha", cfg.residual_alpha != 1.0),
            ("moe", cfg.is_moe)) if on]
        if unsupported:
            raise NotImplementedError(
                f"graph features {unsupported} belong to the model-zoo slice")
        self.cfg = cfg
        self.layers = nn.ModuleList(Block(cfg, lp)
                                    for lp in params["layers"])
        # the JAX package multiplies the bf16 embedding rows by the scale
        # as a bf16 scalar: sqrt(3584) = 59.87 rounds to 60.0. A Python
        # float keeps the multiply free of a host-to-device copy.
        self.embed_scale = float(torch.tensor(cfg.embed_scale,
                                              dtype=torch.bfloat16))
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
        if self.embed_scale != 1.0:
            x = x * self.embed_scale
        cos, sin = rope_cos_sin(positions, self.rope_inv_freqs)
        for l, blk in enumerate(self.layers):
            x = blk(x, cache.layer(l), positions, cos, sin)
        if logit_positions is not None:
            rows = torch.arange(B, device=x.device)[:, None]
            x = x[rows, logit_positions.long()[:, None]]
        x = rms_norm(x, self.final_norm_w, cfg.norm_eps, cfg.norm_offset)
        if self.lm_head is None:          # tied embeddings
            logits = self._tied_logits(x)
        else:
            logits = self.lm_head(x, torch.float32)
        logits = logits.to(torch.float32)
        if cfg.logit_softcap:
            logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
        return logits.to(logits_dtype)

    def _tied_logits(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., D] @ embed.T with bf16 operands and f32 sums, as the JAX
        package's ``jnp.dot(..., preferred_element_type=f32)``. On the card
        one ``torch.mm`` with ``out_dtype`` (aten::mm.dtype) reads the bf16
        embedding in place; an f32 copy of it would be 3.67 GB per call at
        Gemma-2-9B's vocab, captured into the decode graph's pool. That
        overload does not exist for the CPU, where the product is taken in
        f32 on f32 copies (exact for bf16 operands, as the card's f32 sums)."""
        xb = x.to(torch.bfloat16)
        if x.device.type == "cuda":
            out = torch.mm(xb.reshape(-1, xb.shape[-1]), self.embed.T,
                           out_dtype=torch.float32)
            return out.reshape(*x.shape[:-1], -1)
        return xb.to(torch.float32) @ self.embed.to(torch.float32).T
