"""The decoder graph, Llama, Gemma 1/2, Bloom, MPT and ChatGLM-1 subset
(port of ``neural_tpu/models/transformer.py`` :41-225 and :359-714).

Embedding (times Gemma's bf16 embedding scale; then Bloom's embedding
LayerNorm) → per layer [pre-norm → q/k/v (+ biases) → RoPE (NeoX, the 2-D
GLM one of ChatGLM-1, or none under ALiBi) → cache append at each row's
``start`` → GQA attention (f32, cast back to the activation dtype; the
config's softcap, the layer's sliding window, the ALiBi slopes, the GLM
prefix mask) → output projection (+ bias) → (post-attention norm) →
residual → pre-norm → gated MLP (SiLU or tanh GELU) or ``w_down(act(w_up
h))`` (+ biases; exact or tanh GELU) → (post-FFN norm) → residual] → final
norm → lm_head (then Gemma-2's final softcap, in f32), optionally on one
row per sequence (``logit_positions``). Norms are RMS (scaled by ``w +
norm_offset``, Gemma: 1 + w) or LayerNorm with an optional bias. ChatGLM-1's
DeepNorm residual takes the normed branch input times ``residual_alpha``
as its base. Biases are added in the output's dtype after the product, as
the JAX package's ``linear`` does. Parameter names are the JAX package's.

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
from ..ops.norms import layer_norm, rms_norm
from ..ops.paged_attention import attend_paged, paged_update_kv
from ..ops.qmatmul import qmatmul
from ..ops.rope import apply_glm1, apply_rope, glm1_cos_sin, rope_cos_sin
from .config import ModelConfig

LINEARS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
BIASES = ("bq", "bk", "bv", "bo", "b_gate", "b_up", "b_down")
# the fused q|k|v and gate|up projections of ``runtime.generate.
# fuse_layer_weights``, and their biases
FUSED = ("wqkv", "w_gateup")
FUSED_BIASES = ("bqkv", "b_gateup")
NORMS = ("attn_norm", "ffn_norm", "post_attn_norm", "post_ffn_norm")
ACTS = {"silu": F.silu, "gelu": F.gelu,
        "gelu_tanh": partial(F.gelu, approximate="tanh")}
ARCHS = ("llama", "mistral", "gemma", "gemma2", "bloom", "mpt", "chatglm1")


def bf16_scalar(v: float) -> float:
    """A scale as the JAX package applies it, a bf16 scalar: sqrt(3584) =
    59.87 becomes 60.0, sqrt(56) = 7.483 becomes 7.46875. A Python float
    keeps the multiply free of a host-to-device copy."""
    return float(torch.tensor(v, dtype=torch.bfloat16))


class QLinear(nn.Module):
    """A ``[K, N]`` projection: a QTensor at rest (its planes, scales,
    zero-points and act-order ``perm`` as buffers, plus its QuantConfig)
    multiplied by :func:`~neural_tpu_torch.ops.qmatmul.qmatmul`, or an
    unquantized bf16 weight (``weight_dtype=None``), a plain
    ``torch.matmul`` as the JAX package leaves it to XLA."""

    def __init__(self, w):
        super().__init__()
        if isinstance(w, torch.Tensor):
            self.cfg = None
            self.register_buffer("weight", w)
            return
        self.cfg = w.cfg
        self.n_planes = len(w.planes)
        for i, p in enumerate(w.planes):
            self.register_buffer("planes" if i == 0 else f"planes_{i}", p)
        self.register_buffer("scales", w.scales)
        self.register_buffer("zeros", w.zeros)
        self.register_buffer("perm", w.perm)

    @property
    def qt(self) -> QTensor:
        planes = tuple(getattr(self, "planes" if i == 0 else f"planes_{i}")
                       for i in range(self.n_planes))
        return QTensor(planes, self.scales, self.zeros, self.perm, self.cfg)

    def forward(self, x: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        out_dtype = out_dtype or x.dtype
        if self.cfg is not None:
            return qmatmul(x, self.qt, out_dtype)
        if out_dtype == torch.float32 and x.device.type == "cuda" \
                and self.weight.dtype == torch.bfloat16:
            # bf16 operands, f32 sums, one product: no f32 copy of the
            # weight per call (an untied 32000-row lm_head would be 0.5 GB)
            x2 = x.reshape(-1, x.shape[-1]).to(self.weight.dtype)
            return torch.mm(x2, self.weight, out_dtype=torch.float32) \
                .reshape(*x.shape[:-1], -1)
        if out_dtype == torch.float32:
            return x.to(torch.float32) @ self.weight.to(torch.float32)
        return torch.matmul(x.to(self.weight.dtype), self.weight).to(out_dtype)


class Block(nn.Module):
    """One decoder layer. ``weights`` maps the JAX names to QTensors (the
    projections, or the fused ``wqkv`` / ``w_gateup`` of
    ``fuse_layer_weights``, whose outputs are split after the product, as
    in ``neural_tpu/models/transformer.py``), tensors (norm weights and
    biases, projection biases) and, for Gemma-2, the 0-d bool
    ``use_sliding`` flag."""

    def __init__(self, cfg: ModelConfig, weights: Dict[str, object]):
        super().__init__()
        self.cfg = cfg
        for name in LINEARS + FUSED:
            if name in weights:
                setattr(self, name, QLinear(weights[name]))
        self.fused_qkv = "wqkv" in weights
        self.fused_gateup = "w_gateup" in weights
        norms = ["attn_norm", "ffn_norm"]
        norms += ["post_attn_norm"] if cfg.post_attn_norm else []
        norms += ["post_ffn_norm"] if cfg.post_ffn_norm else []
        for name in norms:
            self.register_buffer(name + "_w", weights[name + "_w"])
        for name in [n + "_b" for n in NORMS] + list(BIASES + FUSED_BIASES):
            # a bias the family does not have is None: added nowhere
            self.register_buffer(name, weights.get(name))
        self.act = ACTS[cfg.act]
        self.alpha = bf16_scalar(cfg.residual_alpha)
        flag = weights.get("use_sliding")
        if flag is not None:
            self.register_buffer("use_sliding", flag)
        # the layer's sliding window, read here once as a Python int: a
        # device flag read in forward would sync the host inside the
        # decode step's CUDA graph. Without a per-layer flag the config's
        # window holds for every layer, as in the JAX package.
        self.window = cfg.sliding_window \
            if flag is None or bool(flag) else 0

    def _norm(self, x, name):
        cfg = self.cfg
        w = getattr(self, name + "_w")
        if cfg.norm_type == "rmsnorm":
            return rms_norm(x, w, cfg.norm_eps, cfg.norm_offset)
        return layer_norm(x, w, getattr(self, name + "_b"), cfg.norm_eps)

    def _linear(self, name, x):
        y = getattr(self, name)(x)
        b = getattr(self, "b" + name[1:])
        return y if b is None else y + b.to(y.dtype)

    def forward(self, x, kv, positions, rope, slopes=None, prompt_len=None):
        """x [B, T, D]; ``kv`` this layer's
        :class:`~neural_tpu_torch.runtime.kvcache.LayerKV`, written in place
        at ``positions`` [B, T]; ``rope`` the RoPE tables of the config's
        style (None for "none"); the model's ALiBi ``slopes`` and the
        prompt lengths ``prompt_len`` [B], which the attention reads for a
        prefix-LM config's prefill."""
        cfg = self.cfg
        B, T, _ = x.shape
        Dh = cfg.head_dim
        h = self._norm(x, "attn_norm")
        if self.fused_qkv:
            qkv = self._linear("wqkv", h)
            nq, nkv = cfg.n_heads * Dh, cfg.n_kv_heads * Dh
            q, k, v = qkv[..., :nq], qkv[..., nq:nq + nkv], qkv[..., nq + nkv:]
        else:
            q, k, v = (self._linear(n, h) for n in ("wq", "wk", "wv"))
        q, k, v = (t.reshape(B, T, -1, Dh) for t in (q, k, v))
        if cfg.rope_style == "glm1":
            q, k = apply_glm1(q, rope), apply_glm1(k, rope)
        elif rope is not None:
            q, k = apply_rope(q, *rope), apply_rope(k, *rope)
        opts = dict(window=self.window, slopes=slopes, prefix_len=prompt_len)
        # append only the new tokens, at each row's own offset (no host
        # sync: the positions stay on the device)
        if kv.table is not None:
            paged_update_kv(kv.k, kv.v, kv.k_scale, kv.v_scale,
                            k.transpose(1, 2), v.transpose(1, 2), kv.table,
                            positions[:, 0])
            out = attend_paged(q, kv.k, kv.v, kv.k_scale, kv.v_scale,
                               kv.table, positions, cfg, **opts)
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
                         kv.v_scale, **opts)
        out = self._linear("wo", out.to(x.dtype))
        if cfg.post_attn_norm:
            out = self._norm(out, "post_attn_norm")
        if cfg.residual_alpha != 1.0:
            # ChatGLM-1's DeepNorm residuals: the normed branch input,
            # times alpha as a bf16 scalar, is the residual base
            x = h * self.alpha + out
            h2 = self._norm(x, "ffn_norm")
            return h2 * self.alpha + self._mlp(h2)
        x = x + out
        mlp = self._mlp(self._norm(x, "ffn_norm"))
        if cfg.post_ffn_norm:
            mlp = self._norm(mlp, "post_ffn_norm")
        return x + mlp

    def _mlp(self, h):
        if self.fused_gateup:
            gu = self._linear("w_gateup", h)
            ng = gu.shape[-1] // 2
            h = self.act(gu[..., :ng]) * gu[..., ng:]
        elif self.cfg.mlp_gated:
            h = self.act(self._linear("w_gate", h)) * self._linear("w_up", h)
        else:
            h = self.act(self._linear("w_up", h))
        return self._linear("w_down", h)


class Transformer(nn.Module):
    """The decoder: ``embed``, (``embed_norm_w``/``_b``), ``layers``,
    ``final_norm_w`` (``final_norm_b``), ``lm_head`` (absent when tied to
    the embedding), the RoPE table (absent without RoPE) and the ALiBi
    slopes (with ALiBi)."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, object]):
        super().__init__()
        glm1_dim = cfg.rope_style == "glm1" and \
            cfg.rope_dim == cfg.head_dim // 2
        unsupported = [n for n, on in (
            ("arch", cfg.arch not in ARCHS),
            ("norm_type", cfg.norm_type not in ("rmsnorm", "layernorm")),
            ("act", cfg.act not in ACTS),
            ("qk_norm", cfg.qk_norm),
            ("rope_style", cfg.rope_style not in ("neox", "none", "glm1")),
            ("rope_dim", cfg.rope_dim is not None and not glm1_dim),
            ("learned_pos_emb", cfg.learned_pos_emb),
            ("parallel_residual", cfg.parallel_residual),
            ("final_norm", not cfg.final_norm),
            ("moe", cfg.is_moe)) if on]
        if unsupported:
            raise NotImplementedError(
                f"graph features {unsupported} belong to a later model-zoo "
                "slice")
        self.cfg = cfg
        self.layers = nn.ModuleList(Block(cfg, lp)
                                    for lp in params["layers"])
        self.embed_scale = bf16_scalar(cfg.embed_scale)
        for name in ("embed", "embed_norm_w", "embed_norm_b", "final_norm_w",
                     "final_norm_b", "rope_inv_freqs", "alibi_slopes"):
            self.register_buffer(name, params.get(name))
        if cfg.use_alibi and self.alibi_slopes is None:
            raise ValueError("an ALiBi config needs params['alibi_slopes']")
        lm_head = params.get("lm_head")
        self.lm_head = None if lm_head is None else QLinear(lm_head)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens: torch.Tensor, start: torch.Tensor, cache,
                logits_dtype: torch.dtype = torch.float32,
                logit_positions: Optional[torch.Tensor] = None,
                prompt_len: Optional[torch.Tensor] = None):
        """tokens [B, T]; start [B] (cache write offset per row); cache a
        :class:`~neural_tpu_torch.runtime.kvcache.KVCache` or
        :class:`~neural_tpu_torch.runtime.paged.PagedKVCache`, updated in
        place.
        ``logit_positions`` [B]: the one token per row whose logits are
        wanted — the lm_head then runs on [B, 1, D]. ``prompt_len`` [B]:
        each row's prompt size, which a prefix-LM config (ChatGLM-1) reads
        for its prefix mask and its 2-D RoPE; by default start + T, the
        whole call being the prompt (a prefill), as in the JAX package.
        Other configs ignore it. Returns logits [B, T, V] (or [B, 1, V])."""
        cfg = self.cfg
        B, T = tokens.shape
        positions = start[:, None].long() + torch.arange(
            T, device=tokens.device)[None, :]
        x = self.embed[tokens.long()].to(torch.bfloat16)
        if self.embed_scale != 1.0:
            x = x * self.embed_scale
        if self.embed_norm_w is not None:     # Bloom's embedding LayerNorm
            x = layer_norm(x, self.embed_norm_w, self.embed_norm_b,
                           cfg.norm_eps)
        if (cfg.prefix_lm or cfg.rope_style == "glm1") and prompt_len is None:
            prompt_len = start.long() + T
        if cfg.rope_style == "glm1":
            rope = glm1_cos_sin(positions, prompt_len, self.rope_inv_freqs)
        elif cfg.rope_style == "none":
            rope = None
        else:
            rope = rope_cos_sin(positions, self.rope_inv_freqs)
        for l, blk in enumerate(self.layers):
            x = blk(x, cache.layer(l), positions, rope, self.alibi_slopes,
                    prompt_len)
        if logit_positions is not None:
            rows = torch.arange(B, device=x.device)[:, None]
            x = x[rows, logit_positions.long()[:, None]]
        if cfg.norm_type == "rmsnorm":
            x = rms_norm(x, self.final_norm_w, cfg.norm_eps, cfg.norm_offset)
        else:
            x = layer_norm(x, self.final_norm_w, self.final_norm_b,
                           cfg.norm_eps)
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
