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

The fused decode path (``NTPU_FUSED_DECODE``, :func:`fuse_mode`, off by
default; the JAX ``_block`` fast path) folds a decode step's elementwise
ops into K1 where :func:`can_fuse_block` allows: the pre-norms into the
q/k/v and gate/up products' prologue, the residual adds into the wo and
w_down products' second pass, the final norm into a quantized lm_head's
prologue, and with ``NTPU_FUSE_GLU=1`` the gated activation into w_down's
prologue (``ops.qmatmul.qmatmul_fused``). Each block reads at load which
of its weights the fused kernel takes (``ops.qmatmul.fusable``): a
pre-norm rides the kernels only when it takes every product behind that
norm (q/k/v, gate/up); otherwise the block computes the norm once and runs
the unfused chain there, as it does for a wo or w_down the kernel does not
take.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..core.qtensor import QTensor
from ..ops.attention import attend, quantize_kv
from ..ops.norms import layer_norm, rms_norm
from ..ops.paged_attention import attend_paged, paged_update_kv
from ..ops.qmatmul import ACTS, fusable, qmatmul, qmatmul_fused
from ..ops.rope import apply_glm1, apply_rope, glm1_cos_sin, rope_cos_sin
from .config import ModelConfig

LINEARS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
BIASES = ("bq", "bk", "bv", "bo", "b_gate", "b_up", "b_down")
# the fused q|k|v and gate|up projections of ``runtime.generate.
# fuse_layer_weights``, and their biases
FUSED = ("wqkv", "w_gateup")
FUSED_BIASES = ("bqkv", "b_gateup")
NORMS = ("attn_norm", "ffn_norm", "post_attn_norm", "post_ffn_norm")
ARCHS = ("llama", "mistral", "gemma", "gemma2", "bloom", "mpt", "chatglm1")


def fuse_mode() -> str:
    """``NTPU_FUSED_DECODE``: "0" (off, the default), "1" (on the card) or
    "interpret" (on the CPU too, where the fused products run K1's plain
    version), read at every forward call, so one loaded model can be
    captured and timed both ways in one process.

    Off unset, as in the JAX package (on the TPU the fused kernels
    measured slower). The default changes only where ``chip_smoke.py``
    phase 4's A/B finds fused faster at fill 128 with bf16 KV and at batch
    8 beyond the spread of the device-timed replays (its 75th percentile
    under unfused's 25th), and slower at no leg, steadily. On an NVIDIA
    H100 80GB HBM3 at a 700 W power limit, a Llama-2-7B q4_j decode step's
    CUDA graph (30 replays a mode, in turns; two runs) took 6.836 and
    6.840 ms fused against 7.773 and 7.775 ms unfused at fill 128
    (medians), beyond the spread; at batch 8 with int8 KV 13.925 against
    14.388 ms, beyond it, in one run, and 13.232 against 13.438 ms in the
    other, where a third of every mode's replays ran 1 ms slower and the
    quartiles overlapped (fused q75 13.952, unfused q25 13.428)."""
    return os.environ.get("NTPU_FUSED_DECODE", "0")


def fuse_glu() -> bool:
    """``NTPU_FUSE_GLU=1``: with the fused path on, the gated activation
    ``act(g) · u`` rides the w_down kernel's prologue too. Off unset, as in
    the JAX package; on the H100 of :func:`fuse_mode` it was 0.02 ms a step
    faster than fused without it at fill 128 but 0.24 ms slower at batch 8
    (14.164 against 13.925 ms: the gate and up rows staged per block cost
    more than the launch they save)."""
    return os.environ.get("NTPU_FUSE_GLU") == "1"


def fuse_switches() -> Tuple[str, bool]:
    """The two switches as a forward call reads them: what a captured
    decode step records, so that a step captured under other switches is
    captured again, never replayed."""
    return fuse_mode(), fuse_glu()


def can_fuse_block(x: torch.Tensor, cfg: ModelConfig, mode: str) -> bool:
    """The JAX package's ``_can_fuse_block``: the fused path is on (``mode``
    not "0"), x lies on the card or the mode is "interpret", B·T <= 16, and
    the block is the plain serial-residual RMS-norm shape (no parallel
    residual, residual alpha 1, no post norms). The port has no tensor
    parallelism, the rule's last exclusion."""
    if mode == "0":
        return False
    if not (x.device.type == "cuda" or mode == "interpret"):
        return False
    B, T = x.shape[:2]
    if B * T > 16:
        return False
    return (cfg.norm_type == "rmsnorm" and not cfg.parallel_residual
            and cfg.residual_alpha == 1.0 and not cfg.post_attn_norm
            and not cfg.post_ffn_norm)


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
        # the products the fused K1 takes, read once here: the fused route
        # is chosen from them before anything is computed
        self.fusable = {n for n in LINEARS + FUSED if n in weights
                        and not isinstance(weights[n], torch.Tensor)
                        and weights.get("b" + n[1:]) is None
                        and fusable(weights[n])}
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

    def _fused(self, name, x, **fuse):
        """The projection ``name`` (one of ``self.fusable``) through
        :func:`qmatmul_fused`: x [B, T, K], or a pair of them for glu, with
        B·T <= 16 (:func:`can_fuse_block`) → [B, T, N]."""
        x0 = x[0] if isinstance(x, tuple) else x
        B, T, K = x0.shape
        x2 = tuple(t.reshape(B * T, K) for t in x) if isinstance(x, tuple) \
            else x.reshape(B * T, K)
        res = fuse.pop("res", None)
        y = qmatmul_fused(x2, getattr(self, name).qt, x0.dtype,
                          res=None if res is None
                          else res.reshape(B * T, -1), **fuse)
        return y.reshape(B, T, -1)

    def _projections(self, x, norm, names):
        """A function from each name of ``names``, the projections that
        read ``norm(x)`` (x the raw residual stream), to its output: the
        JAX ``_lin_norm``, the norm in each kernel's prologue, where the
        fused kernel takes every one of them; else the norm once and the
        unfused products."""
        if self.fusable.issuperset(names):
            cfg = self.cfg
            nw = (getattr(self, norm + "_w"), cfg.norm_eps, cfg.norm_offset)
            return lambda n: self._fused(n, x, norm=nw)
        h = self._norm(x, norm)
        return lambda n: self._linear(n, h)

    def forward(self, x, kv, positions, rope, slopes=None, prompt_len=None,
                fuse=False, fuse_glu=False):
        """x [B, T, D]; ``kv`` this layer's
        :class:`~neural_tpu_torch.runtime.kvcache.LayerKV`, written in place
        at ``positions`` [B, T]; ``rope`` the RoPE tables of the config's
        style (None for "none"); the model's ALiBi ``slopes`` and the
        prompt lengths ``prompt_len`` [B], which the attention reads for a
        prefix-LM config's prefill. ``fuse`` (:func:`can_fuse_block`) takes
        the decode fast path of the JAX ``_block``: the pre-norms ride the
        q/k/v and gate/up kernels, the residual adds the wo and w_down
        kernels, and with ``fuse_glu`` the gated activation the w_down
        kernel's prologue."""
        cfg = self.cfg
        if fuse:
            x = self._attention(x, kv, positions, rope, slopes, prompt_len,
                                res=x)
            return self._mlp(x, res=x, fuse_glu=fuse_glu)
        h = self._norm(x, "attn_norm")
        out = self._attention(h, kv, positions, rope, slopes, prompt_len)
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

    def _attention(self, x, kv, positions, rope, slopes, prompt_len,
                   res=None):
        """q/k/v, RoPE, the cache append and the attention, then the output
        projection. With ``res``, x is the raw residual stream (the
        attention norm rides the q/k/v kernels) and the result includes
        the residual, added in the wo kernel's second pass."""
        cfg = self.cfg
        B, T, _ = x.shape
        Dh = cfg.head_dim
        names = ("wqkv",) if self.fused_qkv else ("wq", "wk", "wv")
        if res is None:
            proj = lambda n: self._linear(n, x)
        else:
            proj = self._projections(x, "attn_norm", names)
        if self.fused_qkv:
            qkv = proj("wqkv")
            nq, nkv = cfg.n_heads * Dh, cfg.n_kv_heads * Dh
            q, k, v = qkv[..., :nq], qkv[..., nq:nq + nkv], qkv[..., nq + nkv:]
        else:
            q, k, v = (proj(n) for n in ("wq", "wk", "wv"))
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
        out = out.to(x.dtype)
        if res is None:
            return self._linear("wo", out)
        if "wo" in self.fusable:
            return self._fused("wo", out, res=res)
        return res + self._linear("wo", out)

    def _mlp(self, x, res=None, fuse_glu=False):
        """The MLP. With ``res`` (the JAX ``_mlp`` in decode-fusion mode), x
        is the raw residual stream (the FFN norm rides the gate/up kernels)
        and the result includes the residual, added in the w_down kernel's
        second pass; with ``fuse_glu`` the gated activation rides its
        prologue too."""
        cfg = self.cfg
        names = ("w_gateup",) if self.fused_gateup else \
            ("w_gate", "w_up") if cfg.mlp_gated else ("w_up",)
        if res is None:
            lin = lambda n: self._linear(n, x)
        else:
            lin = self._projections(x, "ffn_norm", names)
        gu = None
        if self.fused_gateup:
            y = lin("w_gateup")
            ng = y.shape[-1] // 2
            gu = (y[..., :ng], y[..., ng:])
        elif cfg.mlp_gated:
            gu = (lin("w_gate"), lin("w_up"))
        else:
            h = self.act(lin("w_up"))
        fuse_ok = res is not None and "w_down" in self.fusable \
            and cfg.act in ("silu", "gelu_tanh", "relu")
        if gu is not None:
            g, u = gu
            if fuse_ok and fuse_glu:
                return self._fused("w_down", (g, u), glu=cfg.act, res=res)
            h = self.act(g) * u
        if fuse_ok:
            return self._fused("w_down", h, res=res)
        down = self._linear("w_down", h)
        return down if res is None else res + down


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
        # the final norm can ride a quantized, bias-free lm_head's kernel
        self.fuse_head = self.lm_head is not None \
            and self.lm_head.cfg is not None \
            and self.final_norm_b is None and fusable(lm_head)

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
        mode, glu = fuse_switches()
        fuse = can_fuse_block(x, cfg, mode)
        for l, blk in enumerate(self.layers):
            x = blk(x, cache.layer(l), positions, rope, self.alibi_slopes,
                    prompt_len, fuse, glu)
        if logit_positions is not None:
            rows = torch.arange(B, device=x.device)[:, None]
            x = x[rows, logit_positions.long()[:, None]]
        if self.fuse_head and can_fuse_block(x, cfg, mode):
            # the final norm rides the lm_head kernel's prologue; after
            # logit_positions a prefill's one row qualifies too
            Bx, Tx, Dx = x.shape
            logits = qmatmul_fused(
                x.reshape(-1, Dx), self.lm_head.qt, torch.float32,
                norm=(self.final_norm_w, cfg.norm_eps, cfg.norm_offset)
            ).reshape(Bx, Tx, -1)
        else:
            if cfg.norm_type == "rmsnorm":
                x = rms_norm(x, self.final_norm_w, cfg.norm_eps,
                             cfg.norm_offset)
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
