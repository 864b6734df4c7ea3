"""The decoder graph of every family of the JAX package (port of
``neural_tpu/models/transformer.py`` :41-302 and :359-714).

Embedding (times Gemma's bf16 embedding scale; plus the learned position
table at ``positions + pos_offset``, OPT and StarCoder; then Bloom's
embedding LayerNorm) → per layer [pre-norm → q/k/v (+ biases) → (qk-norm:
an RMS norm over each head's Dh) → RoPE (NeoX or GPT-J pairs, on all of
the head or its first ``rope_dim``; the 2-D GLM one of ChatGLM-1; none under
ALiBi or learned positions) → cache append at each row's ``start`` → GQA
attention (f32, cast back to the activation dtype; the config's softcap,
the layer's sliding window, the ALiBi slopes, the GLM prefix mask) →
output projection (+ bias) → (post-attention norm) → residual → pre-norm →
gated MLP (SiLU or tanh GELU) or ``w_down(act(w_up h))`` (+ biases; exact
or tanh GELU, ReLU), or the routed expert MLP of Mixtral and Grok
(:meth:`Block._moe`) → (post-FFN norm) → residual] → final norm → lm_head
(+ its bias, in f32; then Gemma-2's final softcap, in f32), optionally on
one row per sequence (``logit_positions``). A parallel-residual layer
(GPT-J, GPT-NeoX, Phi-1.5/2, Falcon) adds ``attn(norm1(x)) + mlp(norm2(x))``
to x, with ``norm2`` the attention's norm where the layer has no
``ffn_norm_w``. Norms are RMS (scaled by ``w + norm_offset``, Gemma: 1 +
w) or LayerNorm with an optional bias. ChatGLM-1's DeepNorm residual takes
the normed branch input times ``residual_alpha`` as its base. Biases are
added in the output's dtype after the product, as the JAX package's
``linear`` does. Parameter names are the JAX package's.

The cache is a contiguous :class:`~neural_tpu_torch.runtime.kvcache.KVCache`
(bf16, or int8: the append quantizes with ``quantize_kv`` and writes the
scale rows too) or a paged
:class:`~neural_tpu_torch.runtime.paged.PagedKVCache` (the append goes
through ``paged_update_kv``, attention through ``attend_paged``), as in
``neural_tpu/models/transformer.py:462-494``. Without a cache (``forward(
..., cache=None)``, the JAX ``forward(cache=None)``) each block attends
within the call, causal over the global positions (:func:`attend_nocache`;
on a mesh with an "sp" axis the ring of ``parallel.sp``): the training
path. Under autograd (:func:`records_grad`) the graph keeps to plain torch
ops, which autograd differentiates: the norms' torch chain, f32-widened
products where the card's inference graph takes ``aten::mm.dtype``.

Every projection is a :class:`QLinear`: a quantized weight at rest
(``core.qtensor.to_native``) or a bf16 one. A tied lm_head is a torch
product with the embedding, as the JAX package leaves it to XLA. A
mixture-of-experts layer holds its ``router`` ([D, E], unquantized, as in
the JAX package) and its experts as the JAX per-layer stacks
(:class:`Experts`): expert e's weight is a contiguous view of the stack,
which K1, K2 and K5 take as they take a dense weight.

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

from ..core.qtensor import QTensor, qtensor_at
from ..ops import _cuda
from ..ops.attention import attend, attn_scale, quantize_kv
from ..ops.norms import layer_norm, rms_norm, rms_norm_plain
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
ARCHS = ("llama", "mistral", "mixtral", "solar", "gemma", "gemma2", "bloom",
         "mpt", "chatglm", "chatglm1", "qwen", "qwen2", "baichuan",
         "stablelm", "gpt_neox", "gptj", "phi", "phi3", "falcon", "opt",
         "gpt_bigcode", "grok")
# an expert layer's projections and biases, each an [E, ...] stack
EXPERT_LINEARS = ("w_gate", "w_up", "w_down")
EXPERT_BIASES = ("b_gate", "b_up", "b_down")
# the grouped expert path's threshold: B·T at or above it, with unquantized,
# bias-free experts (the JAX ``_moe_mlp``'s rule)
GROUPED_MIN_ROWS = 8


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


def can_fuse_block(x: torch.Tensor, cfg: ModelConfig, mode: str,
                   tp: int = 1) -> bool:
    """The JAX package's ``_can_fuse_block``: the fused path is on (``mode``
    not "0"), x lies on the card or the mode is "interpret", B·T <= 16, the
    block is the plain serial-residual RMS-norm shape (no parallel
    residual, residual alpha 1, no post norms), and the model is not split
    over ``tp`` > 1 ranks: a residual added inside a row-split kernel would
    be summed tp times, as it must join after the sum."""
    if mode == "0" or tp > 1:
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


def records_grad(*ts) -> bool:
    """Autograd records an op on these tensors: the training graph of
    ``parallel.pp`` and ``parallel.dryrun`` (params that require grad).
    There the graph takes plain torch ops only: no kernel of the port has a
    backward (nor has any Pallas kernel of the JAX package, which trains
    through its XLA graph), and every kernel entry refuses a tensor that
    requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def graph_rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float,
                   offset: float = 0.0) -> torch.Tensor:
    """The graph's RMS norm: the row-norm kernel (``ops.norms.rms_norm``)
    for inference; under autograd (:func:`records_grad`) the torch chain
    ``rms_norm_plain``, which autograd differentiates (the kernel writes
    through raw pointers into a tensor with no ``grad_fn``)."""
    if records_grad(x, w):
        return rms_norm_plain(x, w, eps, offset)
    return rms_norm(x, w, eps, offset)


def masked_scores(qh: torch.Tensor, kb: torch.Tensor, q_pos: torch.Tensor,
                  kv_pos: torch.Tensor, cfg: ModelConfig, slopes=None,
                  window: int = 0):
    """Masked attention scores of one key block (the JAX ``masked_scores``),
    shared by :func:`attend_nocache` and the ring
    (``parallel.sp.ring_attend``): one implementation, so that the ring
    matches its one-device oracle exactly.

    qh [B, Hkv, G, Tq, Dh] f32 queries, already scaled; kb [B, Hkv, Ts, Dh];
    q_pos [B, Tq, 1] and kv_pos [B, 1, Ts] global positions; ``window`` the
    layer's sliding window (0: none). → (scores [B, Hkv, G, Tq, Ts] f32:
    the softcap, then the ALiBi bias, then -1e30 at masked slots; the mask
    [B, Tq, Ts], causal over the positions)."""
    Hkv, G = qh.shape[1], qh.shape[2]
    s = torch.einsum("bhgtd,bhsd->bhgts", qh, kb.to(torch.float32))
    if cfg.attn_softcap:
        s = cfg.attn_softcap * torch.tanh(s / cfg.attn_softcap)
    mask = kv_pos <= q_pos
    if window:
        mask = mask & (kv_pos > q_pos - window)
    if cfg.use_alibi and slopes is not None:
        dist = (kv_pos - q_pos).to(torch.float32)
        s = s + (slopes.to(torch.float32).reshape(Hkv, G)[None, :, :, None,
                                                          None]
                 * dist[:, None, None, :, :])
    return s.masked_fill(~mask[:, None, None], -1e30), mask


def attend_nocache(q: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor,
                   positions: torch.Tensor, cfg: ModelConfig, slopes=None,
                   window: int = 0) -> torch.Tensor:
    """Causal attention within the current block, without a cache (the JAX
    ``_attend_nocache``): the training path and the ring's one-device
    oracle. q [B, T, Hq, Dh], kt/vt [B, Hkv, T, Dh], ``positions`` [B, T]
    global; GQA by head groups, an f32 softmax (:func:`masked_scores`) →
    [B, T, Hq·Dh] f32. Torch ops, as the JAX function is XLA: no Pallas
    kernel reaches it."""
    B, T, Hq, Dh = q.shape
    Hkv = kt.shape[1]
    G = Hq // Hkv
    qh = q.reshape(B, T, Hkv, G, Dh).permute(0, 2, 3, 1, 4) \
        .to(torch.float32) * attn_scale(cfg, Dh)
    s, _ = masked_scores(qh, kt, positions[:, :, None], positions[:, None, :],
                         cfg, slopes, window)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgts,bhsd->bhgtd", p, vt.to(torch.float32))
    return o.permute(0, 3, 1, 2, 4).reshape(B, T, Hq * Dh)


class QLinear(nn.Module):
    """A ``[K, N]`` projection: a QTensor at rest (its planes, scales,
    zero-points and act-order ``perm`` as buffers, plus its QuantConfig)
    multiplied by :func:`~neural_tpu_torch.ops.qmatmul.qmatmul`, or an
    unquantized weight (``weight_dtype=None``), a plain ``torch.matmul``
    as the JAX package leaves it to XLA: as its ``linear`` does, the
    weight takes x's dtype (bf16) first, so an f32 weight is rounded to
    bf16 at the product."""

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

    @property
    def param(self):
        """What the layer was built from: the QTensor or the bf16 weight."""
        return self.weight if self.cfg is None else self.qt

    def forward(self, x: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return linear(x, self.param, out_dtype)


def linear(x: torch.Tensor, w, out_dtype: Optional[torch.dtype] = None
           ) -> torch.Tensor:
    """``x @ w`` for a QTensor (:func:`qmatmul`, its kernels) or an
    unquantized ``[K, N]`` weight (the JAX ``linear``: the weight takes x's
    dtype first, one product)."""
    out_dtype = out_dtype or x.dtype
    if isinstance(w, QTensor):
        return qmatmul(x, w, out_dtype)
    if out_dtype == torch.float32 and x.device.type == "cuda" \
            and w.dtype == torch.bfloat16 and not records_grad(x, w):
        # bf16 operands, f32 sums, one product: no f32 copy of the
        # weight per call (an untied 32000-row lm_head would be 0.5 GB).
        # ``aten::mm.dtype`` has no derivative: under autograd the product
        # takes the f32-widened operands below (exact for bf16 values)
        x2 = x.reshape(-1, x.shape[-1]).to(w.dtype)
        return torch.mm(x2, w, out_dtype=torch.float32) \
            .reshape(*x.shape[:-1], -1)
    w = w.to(x.dtype)
    if out_dtype == torch.float32:
        return x.to(torch.float32) @ w.to(torch.float32)
    return torch.matmul(x, w).to(out_dtype)


def _rdot(lhs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One group's product of the grouped expert path: bf16 operands, f32
    sums and result, as ``lax.ragged_dot(lhs.astype(bf16), w.astype(bf16),
    ..., preferred_element_type=f32)`` computes it (the cast holds for f32
    params too). ``ragged_dot`` is XLA, not a Pallas kernel: its port is
    one ``torch.mm`` a group. The CPU has no bf16 ``mm`` with f32 output,
    and ``aten::mm.dtype`` has no derivative: there, and under autograd,
    the bf16 values are widened to f32 (exact) and multiplied."""
    lhs, w = lhs.to(torch.bfloat16), w.to(torch.bfloat16)
    if lhs.device.type == "cuda" and not records_grad(lhs, w):
        return torch.mm(lhs, w, out_dtype=torch.float32)
    return lhs.to(torch.float32) @ w.to(torch.float32)


def moe_route(logits: torch.Tensor, k: int, norm_topk: bool):
    """The top-k experts of each row of the router's f32 ``logits`` [..., E]
    and their weights, as the JAX ``_moe_mlp`` (``jax.lax.top_k``, then
    a softmax over the k chosen logits with ``norm_topk``, else the full
    softmax gathered at them). Router logits are bf16 before their f32
    cast, so ties among the experts are common: ``top_k`` takes the lower
    index first, and so does a stable descending sort, where ``torch.topk``
    on the card promises no order. → (weights f32 [..., k], ids [..., k])."""
    idx = torch.sort(logits, dim=-1, descending=True, stable=True) \
        .indices[..., :k]
    top = logits.gather(-1, idx)
    if norm_topk:
        return torch.softmax(top, dim=-1), idx
    return torch.softmax(logits, dim=-1).gather(-1, idx), idx


class Experts(nn.Module):
    """One layer's experts: each of ``w_gate``/``w_up``/``w_down`` an
    ``[E, ...]`` stack (a stacked QTensor's buffers, or one ``[E, K, N]``
    unquantized tensor), as the JAX package's per-layer slice of
    ``layers["experts"]``; biases ``[E, N]`` where a family has them. No FFN
    padding: the JAX ``build_params`` pads plain names only."""

    def __init__(self, weights: Dict[str, object]):
        super().__init__()
        self.names = tuple(n for n in EXPERT_LINEARS if n in weights)
        for name in self.names:
            setattr(self, name, QLinear(weights[name]))
        for name in EXPERT_BIASES:
            self.register_buffer(name, weights.get(name))
        self.quantized = any(getattr(self, n).cfg is not None
                             for n in self.names)
        self.biased = any(weights.get(b) is not None for b in EXPERT_BIASES)

    def weights(self) -> Dict[str, object]:
        out = {n: getattr(self, n).param for n in self.names}
        out.update({b: getattr(self, b) for b in EXPERT_BIASES
                    if getattr(self, b) is not None})
        return out

    def weight(self, name: str, e: int):
        """Expert ``e``'s ``name`` weight: views into the stack."""
        lin = getattr(self, name)
        return lin.weight[e] if lin.cfg is None else qtensor_at(lin.qt, e)

    def mlp(self, e: int, x: torch.Tensor, cfg: ModelConfig, act,
            down_bias: bool = True):
        """Expert ``e``'s MLP on every row of x, the JAX ``_mlp`` with
        ``n_experts=0``: unfused products, ``act(g) · u``, then
        ``w_down`` (plus the biases a family has, in the output's dtype;
        w_down's only with ``down_bias``, which an expert split over tp
        leaves to after its sum)."""
        def lin(name, h, bias=True):
            y = linear(h, self.weight(name, e))
            b = getattr(self, "b" + name[1:])
            return y if b is None or not bias else y + b[e].to(y.dtype)
        if cfg.mlp_gated:
            h = act(lin("w_gate", x)) * lin("w_up", x)
        else:
            h = act(lin("w_up", x))
        return lin("w_down", h, down_bias)


class Block(nn.Module):
    """One decoder layer. ``weights`` maps the JAX names to QTensors (the
    projections, or the fused ``wqkv`` / ``w_gateup`` of
    ``fuse_layer_weights``, whose outputs are split after the product, as
    in ``neural_tpu/models/transformer.py``), tensors (norm weights and
    biases, projection biases), for Gemma-2, the 0-d bool
    ``use_sliding`` flag, and for a mixture-of-experts layer the
    ``router`` ([D, E], unquantized) and the ``experts`` dict of stacks
    (:class:`Experts`) in place of the MLP's projections."""

    def __init__(self, cfg: ModelConfig, weights: Dict[str, object],
                 mesh=None, capacity_factor: float = 2.0):
        super().__init__()
        self.cfg = cfg
        # a sharded block's mesh (``parallel.sharding.Mesh``): its weights
        # are this rank's slices, and it sums over tp after wo, w_down and
        # the experts' mixture, before their replicated biases
        self.mesh = mesh
        self.tp = 1 if mesh is None else mesh.tp
        self.capacity_factor = capacity_factor
        for name in LINEARS + FUSED:
            if name in weights:
                setattr(self, name, QLinear(weights[name]))
        if cfg.is_moe:
            self.router = QLinear(weights["router"])
            self.experts = Experts(weights["experts"])
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
        if cfg.parallel_residual and "ffn_norm_w" not in weights:
            # GPT-J, Phi-1.5/2, Falcon-7B: the MLP reads the attention's
            # norm (the JAX ``_block`` takes ``h`` when the layer has no
            # ffn_norm_w)
            norms.remove("ffn_norm")
            self.register_buffer("ffn_norm_w", None)
        for name in norms:
            self.register_buffer(name + "_w", weights[name + "_w"])
        for name in ("q_norm_w", "k_norm_w") if cfg.qk_norm else ():
            self.register_buffer(name, weights[name])
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

    def weights(self) -> Dict[str, object]:
        """The ``weights`` dict this block holds, as it was built from."""
        out = {n: getattr(self, n).param for n in LINEARS + FUSED
               if hasattr(self, n)}
        if self.cfg.is_moe:
            out["router"] = self.router.param
            out["experts"] = self.experts.weights()
        for name, buf in self.named_buffers(recurse=False):
            out[name] = buf
        return out

    def _norm(self, x, name):
        cfg = self.cfg
        w = getattr(self, name + "_w")
        if cfg.norm_type == "rmsnorm":
            return graph_rms_norm(x, w, cfg.norm_eps, cfg.norm_offset)
        return layer_norm(x, w, getattr(self, name + "_b"), cfg.norm_eps)

    def _psum(self, y):
        """The sum over tp of a row-split product's partial ``y`` (the JAX
        ``_psum``); y itself on one device."""
        return y if self.tp == 1 else self.mesh.psum(y, "tp")

    def _linear(self, name, x, psum=False):
        """The projection ``name`` plus its bias; with ``psum`` (wo, w_down)
        on a model split over tp, the rank's partial product comes out in
        f32, is summed over tp in f32 and rounded to x's dtype once, as one
        device's product rounds its whole sum once (the JAX package sums
        the bf16 partials, rounding twice), and the bias, replicated, is
        added once after the sum."""
        if psum and self.tp > 1:
            y = self._psum(getattr(self, name)(x, torch.float32)).to(x.dtype)
        else:
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
        if cfg.parallel_residual:
            # x + attn(norm1(x)) + mlp(norm2(x)), added in that order, as
            # the JAX ``_block``; one shared norm where there is no second
            h2 = h if self.ffn_norm_w is None else self._norm(x, "ffn_norm")
            return x + out + self._mlp(h2)
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
        if cfg.qk_norm:
            # an RMS norm over each head's Dh, before RoPE, offset 0 (the
            # JAX ``_attention`` passes no offset)
            q = graph_rms_norm(q, self.q_norm_w, cfg.norm_eps)
            k = graph_rms_norm(k, self.k_norm_w, cfg.norm_eps)
        if cfg.rope_style == "glm1":
            q, k = apply_glm1(q, rope), apply_glm1(k, rope)
        elif rope is not None:
            q = apply_rope(q, *rope, cfg.rope_style, cfg.rope_dim)
            k = apply_rope(k, *rope, cfg.rope_style, cfg.rope_dim)
        opts = dict(window=self.window, slopes=slopes, prefix_len=prompt_len)
        if kv is None:
            # no cache (the training path, the ring's): attend within this
            # block, causal over the global positions; on a mesh with an
            # "sp" axis the K/V blocks ring over it (``parallel.sp``). As
            # in the JAX package, this path has no prefix mask.
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)
            if self.mesh is not None and self.mesh.size("sp") > 1:
                from ..parallel.sp import ring_attend
                _cuda.ROUTES.count("ring_attend")
                out = ring_attend(q, kt, vt, positions, cfg, self.mesh,
                                  slopes, self.window)
            else:
                _cuda.ROUTES.count("attend_nocache")
                out = attend_nocache(q, kt, vt, positions, cfg, slopes,
                                     self.window)
        elif kv.table is not None:
            # a cache: append only the new tokens, at each row's own offset
            # (no host sync: the positions stay on the device)
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
            return self._linear("wo", out, psum=True)
        if "wo" in self.fusable:
            return self._fused("wo", out, res=res)
        return res + self._linear("wo", out, psum=True)

    def _mlp(self, x, res=None, fuse_glu=False):
        """The MLP. With ``res`` (the JAX ``_mlp`` in decode-fusion mode), x
        is the raw residual stream (the FFN norm rides the gate/up kernels)
        and the result includes the residual, added in the w_down kernel's
        second pass; with ``fuse_glu`` the gated activation rides its
        prologue too."""
        cfg = self.cfg
        if cfg.is_moe:
            # the routing reads the normed stream: under the fused decode
            # path the norm runs outside the kernels (the JAX ``_mlp``)
            if res is None:
                return self._moe(x)
            return res + self._moe(self._norm(x, "ffn_norm"))
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
        down = self._linear("w_down", h, psum=True)
        return down if res is None else res + down

    def _moe(self, x):
        """The routed expert MLP, the JAX ``_moe_mlp``: the router's logits
        (x's dtype, then f32), the top-k experts (:func:`moe_route`), then
        the grouped path (:func:`moe_grouped`) for unquantized, bias-free
        experts at B·T >= 8, else the dense mixture: every expert's MLP on
        every row, cast to f32, weighted by the [B, T, E] mixture (zero off
        the chosen experts) and summed over E in f32, then cast to x's
        dtype. The zero terms change no sum; this computes what JAX
        computes (a routed read of the chosen experts is a speed question
        for later). Under tp the sum over tp is deferred until after the
        mixture, in f32, as JAX defers its psum; a mesh with an ep axis
        takes the expert-parallel dispatch (``parallel.ep.ep_moe``)."""
        cfg = self.cfg
        if self.mesh is not None and self.mesh.ep > 1:
            from ..parallel.ep import ep_moe
            return ep_moe(x, self, cfg, self.mesh, self.capacity_factor)
        B, T, _ = x.shape
        logits = self.router(x).to(torch.float32)         # [B, T, E]
        top_w, top_idx = moe_route(logits, cfg.n_experts_active,
                                   cfg.moe_norm_topk)
        ex = self.experts
        if not ex.quantized and not ex.biased and B * T >= GROUPED_MIN_ROWS:
            return moe_grouped(x, ex, top_w, top_idx, cfg, self.act,
                               psum=self._psum)
        _cuda.ROUTES.count("moe_mixture")
        mix = torch.zeros_like(logits).scatter_(-1, top_idx, top_w)
        out = None
        for e in range(cfg.n_experts):
            y = ex.mlp(e, x, cfg, self.act).to(torch.float32) \
                * mix[..., e:e + 1]
            out = y if out is None else out + y
        return self._psum(out).to(x.dtype)


def moe_grouped(x, ex: Experts, top_w, top_idx, cfg: ModelConfig, act,
                static: Optional[bool] = None, psum=None):
    """The grouped expert MLP, the JAX ``_moe_grouped``: the B·T·k
    (token, expert) assignments stably sorted by expert id form one row
    group per expert; each projection is one product a group with bf16
    operands and f32 results (:func:`_rdot`), ``act(g) · u`` in f32, the
    down product's operands cast to bf16 again; each row weighted by its
    router weight and added into its token's f32 row, then cast to x's
    dtype.

    Eager (``static`` False), the group sizes are read on the host once.
    Inside a CUDA graph capture (``static`` None: the default there) no
    shape may depend on the data, so each expert takes a fixed capacity of
    S = B·T rows (top-k ids are distinct, so no expert gets more): the
    assignment of rank r in expert e's group (the same stable order) sits
    in row e·S + r of a zero-padded [E·S, D] buffer, every expert's
    products run over its S rows, and each assignment's row is read back
    from its slot. The padding rows' results are never read.

    Summation order: the JAX ``.at[tok].add`` sums each token's k
    contributions in f32, as ``index_add_`` does; on the card the latter is
    atomic, so for k > 2 the sums could differ by their order. For k = 2
    (Mixtral, Grok) the order changes no sum (0 + a + b = 0 + b + a).

    ``psum``: a sharded block's sum over tp of the f32 result, before the
    cast (the JAX ``_moe_grouped``'s)."""
    B, T, D = x.shape
    S, k, E = B * T, cfg.n_experts_active, cfg.n_experts
    dev = x.device
    if static is None:
        static = dev.type == "cuda" and torch.cuda.is_current_stream_capturing()
    _cuda.ROUTES.count("moe_grouped_static" if static else "moe_grouped")
    xf = x.reshape(S, D)
    eid = top_idx.reshape(S * k)
    wts = top_w.reshape(S * k).to(torch.float32)
    tok = torch.arange(S * k, device=dev) // k             # no host read
    if static:
        onehot = eid[:, None] == torch.arange(E, device=dev)[None, :]
        rank = (torch.cumsum(onehot.to(torch.long), 0) - 1).gather(
            1, eid[:, None])[:, 0]
        slot = eid * S + rank                              # [S·k]
        xs = torch.zeros((E * S, D), dtype=x.dtype, device=dev)
        xs.index_copy_(0, slot, xf[tok])
        groups = [(e * S, S) for e in range(E)]
    else:
        order = torch.sort(eid, stable=True).indices
        tok, wts = tok[order], wts[order]
        xs = xf[tok]                                       # [S·k, D]
        sizes = torch.bincount(eid, minlength=E).tolist()
        starts = [sum(sizes[:e]) for e in range(E)]
        groups = list(zip(starts, sizes))

    def per_group(lhs, name):
        w = getattr(ex, name).weight                      # [E, K, N]
        return torch.cat([_rdot(lhs[o:o + n], w[e])
                          for e, (o, n) in enumerate(groups)])

    if cfg.mlp_gated:
        h = act(per_group(xs, "w_gate")) * per_group(xs, "w_up")
    else:
        h = act(per_group(xs, "w_up"))
    d = per_group(h, "w_down")                             # f32
    if static:
        d = d[slot]
    out = torch.zeros((S, D), dtype=torch.float32, device=dev)
    out.index_add_(0, tok, d * wts[:, None])
    if psum is not None:
        out = psum(out)
    return out.reshape(B, T, D).to(x.dtype)


class Transformer(nn.Module):
    """The decoder: ``embed``, (``pos_embed``), (``embed_norm_w``/``_b``),
    ``layers``, ``final_norm_w`` (``final_norm_b``), ``lm_head`` (absent
    when tied to the embedding; ``lm_head_b``), the RoPE table (absent
    without RoPE) and the ALiBi slopes (with ALiBi).

    ``mesh`` (``parallel.sharding.Mesh``): ``params`` are this rank's shards
    (``parallel.sharding.shard_params``), and the graph puts the JAX
    ``forward(tp_axis=...)``'s collectives where it does: a sum over tp
    after wo and after w_down (before their biases), the experts' mixture
    summed once after it, the lm_head's vocabulary slices gathered in rank
    order. With an ep axis the routed experts go through
    ``parallel.ep.ep_moe`` with ``capacity_factor``."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, object],
                 mesh=None, capacity_factor: float = 2.0):
        super().__init__()
        glm1_dim = cfg.rope_style == "glm1" and \
            cfg.rope_dim == cfg.head_dim // 2
        unsupported = [n for n, on in (
            ("arch", cfg.arch not in ARCHS),
            ("norm_type", cfg.norm_type not in ("rmsnorm", "layernorm")),
            ("act", cfg.act not in ACTS),
            ("rope_style", cfg.rope_style not in ("neox", "gptj", "none",
                                                  "glm1")),
            ("rope_dim", cfg.rope_style == "glm1" and not glm1_dim),
            ("final_norm", not cfg.final_norm)) if on]
        if unsupported:
            raise NotImplementedError(
                f"graph features {unsupported}: no family of the JAX "
                "package the port runs has them")
        self.cfg = cfg
        self.mesh = mesh
        self.tp = 1 if mesh is None else mesh.tp
        self.layers = nn.ModuleList(Block(cfg, lp, mesh, capacity_factor)
                                    for lp in params["layers"])
        self.embed_scale = bf16_scalar(cfg.embed_scale)
        for name in ("embed", "pos_embed", "embed_norm_w", "embed_norm_b",
                     "final_norm_w", "final_norm_b", "lm_head_b",
                     "rope_inv_freqs", "alibi_slopes"):
            self.register_buffer(name, params.get(name))
        if cfg.use_alibi and self.alibi_slopes is None:
            raise ValueError("an ALiBi config needs params['alibi_slopes']")
        if cfg.learned_pos_emb and self.pos_embed is None:
            raise ValueError("a learned-position config needs "
                             "params['pos_embed']")
        lm_head = params.get("lm_head")
        self.lm_head = None if lm_head is None else QLinear(lm_head)
        # the final norm can ride a quantized, bias-free lm_head's kernel
        # (the JAX ``forward`` also requires no lm_head bias)
        self.fuse_head = self.lm_head is not None \
            and self.lm_head.cfg is not None \
            and self.final_norm_b is None and self.lm_head_b is None \
            and fusable(lm_head)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def capturable(self) -> bool:
        """A decode step of this model can be captured in a CUDA graph: no
        mesh, or one whose steps hold no collective (``Mesh.
        collective_free_step``)."""
        return self.mesh is None or self.mesh.collective_free_step

    def param_dict(self) -> Dict[str, object]:
        """The param dict this decoder holds (``layers`` a list of per-layer
        dicts), tensors shared, not copied: ``Transformer(cfg,
        model.param_dict())`` builds the same decoder, and
        ``convert.checkpoint.save_checkpoint`` writes it."""
        out: Dict[str, object] = {"layers": [b.weights()
                                             for b in self.layers]}
        for name, buf in self.named_buffers(recurse=False):
            out[name] = buf
        if self.lm_head is not None:
            out["lm_head"] = self.lm_head.param
        return out

    def forward(self, tokens: torch.Tensor, start: torch.Tensor, cache,
                logits_dtype: torch.dtype = torch.float32,
                logit_positions: Optional[torch.Tensor] = None,
                prompt_len: Optional[torch.Tensor] = None):
        """tokens [B, T]; start [B] (cache write offset per row); cache a
        :class:`~neural_tpu_torch.runtime.kvcache.KVCache` or
        :class:`~neural_tpu_torch.runtime.paged.PagedKVCache`, updated in
        place, or None: the cache-less forward of the JAX ``forward(cache=
        None)`` (the training path; on a mesh with an "sp" axis the tokens
        are the rank's sequence shard, ``start`` its global offset, and the
        attention rings over sp), each block attending within the call,
        causal over the global positions.
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
        if self.pos_embed is not None and cache is not None:
            # every position a cache can hold has its row
            self._check_positions(cache)
        x = self.embed_tokens(tokens, positions)
        if (cfg.prefix_lm or cfg.rope_style == "glm1") and prompt_len is None:
            prompt_len = start.long() + T
        rope = self.rope_tables(positions, prompt_len)
        mode, glu = fuse_switches()
        fuse = can_fuse_block(x, cfg, mode, self.tp)
        for l, blk in enumerate(self.layers):
            x = blk(x, None if cache is None else cache.layer(l), positions,
                    rope, self.alibi_slopes, prompt_len, fuse, glu)
        if logit_positions is not None:
            rows = torch.arange(B, device=x.device)[:, None]
            x = x[rows, logit_positions.long()[:, None]]
        if self.fuse_head and can_fuse_block(x, cfg, mode, self.tp):
            # the final norm rides the lm_head kernel's prologue; after
            # logit_positions a prefill's one row qualifies too
            Bx, Tx, Dx = x.shape
            logits = qmatmul_fused(
                x.reshape(-1, Dx), self.lm_head.qt, torch.float32,
                norm=(self.final_norm_w, cfg.norm_eps, cfg.norm_offset)
            ).reshape(Bx, Tx, -1)
            return self._softcap(logits).to(logits_dtype)
        return self.head(x).to(logits_dtype)

    def embed_tokens(self, tokens: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
        """The residual stream's start, [B, T, D] bf16: the embedding rows
        (times Gemma's bf16 embedding scale), plus the learned positions
        (OPT, StarCoder) in the activation dtype, then Bloom's embedding
        LayerNorm."""
        cfg = self.cfg
        x = self.embed[tokens.long()].to(torch.bfloat16)
        if self.embed_scale != 1.0:
            x = x * self.embed_scale
        if self.pos_embed is not None:
            x = x + self.pos_embed[positions + cfg.pos_offset].to(x.dtype)
        if self.embed_norm_w is not None:     # Bloom's embedding LayerNorm
            x = layer_norm(x, self.embed_norm_w, self.embed_norm_b,
                           cfg.norm_eps)
        return x

    def rope_tables(self, positions: torch.Tensor, prompt_len=None):
        """The RoPE tables of the config's style at ``positions`` [B, T]
        (ChatGLM-1's two read ``prompt_len``); None without RoPE."""
        cfg = self.cfg
        if cfg.rope_style == "glm1":
            return glm1_cos_sin(positions, prompt_len, self.rope_inv_freqs)
        if cfg.rope_style == "none":
            return None
        return rope_cos_sin(positions, self.rope_inv_freqs)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The final norm and the lm_head on the residual stream x [B, T,
        D] → f32 logits [B, T, V]: the tied embedding's product or the
        lm_head (its vocabulary slices gathered over tp, then its bias),
        then Gemma-2's final softcap."""
        cfg = self.cfg
        if cfg.norm_type == "rmsnorm":
            x = graph_rms_norm(x, self.final_norm_w, cfg.norm_eps,
                               cfg.norm_offset)
        else:
            x = layer_norm(x, self.final_norm_w, self.final_norm_b,
                           cfg.norm_eps)
        if self.lm_head is None:              # tied embeddings
            logits = self._tied_logits(x)
        else:
            logits = self.lm_head(x, torch.float32)
            if self.tp > 1:
                # the rank's vocabulary slice; the bias is whole
                logits = self.mesh.all_gather(logits, "tp", dim=-1)
            if self.lm_head_b is not None:
                logits = logits + self.lm_head_b.to(torch.float32)
        return self._softcap(logits.to(torch.float32))

    def _softcap(self, logits: torch.Tensor) -> torch.Tensor:
        cap = self.cfg.logit_softcap
        return cap * torch.tanh(logits / cap) if cap else logits

    def _check_positions(self, cache):
        """Raise unless every position ``cache`` can hold, offset by
        ``pos_offset``, has a row of the learned table: read from the
        shapes on the host, so that no position is read out of bounds on
        the card and no step waits on the device."""
        cap = cache.k.shape[3]
        table = getattr(cache, "table", None)
        if table is not None:               # pages of k.shape[3] keys
            cap *= table.shape[1]
        rows = self.pos_embed.shape[0]
        if cap + self.cfg.pos_offset > rows:
            raise ValueError(
                f"a cache of {cap} positions needs {cap + self.cfg.pos_offset}"
                f" rows of the learned position table, which has {rows}: cap "
                f"the cache at {rows - self.cfg.pos_offset} positions")

    def _tied_logits(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., D] @ embed.T with bf16 operands and f32 sums, as the JAX
        package's ``jnp.dot(..., preferred_element_type=f32)``. On the card
        one ``torch.mm`` with ``out_dtype`` (aten::mm.dtype) reads the bf16
        embedding in place; an f32 copy of it would be 3.67 GB per call at
        Gemma-2-9B's vocab, captured into the decode graph's pool. That
        overload does not exist for the CPU, where the product is taken in
        f32 on f32 copies (exact for bf16 operands, as the card's f32 sums),
        and so it is under autograd: ``aten::mm.dtype`` has no derivative.
        An f32 embedding (``dtype="float32"``) is rounded to bf16 first, as
        the JAX package rounds both operands."""
        xb = x.to(torch.bfloat16)
        emb = self.embed.to(torch.bfloat16)
        if x.device.type == "cuda" and not records_grad(x, self.embed):
            out = torch.mm(xb.reshape(-1, xb.shape[-1]), emb.T,
                           out_dtype=torch.float32)
            return out.reshape(*x.shape[:-1], -1)
        return xb.to(torch.float32) @ emb.to(torch.float32).T
