"""Sampling: penalties, top-k / top-p / tail-free / typical filters,
mirostat v1 and v2, greedy (port of ``neural_tpu/runtime/sampling.py``).

Every function works on batched ``[B, V]`` logits on the device, with no
host round trip and no host-to-device copy, so that a CUDA graph can
capture a whole sampled decode step. Filters keep the full ``[B, V]``
shape and mask with ``NEG``, as the JAX package does.

Randomness is explicit: a draw takes ``noise``, uniforms ``[B, V]`` in
[0, 1), or draws them from a ``torch.Generator`` on the logits' device.
:func:`_categorical` turns them into a categorical sample by the
Gumbel-max rule (``argmax(logits + Gumbel)``), which is what
``jax.random.categorical`` computes with its own key stream; the two
packages' streams differ, so sampled ids agree in distribution only. A
graphed step reads a noise buffer that the host refills before each
replay, so that replays draw anew.

Divisions that must match the JAX package divide by a tensor: on the card,
PyTorch divides by a Python scalar by multiplying with its reciprocal.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence

import torch

NEG = -1e30


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.8
    top_k: int = 40            # <=0 → disabled
    top_p: float = 0.95        # >=1 → disabled
    tfs_z: float = 1.0         # <1 → tail-free sampling
    typical_p: float = 1.0     # <1 → locally typical sampling
    repeat_penalty: float = 1.1
    repeat_last_n: int = 64
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    mirostat: int = 0          # 0 off, 1 v1, 2 v2
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1
    greedy: bool = False


class SamplerState(NamedTuple):
    """Per-row sampling state: mirostat's ``mu`` [B] f32."""
    mu: torch.Tensor

    @staticmethod
    def init(batch: int, params: SamplingParams,
             device=None) -> "SamplerState":
        return SamplerState(mu=torch.full((batch,), 2.0 * params.mirostat_tau,
                                          dtype=torch.float32, device=device))


def _div(x: torch.Tensor, d) -> torch.Tensor:
    """x / d with d a Python number or a tensor that broadcasts: the IEEE
    quotient on the card too."""
    if not isinstance(d, torch.Tensor):
        d = torch.full_like(x, d)
    return x / d


# ---------------------------------------------------------------------------
# penalties
# ---------------------------------------------------------------------------


def token_counts(tokens: torch.Tensor, valid: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """tokens [B, T] + validity mask [B, T] → counts [B, V] (f32)."""
    B = tokens.shape[0]
    counts = torch.zeros((B, vocab), dtype=torch.float32,
                         device=tokens.device)
    return counts.scatter_add_(1, tokens.long(), valid.to(torch.float32))


def apply_penalties(logits: torch.Tensor, counts: torch.Tensor,
                    params: SamplingParams) -> torch.Tensor:
    """Repetition (CTRL-style divide/multiply) + OpenAI frequency/presence."""
    seen = counts > 0
    if params.repeat_penalty != 1.0:
        rp = params.repeat_penalty
        penalized = torch.where(logits > 0, _div(logits, rp), logits * rp)
        logits = torch.where(seen, penalized, logits)
    if params.frequency_penalty or params.presence_penalty:
        logits = logits - counts * params.frequency_penalty \
            - seen.to(logits.dtype) * params.presence_penalty
    return logits


def _penalize(logits, prev_tokens, prev_valid, params):
    if prev_tokens is None:
        return logits
    if prev_valid is None:
        prev_valid = torch.ones(prev_tokens.shape, dtype=torch.bool,
                                device=prev_tokens.device)
    counts = token_counts(prev_tokens, prev_valid, logits.shape[-1])
    return apply_penalties(logits, counts, params)


# ---------------------------------------------------------------------------
# filters (keep [B, V], mask with NEG)
# ---------------------------------------------------------------------------


def _sorted_desc(logits):
    return torch.sort(logits, dim=-1, descending=True).values


def top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = _sorted_desc(logits)[..., k - 1:k]
    return logits.masked_fill(logits < kth, NEG)


def _cut_below(logits, sl, n_keep):
    """Mask every logit below the ``n_keep``-th largest (``sl`` sorted
    descending, ``n_keep`` [B] >= 1)."""
    cutoff = sl.gather(-1, (n_keep - 1)[..., None])
    return logits < cutoff


def top_p_filter(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus: keep the smallest prefix of sorted probs whose cumulative
    sum reaches p, the token that crosses p included, the first always."""
    if p >= 1.0:
        return logits
    sl = _sorted_desc(logits)
    probs = torch.softmax(sl, dim=-1)
    keep_sorted = (torch.cumsum(probs, dim=-1) - probs) < p
    n_keep = keep_sorted.sum(-1).clamp_min(1)
    return logits.masked_fill(_cut_below(logits, sl, n_keep), NEG)


def _tfs_keep(sl, z):
    """Tail-free: the count of sorted entries to keep, [B]."""
    probs = torch.softmax(sl, dim=-1)
    d2 = torch.diff(torch.diff(probs, dim=-1), dim=-1).abs()
    d2 = d2 / d2.sum(-1, keepdim=True).clamp_min(1e-12)
    keep = torch.cumsum(d2, dim=-1) < z
    return (keep.sum(-1) + 1).clamp_min(1)


def tail_free_filter(logits: torch.Tensor, z: float) -> torch.Tensor:
    """Cut where the normalized |second derivative| of the sorted probs
    accumulates past z."""
    if z >= 1.0:
        return logits
    sl = _sorted_desc(logits)
    return logits.masked_fill(_cut_below(logits, sl, _tfs_keep(sl, z)), NEG)


def _typical_keep(logits, p, guard_zero: bool):
    """Locally typical: the mask of tokens kept, [B, V] — those whose -log p
    is closest to the entropy, until their mass reaches p."""
    probs = torch.softmax(logits, dim=-1)
    logp = torch.log_softmax(logits, dim=-1)
    terms = probs * logp
    if guard_zero:
        terms = torch.where(probs > 0, terms, torch.zeros_like(terms))
    ent = -terms.sum(-1, keepdim=True)
    order = torch.argsort((-logp - ent).abs(), dim=-1, stable=True)
    ps = probs.gather(-1, order)
    keep_sorted = (torch.cumsum(ps, dim=-1) - ps) < p
    return torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)


def typical_filter(logits: torch.Tensor, p: float) -> torch.Tensor:
    if p >= 1.0:
        return logits
    return logits.masked_fill(~_typical_keep(logits, p, guard_zero=False), NEG)


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------


def draw_noise(shape, device, generator: Optional[torch.Generator] = None
               ) -> torch.Tensor:
    """Uniforms in [0, 1) for one draw of :func:`_categorical`."""
    return torch.rand(shape, generator=generator, device=device,
                      dtype=torch.float32)


def _categorical(logits: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """A categorical sample per row by the Gumbel-max rule: ``argmax(logits
    - log(-log(u)))`` with ``noise`` u uniform in [0, 1) → ids [B] int32.
    A masked logit (NEG) is never drawn."""
    u = noise.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1) \
        .to(torch.int32)


def _mirostat_v2(logits, noise, temperature, eta, tau, state: SamplerState):
    """Truncate tokens whose surprise (bits) exceeds mu, sample, then
    ``mu -= eta · (surprise - tau)``. ``eta``/``tau``: floats or [B]."""
    if not (isinstance(temperature, float) and temperature == 1.0):
        logits = _div(logits, temperature)
    logp = torch.log_softmax(logits, dim=-1)
    surprise = _div(-logp, math.log(2.0))
    trunc = torch.where(surprise > state.mu[:, None],
                        torch.full_like(logits, NEG), logits)
    # keep at least the argmax
    best = torch.argmax(logits, dim=-1, keepdim=True)
    one_hot = torch.zeros_like(logits, dtype=torch.bool).scatter(
        -1, best, True)
    all_cut = (trunc <= NEG / 2).all(-1, keepdim=True)
    only_best = torch.where(one_hot, logits, torch.full_like(logits, NEG))
    trunc = torch.where(all_cut, only_best, trunc)
    tok = _categorical(trunc, noise)
    obs = surprise.gather(-1, tok.long()[:, None])[:, 0]
    return tok, SamplerState(mu=state.mu - eta * (obs - tau))


def _mirostat_v1(logits, noise, temperature, eta, tau, state: SamplerState):
    """Estimate Zipf's s over the top-100 probs, derive k from mu, sample
    from the top k, then update mu as v2 does."""
    if not (isinstance(temperature, float) and temperature == 1.0):
        logits = _div(logits, temperature)
    V = logits.shape[-1]
    m = min(100, V)
    top = torch.topk(logits, m, dim=-1).values
    probs = torch.softmax(top, dim=-1)
    i = torch.arange(m - 1, dtype=torch.float32, device=logits.device)
    ti = torch.log((i + 2.0) / (i + 1.0))
    bi = torch.log(probs[..., :-1] / probs[..., 1:].clamp_min(1e-30))
    s_hat = (ti * bi).sum(-1) / (ti * ti).sum()
    eps = s_hat - 1.0
    k = torch.pow((eps * torch.pow(2.0, state.mu))
                  / (1 - torch.pow(float(V), -eps)),
                  torch.ones_like(s_hat) / s_hat)
    k = k.clamp(1, V).to(torch.int64)
    kth = _sorted_desc(logits).gather(-1, (k - 1)[:, None])
    trunc = logits.masked_fill(logits < kth, NEG)
    tok = _categorical(trunc, noise)
    logp = torch.log_softmax(logits, dim=-1)
    obs = _div(-logp.gather(-1, tok.long()[:, None])[:, 0], math.log(2.0))
    return tok, SamplerState(mu=state.mu - eta * (obs - tau))


def sample(logits: torch.Tensor, params: SamplingParams,
           state: Optional[SamplerState] = None,
           prev_tokens: Optional[torch.Tensor] = None,
           prev_valid: Optional[torch.Tensor] = None,
           noise: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None):
    """The full pipeline, in the reference's order: penalties → [greedy |
    mirostat | temperature → top-k → TFS → typical → top-p → categorical].
    ``noise`` [B, V] (uniforms) or ``generator`` supplies the draw.
    Returns (ids [B] int32, new state)."""
    logits = logits.to(torch.float32)
    B = logits.shape[0]
    if state is None:
        state = SamplerState.init(B, params, logits.device)
    logits = _penalize(logits, prev_tokens, prev_valid, params)
    if params.greedy or params.temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32), state
    if noise is None:
        noise = draw_noise(logits.shape, logits.device, generator)
    if params.mirostat in (1, 2):
        fn = _mirostat_v2 if params.mirostat == 2 else _mirostat_v1
        return fn(logits, noise, float(params.temperature),
                  params.mirostat_eta, params.mirostat_tau, state)
    logits = _div(logits, params.temperature)
    logits = top_k_filter(logits, params.top_k)
    logits = tail_free_filter(logits, params.tfs_z)
    logits = typical_filter(logits, params.typical_p)
    logits = top_p_filter(logits, params.top_p)
    return _categorical(logits, noise), state


class BatchedSamplingParams(NamedTuple):
    """Per-row sampling parameters as tensors [B], so that one batched step
    serves requests with different SamplingParams (the JAX package's
    ``BatchedSamplingParams``). Built by :func:`batch_params`."""
    temperature: torch.Tensor        # [B] f32
    top_k: torch.Tensor              # [B] i32 (<=0 disabled)
    top_p: torch.Tensor              # [B] f32 (>=1 disabled)
    tfs_z: torch.Tensor              # [B] f32 (>=1 disabled)
    typical_p: torch.Tensor          # [B] f32 (>=1 disabled)
    repeat_penalty: torch.Tensor     # [B] f32 (==1 disabled)
    frequency_penalty: torch.Tensor  # [B] f32
    presence_penalty: torch.Tensor   # [B] f32
    mirostat: torch.Tensor           # [B] i32 (0 off, 1 v1, 2 v2)
    mirostat_tau: torch.Tensor       # [B] f32
    mirostat_eta: torch.Tensor       # [B] f32
    greedy: torch.Tensor             # [B] bool
    mask_eos: torch.Tensor           # [B] bool (min-new-tokens suppression)

    def to(self, device) -> "BatchedSamplingParams":
        return BatchedSamplingParams(*(t.to(device) for t in self))

    def copy_(self, other: "BatchedSamplingParams"):
        """Fill these tensors in place (the static buffers of a graph)."""
        for dst, src in zip(self, other):
            dst.copy_(src)


def batch_params(rows: Sequence[SamplingParams],
                 mask_eos=None) -> BatchedSamplingParams:
    """list[SamplingParams] (+ per-row EOS-suppression flags) → CPU
    tensors."""
    f = lambda name: torch.tensor([getattr(r, name) for r in rows],
                                  dtype=torch.float32)
    i = lambda name: torch.tensor([getattr(r, name) for r in rows],
                                  dtype=torch.int32)
    if mask_eos is None:
        mask_eos = [False] * len(rows)
    return BatchedSamplingParams(
        temperature=f("temperature"), top_k=i("top_k"), top_p=f("top_p"),
        tfs_z=f("tfs_z"), typical_p=f("typical_p"),
        repeat_penalty=f("repeat_penalty"),
        frequency_penalty=f("frequency_penalty"),
        presence_penalty=f("presence_penalty"), mirostat=i("mirostat"),
        mirostat_tau=f("mirostat_tau"), mirostat_eta=f("mirostat_eta"),
        greedy=torch.tensor([r.greedy or r.temperature <= 0 for r in rows]),
        mask_eos=torch.tensor(list(mask_eos), dtype=torch.bool))


def _rowwise_filters(logits: torch.Tensor,
                     bp: BatchedSamplingParams) -> torch.Tensor:
    """top-k → TFS → typical → top-p with per-row thresholds, branchless:
    each filter is computed for every row and a disabled row keeps its
    input."""
    V = logits.shape[-1]
    # top-k: each row's k-th value
    sl = _sorted_desc(logits)
    k = bp.top_k.clamp(1, V).long()
    k_on = ((bp.top_k > 0) & (bp.top_k < V))[:, None]
    logits = logits.masked_fill(k_on & _cut_below(logits, sl, k), NEG)
    # tail-free (sorted again: the top-k mask changed the distribution)
    sl = _sorted_desc(logits)
    tfs_on = (bp.tfs_z < 1.0)[:, None]
    drop = _cut_below(logits, sl, _tfs_keep(sl, bp.tfs_z[:, None]))
    logits = logits.masked_fill(tfs_on & drop, NEG)
    # locally typical
    keep = _typical_keep(logits, bp.typical_p[:, None], guard_zero=True)
    logits = logits.masked_fill((bp.typical_p < 1.0)[:, None] & ~keep, NEG)
    # top-p (nucleus); p >= 1 is a no-op
    sl = _sorted_desc(logits)
    probs = torch.softmax(sl, dim=-1)
    keep_sorted = (torch.cumsum(probs, dim=-1) - probs) \
        < bp.top_p.clamp_max(1.0)[:, None]
    n_keep = keep_sorted.sum(-1).clamp_min(1)
    p_on = (bp.top_p < 1.0)[:, None]
    return logits.masked_fill(p_on & _cut_below(logits, sl, n_keep), NEG)


def sample_batched(logits: torch.Tensor, bp: BatchedSamplingParams,
                   mu: Optional[torch.Tensor] = None, eos_ids: tuple = (),
                   prev_tokens: Optional[torch.Tensor] = None,
                   prev_valid: Optional[torch.Tensor] = None,
                   enable: tuple = ("filters", "mirostat"),
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None):
    """Batched sampling with per-row parameters → (ids [B] int32, new mu
    [B]): EOS suppressed on rows with ``bp.mask_eos``, then the per-row
    penalties (skipped when ``prev_tokens`` is None); greedy rows take the
    penalized argmax, mirostat rows their sampler (mu updated), the rest
    temperature → top-k → TFS → typical → top-p → categorical.

    ``enable`` prunes what no row needs, as the JAX package's does: without
    "filters" every non-mirostat row is greedy; without "mirostat" mu
    passes through. One ``noise`` draw [B, V] serves every branch, since
    each row takes one branch's id. ``mu`` defaults to 2·tau per row.

    Device-only work, with no host sync and no host-to-device copy, so a
    CUDA graph can capture it (given ``noise``)."""
    logits = logits.to(torch.float32)
    B, V = logits.shape
    in_vocab = [t for t in eos_ids if 0 <= t < V]
    if in_vocab:
        ids = torch.arange(V, device=logits.device)
        eos_mask = ids == in_vocab[0]
        for t in in_vocab[1:]:
            eos_mask = eos_mask | (ids == t)
        logits = logits.masked_fill(
            bp.mask_eos[:, None] & eos_mask[None, :], NEG)
    if prev_tokens is not None:
        if prev_valid is None:
            prev_valid = torch.ones(prev_tokens.shape, dtype=torch.bool,
                                    device=prev_tokens.device)
        counts = token_counts(prev_tokens, prev_valid, V)
        seen = counts > 0
        rp = bp.repeat_penalty[:, None].expand(B, V)
        pen = torch.where(logits > 0, logits / rp, logits * rp)
        logits = torch.where(seen & (rp != 1.0), pen, logits)
        logits = logits - counts * bp.frequency_penalty[:, None] \
            - seen.to(logits.dtype) * bp.presence_penalty[:, None]

    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    if mu is None:
        mu = 2.0 * bp.mirostat_tau.to(torch.float32)
    if not enable:
        return greedy_tok, mu
    tok, new_mu = greedy_tok, mu
    if noise is None:
        noise = draw_noise(logits.shape, logits.device, generator)
    scaled = logits / bp.temperature.clamp_min(1e-6)[:, None]
    if "filters" in enable:
        plain = _categorical(_rowwise_filters(scaled, bp), noise)
        tok = torch.where(bp.greedy, greedy_tok, plain)
    if "mirostat" in enable:
        # both variants for every row, then a per-row select; temperature
        # 1 because ``scaled`` is already divided
        st = SamplerState(mu=mu)
        m2_tok, m2 = _mirostat_v2(scaled, noise, 1.0, bp.mirostat_eta,
                                  bp.mirostat_tau, st)
        m1_tok, m1 = _mirostat_v1(scaled, noise, 1.0, bp.mirostat_eta,
                                  bp.mirostat_tau, st)
        tok = torch.where(bp.mirostat == 2, m2_tok,
                          torch.where(bp.mirostat == 1, m1_tok, tok))
        tok = torch.where(bp.greedy, greedy_tok, tok)
        new_mu = torch.where(bp.mirostat == 2, m2.mu,
                             torch.where(bp.mirostat == 1, m1.mu, mu))
    return tok, new_mu
