"""Sampling: the penalties and the greedy branch (port of the part of
``neural_tpu/runtime/sampling.py`` that greedy generation and the serving
step run).

Greedy generation in the reference applies the repetition penalties before
its argmax, so both are here, for one row set (:func:`sample`) and with
per-row parameters for a batch (:func:`batch_params`,
:func:`sample_batched`, the serving step's sampler). Temperature, top-k/p,
TFS, typical and mirostat sampling are a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch

NEG = -1e30


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.8
    top_k: int = 40            # <=0 → disabled
    top_p: float = 0.95        # >=1 → disabled
    tfs_z: float = 1.0
    typical_p: float = 1.0
    repeat_penalty: float = 1.1
    repeat_last_n: int = 64
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    mirostat: int = 0
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1
    greedy: bool = False


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
        # a tensor divisor: IEEE division on the card too
        penalized = torch.where(logits > 0,
                                logits / torch.full_like(logits, rp),
                                logits * rp)
        logits = torch.where(seen, penalized, logits)
    if params.frequency_penalty or params.presence_penalty:
        logits = logits - counts * params.frequency_penalty \
            - seen.to(logits.dtype) * params.presence_penalty
    return logits


def sample(logits: torch.Tensor, params: SamplingParams,
           prev_tokens: Optional[torch.Tensor] = None,
           prev_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Penalties, then the greedy argmax → token ids [B] int32."""
    logits = logits.to(torch.float32)
    if prev_tokens is not None:
        if prev_valid is None:
            prev_valid = torch.ones(prev_tokens.shape, dtype=torch.bool,
                                    device=prev_tokens.device)
        counts = token_counts(prev_tokens, prev_valid, logits.shape[-1])
        logits = apply_penalties(logits, counts, params)
    if params.greedy or params.temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    raise NotImplementedError(
        "stochastic sampling (temperature, top-k/p, TFS, typical, mirostat) "
        "is a later slice; use greedy=True")


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


def sample_batched(logits: torch.Tensor, bp: BatchedSamplingParams,
                   eos_ids: tuple = (),
                   prev_tokens: Optional[torch.Tensor] = None,
                   prev_valid: Optional[torch.Tensor] = None,
                   enable: tuple = ()) -> torch.Tensor:
    """Batched sampling with per-row parameters → token ids [B] int32: EOS
    suppressed on rows with ``bp.mask_eos``, then the per-row penalties
    (skipped when ``prev_tokens`` is None), then the argmax. ``enable`` is
    the JAX package's switch for the stochastic rows' filters and mirostat;
    with ``enable=()`` every row is greedy, which is all this slice runs.

    Device-only work, with no host sync and no host-to-device copy, so a
    CUDA graph can capture it."""
    if enable:
        raise NotImplementedError(
            f"sample_batched(enable={enable}): filters and mirostat are a "
            "later slice")
    logits = logits.to(torch.float32)
    B, V = logits.shape
    in_vocab = [t for t in eos_ids if 0 <= t < V]
    if in_vocab:
        ids = torch.arange(V, device=logits.device)
        eos_mask = ids == in_vocab[0]
        for t in in_vocab[1:]:
            eos_mask = eos_mask | (ids == t)
        logits = torch.where(bp.mask_eos[:, None] & eos_mask[None, :],
                             torch.full_like(logits, NEG), logits)
    if prev_tokens is not None:
        if prev_valid is None:
            prev_valid = torch.ones(prev_tokens.shape, dtype=torch.bool,
                                    device=prev_tokens.device)
        counts = token_counts(prev_tokens, prev_valid, V)
        seen = counts > 0
        rp = bp.repeat_penalty[:, None].expand(B, V)
        # a tensor divisor: IEEE division on the card too
        pen = torch.where(logits > 0, logits / rp, logits * rp)
        logits = torch.where(seen & (rp != 1.0), pen, logits)
        logits = logits - counts * bp.frequency_penalty[:, None] \
            - seen.to(logits.dtype) * bp.presence_penalty[:, None]
    return torch.argmax(logits, dim=-1).to(torch.int32)
