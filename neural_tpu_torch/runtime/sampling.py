"""Sampling: the penalties and the greedy branch (port of the part of
``neural_tpu/runtime/sampling.py`` that greedy generation runs).

Greedy generation in the reference applies the repetition penalties before
its argmax, so both are here; temperature, top-k/p, TFS, typical and
mirostat sampling are a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


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
