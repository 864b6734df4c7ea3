"""Beam search with KV-cache reorder (port of ``neural_tpu/runtime/beam.py``).

Beams are the batch rows of one cache. Each step runs the forward on the
W beams' last ids, takes the joint top-W over W·V log-probs on the device,
reads the parents, ids and scores back to the host, and reorders the
cache's rows by the parents (:func:`~neural_tpu_torch.runtime.kvcache.
reorder_batch`): gathered on the device into a second cache, which then
takes the first one's place; a step whose parents are the identity skips
the gather. Semantics are HF's: early stop once the worst kept hypothesis
can no longer be beaten, a length penalty over the new tokens,
``min_new_tokens`` by masking the stop ids.

The prompt is prefilled once, on row 0 with the lm_head on its last
position only (``logit_positions``), and its KV copied to the other W - 1
rows (:func:`~neural_tpu_torch.runtime.kvcache.copy_kv`), as the
Scheduler's beam groups do; the JAX package prefills the W tiled rows and
reads the last position's logits of the first, the same values.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.transformer import Transformer
from .generate import prefill_step, prompt_lens
from .kvcache import copy_kv, init_cache, reorder_batch


@dataclasses.dataclass
class Hypothesis:
    ids: List[int]
    score: float            # length-penalized log-prob


def stop_mask(eos_ids, V: int, masked: bool, device) -> torch.Tensor:
    """The additive stop-id mask [V] f32 of :func:`rank_beams`: -1e30 at the
    in-vocabulary stop ids while ``masked`` (before ``min_new_tokens``),
    else 0."""
    mask = torch.zeros(V, dtype=torch.float32)
    if masked:
        mask[[t for t in eos_ids if 0 <= t < V]] = -1e30
    return mask.to(device)


def rank_beams(logits: torch.Tensor, scores: torch.Tensor,
               alive: torch.Tensor, eos_mask: torch.Tensor, W: int):
    """The joint top-W expansion of a beam group from its rows' logits
    [R, V] (any float dtype; R = W, or 1 for a prompt's first expansion
    with a zero score): log-softmax in f32, the stop-id mask ``eos_mask``
    [V] added, dead rows (``alive`` [R] False) spawning nothing, then the
    top W of ``scores`` [R] (cumulative log-probs, f32) plus each row's
    log-probs. Returns (parents [W], ids [W] int32, new scores [W] f32), on
    the logits' device. :func:`beam_search` and the Scheduler's beam
    groups both rank through here, so the same logits give the same
    expansion."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    logp = logp + eos_mask[None, :]
    V = logp.shape[-1]
    logp = torch.where(alive[:, None], logp, torch.full_like(logp, -1e30))
    total = scores[:, None] + logp
    top_scores, top_idx = torch.topk(total.reshape(-1), W)
    return top_idx // V, (top_idx % V).to(torch.int32), top_scores


@torch.inference_mode()
def _beam_step(model: Transformer, tokens: torch.Tensor, pos: torch.Tensor,
               scores: torch.Tensor, cache, alive: torch.Tensor,
               eos_mask: torch.Tensor, W: int,
               prompt_len: Optional[torch.Tensor] = None):
    """One beam expansion: tokens [W, 1] at ``pos`` [W]; ``scores`` [W]
    cumulative log-probs; ``alive`` [W] bool; ``eos_mask`` [V] (-1e30 at the
    stop ids before ``min_new_tokens``, else 0). Returns (parents [W], ids
    [W], new scores [W]), on the device; the cache holds the step's keys in
    the parents' rows, for the caller to reorder."""
    logits = model(tokens, pos, cache, prompt_len=prompt_len)
    return rank_beams(logits[:, -1], scores, alive, eos_mask, W)


def beam_search(model: Transformer, cfg: ModelConfig,
                prompt_ids: Sequence[int], beam_size: int = 4,
                max_new_tokens: int = 32, length_penalty: float = 1.0,
                min_new_tokens: int = 0, max_len: Optional[int] = None,
                num_return: Optional[int] = None,
                kv_dtype=torch.bfloat16) -> List[Hypothesis]:
    """Standard beam search. Returns hypotheses sorted by length-penalized
    score (``num_return`` of them, W by default)."""
    W = beam_size
    T = len(prompt_ids)
    S = max_len or min(cfg.max_seq_len, T + max_new_tokens)
    num_return = num_return or W
    dev = model.device
    eos = list(cfg.eos_token_ids)

    cache = init_cache(cfg, W, S, kv_dtype, device=dev)
    spare = None
    prompt = torch.tensor([list(prompt_ids)], dtype=torch.long, device=dev)
    logits = prefill_step(model, prompt,
                          torch.zeros(1, dtype=torch.long, device=dev),
                          cache.rows(0, 1))
    copy_kv(cache, [0] * (W - 1), range(1, W), T)
    V = logits.shape[-1]
    _, top_toks, top_scores = rank_beams(
        logits[0], torch.zeros(1, device=dev),
        torch.ones(1, dtype=torch.bool, device=dev),
        stop_mask(eos, V, min_new_tokens > 0, dev), W)

    beams = [list(prompt_ids) + [int(t)] for t in top_toks.tolist()]
    scores = np.asarray(top_scores.cpu(), np.float64).copy()
    alive = np.ones(W, bool)
    done: List[Hypothesis] = []

    def lp(n_new):  # the length penalty's divisor
        return max(n_new, 1) ** length_penalty

    # the first token may be a stop id (when min_new_tokens <= 1)
    for w in range(W):
        if beams[w][-1] in cfg.eos_token_ids and min_new_tokens <= 1:
            done.append(Hypothesis(beams[w], scores[w] / lp(1)))
            alive[w] = False

    plen = None if prompt_lens(cfg, [T], dev) is None else \
        torch.full((W,), T, dtype=torch.long, device=dev)
    pos = T
    for step in range(1, max_new_tokens):
        if not alive.any():
            break
        tokens = torch.tensor([[b[-1]] for b in beams], dtype=torch.long,
                              device=dev)
        parents, toks, new_scores = _beam_step(
            model, tokens, torch.full((W,), pos, dtype=torch.long,
                                      device=dev),
            torch.tensor(scores, dtype=torch.float32, device=dev), cache,
            torch.tensor(alive, device=dev),
            stop_mask(eos, V, step + 1 <= min_new_tokens, dev), W,
            prompt_len=plen)
        parents = parents.cpu().numpy()
        toks = toks.cpu().numpy()
        new_scores = np.asarray(new_scores.cpu(), np.float64)
        if not np.array_equal(parents, np.arange(W)):
            # into the spare cache (new tensors the first time), then swap
            cache, spare = reorder_batch(cache, torch.from_numpy(parents),
                                         spare), cache

        new_beams, new_alive = [], np.ones(W, bool)
        for w in range(W):
            seq = beams[parents[w]] + [int(toks[w])]
            new_beams.append(seq)
            if int(toks[w]) in cfg.eos_token_ids:
                done.append(Hypothesis(seq, new_scores[w] / lp(step + 1)))
                new_alive[w] = False
                new_scores[w] = -1e30
        beams, scores, alive = new_beams, new_scores, new_alive
        pos += 1

        # early stop: the best score left cannot beat the worst kept one
        if len(done) >= W:
            best_alive = scores[alive].max() if alive.any() else -np.inf
            worst_done = sorted(done, key=lambda h: -h.score)[W - 1].score
            if best_alive / lp(max_new_tokens) < worst_done:
                break

    for w in range(W):
        if alive[w]:
            done.append(Hypothesis(beams[w],
                                   scores[w] / lp(len(beams[w]) - T)))
    done.sort(key=lambda h: -h.score)
    return done[:num_return]
