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

The prompt is prefilled on the W tiled rows with the lm_head on the last
row only (``logit_positions``); the JAX package computes every row's logits
and reads the last one, the same value.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.transformer import Transformer
from .generate import prefill_step, prompt_lens
from .kvcache import init_cache, reorder_batch


@dataclasses.dataclass
class Hypothesis:
    ids: List[int]
    score: float            # length-penalized log-prob


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
    logp = torch.log_softmax(logits[:, -1].to(torch.float32), dim=-1)
    logp = logp + eos_mask[None, :]
    V = logp.shape[-1]
    # dead beams must not spawn
    logp = torch.where(alive[:, None], logp, torch.full_like(logp, -1e30))
    total = scores[:, None] + logp
    top_scores, top_idx = torch.topk(total.reshape(-1), W)
    return top_idx // V, (top_idx % V).to(torch.int32), top_scores


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
    prompt = torch.tensor([list(prompt_ids)] * W, dtype=torch.long,
                          device=dev)
    logits = prefill_step(model, prompt,
                          torch.zeros(W, dtype=torch.long, device=dev), cache)
    logp0 = torch.log_softmax(logits[0, -1].to(torch.float32), dim=-1)
    if min_new_tokens > 0:
        in_vocab = [t for t in eos if 0 <= t < logp0.shape[-1]]
        logp0[in_vocab] += -1e30
    top_scores, top_toks = torch.topk(logp0, W)

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
    V = cfg.vocab_size
    pos = T
    for step in range(1, max_new_tokens):
        if not alive.any():
            break
        eos_mask = np.zeros(V, np.float32)
        if step + 1 <= min_new_tokens:
            eos_mask[[t for t in eos if 0 <= t < V]] = -1e30
        tokens = torch.tensor([[b[-1]] for b in beams], dtype=torch.long,
                              device=dev)
        parents, toks, new_scores = _beam_step(
            model, tokens, torch.full((W,), pos, dtype=torch.long,
                                      device=dev),
            torch.tensor(scores, dtype=torch.float32, device=dev), cache,
            torch.tensor(alive, device=dev),
            torch.from_numpy(eos_mask).to(dev), W, prompt_len=plen)
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
