"""Generation loops: prefill + greedy decode (port of the greedy part of
``neural_tpu/runtime/generate.py``).

``prefill_step`` computes only the last row's logits; ``model_step`` is one
eval of T tokens; ``greedy_generate``/``generate`` drive them from Python
with one host read of the next id per token (as the JAX loops do);
``decode_loop`` is the benchmark unit: a Python loop whose argmax stays on
the device, with one host sync at the end.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core.qtensor import QTensor, to_native_packed
from ..models.config import ModelConfig
from ..models.transformer import Transformer
from .kvcache import KVCache, init_cache
from .sampling import SamplingParams, sample


def params_to_native(params):
    """The one conversion to the at-rest layout, at load: every QTensor in a
    param tree (dicts and lists) becomes native-pack (uint8 nibbles, bf16
    scales). Every builder of the port runs its weights through here before
    the decoder is built, so the kernels see one layout only — what the JAX
    package's ``params_to_native(..., force=True, min_elems=0)`` gives."""
    if isinstance(params, QTensor):
        return to_native_packed(params)
    if isinstance(params, dict):
        return {k: params_to_native(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_to_native(v) for v in params)
    return params


@torch.inference_mode()
def model_step(model: Transformer, tokens: torch.Tensor, start: torch.Tensor,
               cache: KVCache) -> torch.Tensor:
    """One eval: tokens [B, T] at cache offsets ``start`` [B] → logits
    [B, T, V] f32; the cache is updated in place."""
    return model(tokens, start, cache)


@torch.inference_mode()
def prefill_step(model: Transformer, tokens: torch.Tensor,
                 start: torch.Tensor, cache: KVCache) -> torch.Tensor:
    """Prefill eval returning only the last token's logits [B, 1, V]: the
    lm_head runs on [B, 1, D] (``logit_positions``)."""
    lens = torch.full(tokens.shape[:1], tokens.shape[1], dtype=torch.long,
                      device=tokens.device)
    return model(tokens, start, cache, logit_positions=lens - 1)


def _prompt(prompt_ids: Sequence[int], device) -> torch.Tensor:
    return torch.tensor([list(prompt_ids)], dtype=torch.long, device=device)


def greedy_generate(model: Transformer, cfg: ModelConfig,
                    prompt_ids: Sequence[int], max_new_tokens: int = 32,
                    max_len: Optional[int] = None,
                    stop_at_eos: bool = True) -> list:
    """Single-sequence greedy decode (argmax, no penalties). Returns the
    full id list."""
    dev = model.device
    T = len(prompt_ids)
    S = max_len or min(cfg.max_seq_len, T + max_new_tokens)
    cache = init_cache(cfg, 1, S, device=dev)
    logits = prefill_step(model, _prompt(prompt_ids, dev),
                          torch.zeros(1, dtype=torch.long, device=dev), cache)
    next_id = int(torch.argmax(logits[0, -1]))
    out = list(prompt_ids) + [next_id]
    pos = T
    for _ in range(max_new_tokens - 1):
        if stop_at_eos and next_id in cfg.eos_token_ids:
            break
        logits = model_step(model, torch.tensor([[next_id]], device=dev),
                            torch.tensor([pos], device=dev), cache)
        next_id = int(torch.argmax(logits[0, -1]))
        out.append(next_id)
        pos += 1
    return out


def generate(model: Transformer, cfg: ModelConfig, prompt_ids: Sequence[int],
             sampling: Optional[SamplingParams] = None,
             max_new_tokens: int = 128, max_len: Optional[int] = None,
             stop_at_eos: bool = True) -> list:
    """Single-sequence generation through the sampling pipeline (penalties
    over the last ``repeat_last_n`` ids, then greedy). Returns the full id
    list."""
    sampling = sampling or SamplingParams()
    dev = model.device
    T = len(prompt_ids)
    S = max_len or min(cfg.max_seq_len, T + max_new_tokens)
    cache = init_cache(cfg, 1, S, device=dev)
    logits = prefill_step(model, _prompt(prompt_ids, dev),
                          torch.zeros(1, dtype=torch.long, device=dev), cache)
    out = list(prompt_ids)
    pos = T
    for i in range(max_new_tokens):
        if sampling.repeat_last_n <= 0:   # 0 disables penalties
            tok = sample(logits[:, -1], sampling)
        else:
            hist = torch.tensor([out[-sampling.repeat_last_n:]],
                                dtype=torch.long, device=dev)
            tok = sample(logits[:, -1], sampling, prev_tokens=hist)
        next_id = int(tok[0])
        out.append(next_id)
        if stop_at_eos and next_id in cfg.eos_token_ids:
            break
        if i == max_new_tokens - 1 or pos + 1 >= S:
            break
        logits = model_step(model, torch.tensor([[next_id]], device=dev),
                            torch.tensor([pos], device=dev), cache)
        pos += 1
    return out


def _greedy_step(model: Transformer, token: torch.Tensor, pos: torch.Tensor,
                 cache: KVCache) -> torch.Tensor:
    logits = model(token, pos, cache, logits_dtype=torch.bfloat16)
    return torch.argmax(logits[:, -1], dim=-1)


class _StepGraph:
    """One greedy decode step captured in a CUDA graph: ``token``/``pos``
    are its static inputs, ``next`` its static output. Replaying it costs
    one launch from the host instead of the step's ~30 per layer (the JAX
    package runs the loop on the device with ``lax.scan`` for the same
    reason). Capture runs the step once for real first, on a side stream,
    as CUDA graphs require; that step writes the same cache slots the
    first replay writes again, with the same values."""

    def __init__(self, model, token, pos, cache):
        self.token, self.pos = token.clone(), pos.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            _greedy_step(model, self.token, self.pos, cache)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.next = _greedy_step(model, self.token, self.pos, cache)


@torch.inference_mode()
def decode_loop(model: Transformer, token: torch.Tensor, pos: torch.Tensor,
                cache: KVCache, n_steps: int) -> torch.Tensor:
    """Greedy decode of ``n_steps`` tokens from ``token`` [B, 1] at ``pos``
    [B]. The argmax feeds the next step on the device; the ids [n_steps, B]
    come back to the host once, at the end. On the card the step is one
    CUDA graph replayed per token; on the CPU it runs eagerly."""
    token, pos = token.long(), pos.long()
    toks = []
    if token.device.type != "cuda":
        for _ in range(n_steps):
            nxt = _greedy_step(model, token, pos, cache)
            toks.append(nxt)
            token, pos = nxt[:, None], pos + 1
        return torch.stack(toks).cpu()
    g = _StepGraph(model, token, pos, cache)
    for _ in range(n_steps):
        g.graph.replay()
        toks.append(g.next.clone())
        g.token.copy_(g.next[:, None])
        g.pos.add_(1)
    return torch.stack(toks).cpu()
