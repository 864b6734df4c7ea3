"""Generation loops: prefill + greedy decode (port of the greedy part of
``neural_tpu/runtime/generate.py``).

``prefill_step`` computes only the last row's logits; ``model_step`` is one
eval of T tokens; ``greedy_generate``/``generate`` drive them from Python
with one host read of the next id per token (as the JAX loops do);
``decode_loop`` is the benchmark unit: a Python loop whose argmax stays on
the device, with one host sync at the end. A prefix-LM model (ChatGLM-1)
takes its prompt length on every decode step (``prompt_len``, a [B] tensor
on the model's device), as the JAX loops pass ``_plen``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core.qtensor import QTensor, to_native
from ..models.config import ModelConfig
from ..models.transformer import Transformer
from ..ops import _cuda
from .kvcache import KVCache, init_cache
from .sampling import SamplingParams, sample


def params_to_native(params):
    """The one conversion to the at-rest layouts, at load, by the rule of the
    JAX package's ``params_to_native`` (``conv_one``): every 2-4 bit int
    QTensor in a param tree (dicts and lists) becomes native-pack, at every
    size (what ``params_to_native(..., force=True, min_elems=0)`` gives);
    5-8 bit int becomes int8 code planes; 1-bit, nf4/fp4 and fp8 stay in
    their stored layout (``core.qtensor.to_native``). Every entry point
    that builds params runs its weights through here before the decoder
    is built."""
    if isinstance(params, QTensor):
        return to_native(params)
    if isinstance(params, dict):
        return {k: params_to_native(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_to_native(v) for v in params)
    return params


def fuse_layer_weights(params, cfg: ModelConfig):
    """Concatenate each layer's q/k/v and gate/up projections along N into
    ``wqkv`` / ``w_gateup`` (with ``bqkv`` / ``b_gateup``), once at load, by
    the rule of the JAX package's ``fuse_layer_weights``: only QTensors of
    one config, all plain or all act-order with identical perms (the GPTQ
    same-Hessian case, where the fused product gathers x once instead of
    three or two times), q/k/v of the config's widths, and biases all
    present or all absent; other layers stay as they are. ``params``: the
    param dict, its ``layers`` a list of per-layer dicts."""
    from ..core.qtensor import concat_n

    def fusable(ts, n_ok):
        if not all(isinstance(t, QTensor) for t in ts) or not n_ok(ts):
            return False
        if len({t.cfg for t in ts}) != 1:
            return False
        if all(t.perm is None for t in ts):
            return True
        return all(t.perm is not None and torch.equal(t.perm, ts[0].perm)
                   for t in ts)

    def fuse(lp, names, biases, fused, fused_b, n_ok):
        ts = [lp.get(k) for k in names]
        bs = [lp.get(k) for k in biases]
        if not fusable(ts, n_ok) or len({b is None for b in bs}) != 1:
            return
        lp[fused] = concat_n(ts)
        if bs[0] is not None:
            lp[fused_b] = torch.cat(bs, dim=-1)
        for k in names + biases:
            lp.pop(k, None)

    if cfg.is_moe:
        return params
    q_n, kv_n = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    layers = []
    for lp in params["layers"]:
        lp = dict(lp)
        fuse(lp, ("wq", "wk", "wv"), ("bq", "bk", "bv"), "wqkv", "bqkv",
             lambda ts: ts[0].N == q_n and ts[1].N == kv_n)
        fuse(lp, ("w_gate", "w_up"), ("b_gate", "b_up"), "w_gateup",
             "b_gateup", lambda ts: ts[0].N == ts[1].N)
        layers.append(lp)
    return dict(params, layers=layers)


@torch.inference_mode()
def model_step(model: Transformer, tokens: torch.Tensor, start: torch.Tensor,
               cache: KVCache,
               prompt_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One eval: tokens [B, T] at cache offsets ``start`` [B] → logits
    [B, T, V] f32; the cache is updated in place. ``prompt_len`` [B]: the
    prompt size a prefix-LM model needs on decode steps."""
    return model(tokens, start, cache, prompt_len=prompt_len)


@torch.inference_mode()
def prefill_step(model: Transformer, tokens: torch.Tensor,
                 start: torch.Tensor, cache: KVCache) -> torch.Tensor:
    """Prefill eval returning only the last token's logits [B, 1, V]: the
    lm_head runs on [B, 1, D] (``logit_positions``). The call is the whole
    prompt, which is what a prefix-LM model takes by default."""
    lens = torch.full(tokens.shape[:1], tokens.shape[1], dtype=torch.long,
                      device=tokens.device)
    return model(tokens, start, cache, logit_positions=lens - 1)


def _prompt(prompt_ids: Sequence[int], device) -> torch.Tensor:
    return torch.tensor([list(prompt_ids)], dtype=torch.long, device=device)


def prompt_lens(cfg: ModelConfig, lens: Sequence[int],
                device) -> Optional[torch.Tensor]:
    """Prompt lengths [B] for the decode steps of a prefix-LM model
    (ChatGLM-1); None for every other model (the JAX package's ``_plen``)."""
    if cfg.prefix_lm or cfg.rope_style == "glm1":
        return torch.tensor(list(lens), dtype=torch.long, device=device)
    return None


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
    plen = prompt_lens(cfg, [T], dev)
    logits = prefill_step(model, _prompt(prompt_ids, dev),
                          torch.zeros(1, dtype=torch.long, device=dev), cache)
    next_id = int(torch.argmax(logits[0, -1]))
    out = list(prompt_ids) + [next_id]
    pos = T
    for _ in range(max_new_tokens - 1):
        if stop_at_eos and next_id in cfg.eos_token_ids:
            break
        logits = model_step(model, torch.tensor([[next_id]], device=dev),
                            torch.tensor([pos], device=dev), cache, plen)
        next_id = int(torch.argmax(logits[0, -1]))
        out.append(next_id)
        pos += 1
    return out


def generate(model: Transformer, cfg: ModelConfig, prompt_ids: Sequence[int],
             sampling: Optional[SamplingParams] = None,
             max_new_tokens: int = 128, max_len: Optional[int] = None,
             stop_at_eos: bool = True, kv_dtype=torch.bfloat16) -> list:
    """Single-sequence generation through the sampling pipeline (penalties
    over the last ``repeat_last_n`` ids, then greedy) over a bf16 or int8
    KV cache. Returns the full id list."""
    sampling = sampling or SamplingParams()
    dev = model.device
    T = len(prompt_ids)
    S = max_len or min(cfg.max_seq_len, T + max_new_tokens)
    cache = init_cache(cfg, 1, S, kv_dtype, device=dev)
    plen = prompt_lens(cfg, [T], dev)
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
                            torch.tensor([pos], device=dev), cache, plen)
        pos += 1
    return out


def _greedy_step(model: Transformer, token: torch.Tensor, pos: torch.Tensor,
                 cache: KVCache, prompt_len=None) -> torch.Tensor:
    logits = model(token, pos, cache, logits_dtype=torch.bfloat16,
                   prompt_len=prompt_len)
    return torch.argmax(logits[:, -1], dim=-1)


class _StepGraph:
    """One greedy decode step captured in a CUDA graph: ``token``/``pos``
    (and a prefix-LM model's ``prompt_len``) are its static inputs, device
    tensors the graph reads at each replay, so no host value is baked into
    it; ``next`` is its static output. Replaying it costs one launch from
    the host instead of the step's ~30 per layer (the JAX package runs the
    loop on the device with ``lax.scan`` for the same reason). Capture runs
    the step once for real first, on a side stream, as CUDA graphs
    require; that step writes the same cache slots the first replay writes
    again, with the same values. The capture takes the path of the fusion
    switches (``models.transformer.fuse_switches``) as they stand; a graph
    lives for one :func:`decode_loop` call, so a switch flipped between
    calls is captured anew, never replayed stale."""

    def __init__(self, model, token, pos, cache, prompt_len=None):
        self.token, self.pos = token.clone(), pos.clone()
        self.prompt_len = None if prompt_len is None else prompt_len.clone()
        step = lambda: _greedy_step(model, self.token, self.pos, cache,
                                    self.prompt_len)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        self.next, self.launches = _cuda.capture(self.graph, step)


@torch.inference_mode()
def decode_loop(model: Transformer, token: torch.Tensor, pos: torch.Tensor,
                cache: KVCache, n_steps: int,
                prompt_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy decode of ``n_steps`` tokens from ``token`` [B, 1] at ``pos``
    [B] (and, for a prefix-LM model, its ``prompt_len`` [B]). The argmax
    feeds the next step on the device; the ids [n_steps, B] come back to
    the host once, at the end. On the card the step is one CUDA graph
    replayed per token; on the CPU it runs eagerly."""
    token, pos = token.long(), pos.long()
    toks = []
    if token.device.type != "cuda":
        for _ in range(n_steps):
            nxt = _greedy_step(model, token, pos, cache, prompt_len)
            toks.append(nxt)
            token, pos = nxt[:, None], pos + 1
        return torch.stack(toks).cpu()
    g = _StepGraph(model, token, pos, cache, prompt_len)
    for _ in range(n_steps):
        g.graph.replay()
        _cuda.add_launches(g.launches)
        toks.append(g.next.clone())
        g.token.copy_(g.next[:, None])
        g.pos.add_(1)
    return torch.stack(toks).cpu()
