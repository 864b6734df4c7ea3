"""Generation loops: prefill, greedy and sampled decode, ragged batches
(port of ``neural_tpu/runtime/generate.py``).

``prefill_step`` computes only the last row's logits; ``model_step`` is one
eval of T tokens; ``greedy_generate``/``generate`` drive them from Python
with one host read of the next id per token (as the JAX loops do);
``decode_loop`` is the benchmark unit: a Python loop whose argmax stays on
the device, with one host sync at the end; ``sample_loop`` is its sampled
twin, the whole pipeline of ``runtime.sampling`` inside the step;
``batched_generate`` prefills ragged prompts in one padded call and decodes
them together through ``sample_loop``. A prefix-LM model (ChatGLM-1) takes
its prompt length on every decode step (``prompt_len``, a [B] tensor on the
model's device), as the JAX loops pass ``_plen``.

Random draws come from a ``torch.Generator`` on the model's device, seeded
from ``seed``; the JAX package's key streams are not reproduced (sampled
ids agree in distribution, see ``runtime.sampling``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core.qtensor import QTensor, to_native
from ..models.config import ModelConfig
from ..models.transformer import Transformer
from ..ops import _cuda
from .kvcache import KVCache, init_cache
from .sampling import SamplerState, SamplingParams, sample


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


def truncate_at_eos(ids, cfg: ModelConfig):
    """Cut a generated-id list after its first stop token (any of
    ``cfg.eos_token_ids``)."""
    for i, t in enumerate(ids):
        if t in cfg.eos_token_ids:
            return ids[:i + 1]
    return ids


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def generate(model: Transformer, cfg: ModelConfig, prompt_ids: Sequence[int],
             sampling: Optional[SamplingParams] = None,
             max_new_tokens: int = 128, max_len: Optional[int] = None,
             seed: int = 0, stop_at_eos: bool = True,
             kv_dtype=torch.bfloat16, on_token=None,
             cache: Optional[KVCache] = None, start: int = 0) -> list:
    """Single-sequence generation through the sampling pipeline (penalties
    over the last ``repeat_last_n`` ids, then greedy, mirostat or the
    filters and a draw from a generator seeded with ``seed``) over a bf16
    or int8 KV cache. Returns the full id list.

    ``on_token(ids, logits)``, if given, is called after each new id with
    the prompt and the ids so far and the f32 logits row [V] that id was
    drawn from; a true return stops there (a streamer, a stopping
    criterion). ``cache`` continues a cache filled to ``start`` (an
    interactive round): the prompt is prefilled at ``start`` and the run
    ends at the cache's length. The cache then holds every returned id but
    the last, which the next round's first position overwrites."""
    sampling = sampling or SamplingParams()
    dev = model.device
    T = len(prompt_ids)
    if cache is None:
        S = max_len or min(cfg.max_seq_len, T + max_new_tokens)
        cache = init_cache(cfg, 1, S, kv_dtype, device=dev)
    S = cache.k.shape[3]
    plen = prompt_lens(cfg, [start + T], dev)
    gen = _generator(dev, seed)
    state = SamplerState.init(1, sampling, dev)
    logits = prefill_step(model, _prompt(prompt_ids, dev),
                          torch.full((1,), start, dtype=torch.long,
                                     device=dev), cache)
    out = list(prompt_ids)
    pos = start + T
    for i in range(max_new_tokens):
        hist = None
        if sampling.repeat_last_n > 0:   # 0 disables penalties
            hist = torch.tensor([out[-sampling.repeat_last_n:]],
                                dtype=torch.long, device=dev)
        tok, state = sample(logits[:, -1], sampling, state, prev_tokens=hist,
                            generator=gen)
        next_id = int(tok[0])
        out.append(next_id)
        if on_token is not None and on_token(
                out, logits[0, -1].to(torch.float32)):
            break
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


class _Graph:
    """A decode step ``body`` (a function of no arguments over static
    tensors) captured in a CUDA graph. CUDA graphs ask for one real run
    first, on a side stream; the ``state`` tensors that run advances are
    put back, and the cache slot it writes is the one the first replay
    writes again, with the same values. :meth:`replay` runs the graph,
    counts its kernels' launches and returns the body's output, a static
    tensor that the next replay overwrites. Replaying costs one launch
    from the host instead of the step's ~30 per layer (the JAX package runs
    its loops on the device with ``lax.scan`` for the same reason)."""

    def __init__(self, body, state=()):
        saved = [t.clone() for t in state]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream().wait_stream(side)
        for t, v in zip(state, saved):
            t.copy_(v)
        self.graph = torch.cuda.CUDAGraph()
        self.out, self.launches = _cuda.capture(self.graph, body)

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        _cuda.add_launches(self.launches)
        return self.out


class _StepGraph(_Graph):
    """One greedy decode step as a :class:`_Graph`: ``token``/``pos`` (and
    a prefix-LM model's ``prompt_len``) are its static inputs, device
    tensors the graph reads at each replay, so no host value is baked into
    it; ``out`` is the next ids [B]. The capture takes the path of the
    fusion switches (``models.transformer.fuse_switches``) as they stand; a
    graph lives for one :func:`decode_loop` call, so a switch flipped
    between calls is captured anew, never replayed stale."""

    def __init__(self, model, token, pos, cache, prompt_len=None):
        self.token, self.pos = token.clone(), pos.clone()
        self.prompt_len = None if prompt_len is None else prompt_len.clone()
        super().__init__(lambda: _greedy_step(model, self.token, self.pos,
                                              cache, self.prompt_len))


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
        nxt = g.replay()
        toks.append(nxt.clone())
        g.token.copy_(nxt[:, None])
        g.pos.add_(1)
    return torch.stack(toks).cpu()


class _SampledStep:
    """One sampled decode step over static state tensors, so that a CUDA
    graph can capture it: ``token`` [B, 1] and ``pos`` [B] (and a prefix-LM
    model's ``prompt_len``), the penalty ring ``history`` [B, R] with its
    validity mask, mirostat's ``mu`` [B] (2·tau unless given) and, unless
    the sampling is greedy, the draw's ``noise`` [B, V]. The step runs the
    forward, the whole sampling pipeline and the state updates (the ring
    shifted by the new id, mu, token, pos + 1) on the device, with no host
    read and no host-to-device copy. :meth:`step` refills ``noise`` from
    the generator (outside any graph, so each replay draws anew) and runs
    the step: on the card as one CUDA graph replay (:meth:`capture`
    first), on the CPU eagerly. The cache is written in place, so a graph
    stays valid across the in-place StreamingLLM shift."""

    def __init__(self, model: Transformer, cache: KVCache,
                 sampling: SamplingParams, token: torch.Tensor,
                 pos: torch.Tensor, history: Optional[torch.Tensor] = None,
                 history_valid: Optional[torch.Tensor] = None,
                 prompt_len: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 mu: Optional[torch.Tensor] = None):
        dev = token.device
        B = token.shape[0]
        self.model, self.cache, self.sampling = model, cache, sampling
        self.token, self.pos = token.long().clone(), pos.long().clone()
        self.prompt_len = None if prompt_len is None else prompt_len.clone()
        self.penalties = sampling.repeat_last_n > 0 and history is not None
        if self.penalties:
            self.history = history.long().clone()
            self.history_valid = torch.ones(history.shape, dtype=torch.bool,
                                            device=dev) \
                if history_valid is None else history_valid.clone()
        self.mu = SamplerState.init(B, sampling, dev).mu if mu is None \
            else mu.to(torch.float32).clone()
        greedy = sampling.greedy or sampling.temperature <= 0
        self.noise = None if greedy else torch.zeros(
            (B, model.cfg.vocab_size), dtype=torch.float32, device=dev)
        self.generator = generator
        self.graph = None

    def _state(self):
        return [t for t in (self.token, self.pos, self.mu) + (
            (self.history, self.history_valid) if self.penalties else ())]

    def _body(self) -> torch.Tensor:
        logits = self.model(self.token, self.pos, self.cache,
                            logits_dtype=torch.float32,
                            prompt_len=self.prompt_len)
        hist = self.history if self.penalties else None
        valid = self.history_valid if self.penalties else None
        tok, st = sample(logits[:, -1], self.sampling, SamplerState(self.mu),
                         prev_tokens=hist, prev_valid=valid, noise=self.noise)
        if self.penalties:
            self.history.copy_(torch.cat(
                [self.history[:, 1:], tok[:, None].long()], dim=1))
            self.history_valid.copy_(torch.cat(
                [self.history_valid[:, 1:],
                 torch.ones_like(self.history_valid[:, :1])], dim=1))
        self.mu.copy_(st.mu)
        self.token.copy_(tok[:, None])
        self.pos.add_(1)
        return tok

    def reset(self, token: torch.Tensor, pos: torch.Tensor,
              history: Optional[torch.Tensor] = None,
              history_valid: Optional[torch.Tensor] = None,
              prompt_len: Optional[torch.Tensor] = None):
        """Put a new starting state into the static tensors, in place, so a
        captured graph replays from it (a scheduler's next decode block):
        ``token``, ``pos``, the penalty ring and its mask (all valid when
        ``history_valid`` is None) and a prefix-LM model's ``prompt_len``;
        mu goes back to 2·tau."""
        self.token.copy_(token)
        self.pos.copy_(pos)
        if self.penalties:
            self.history.copy_(history)
            if history_valid is None:
                self.history_valid.fill_(True)
            else:
                self.history_valid.copy_(history_valid)
        if self.prompt_len is not None:
            self.prompt_len.copy_(prompt_len)
        self.mu.fill_(2.0 * self.sampling.mirostat_tau)

    def capture(self):
        """Capture the step in a CUDA graph (:class:`_Graph`)."""
        if self.noise is not None:
            self.noise.uniform_(0.0, 1.0, generator=self.generator)
        self.graph = _Graph(self._body, self._state())

    def step(self) -> torch.Tensor:
        """One step → the ids [B] (a tensor of its own, on the device)."""
        if self.noise is not None:
            self.noise.uniform_(0.0, 1.0, generator=self.generator)
        if self.graph is None:
            return self._body()
        return self.graph.replay().clone()


@torch.inference_mode()
def sample_loop(model: Transformer, token: torch.Tensor, pos: torch.Tensor,
                cache: KVCache, n_steps: int, sampling: SamplingParams,
                generator: Optional[torch.Generator] = None,
                history: Optional[torch.Tensor] = None,
                history_valid: Optional[torch.Tensor] = None,
                prompt_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sampled decode of ``n_steps`` tokens from ``token`` [B, 1] at ``pos``
    [B]: :func:`decode_loop` with the full sampling pipeline in each step.
    ``history`` [B, repeat_last_n] holds the recent ids for the penalties
    (a ring updated on the device), ``history_valid`` marks its real
    entries (False at the pads of a short prompt). Mirostat's mu starts at
    2·tau. The ids [n_steps, B] come back to the host once, at the end. On
    the card the step is one CUDA graph replayed per token."""
    st = _SampledStep(model, cache, sampling, token, pos, history,
                      history_valid, prompt_len, generator)
    if token.device.type == "cuda":
        st.capture()
    toks = [st.step() for _ in range(n_steps)]
    return torch.stack(toks).cpu()


@torch.inference_mode()
def _prefill_ragged(model: Transformer, tokens: torch.Tensor,
                    lens: torch.Tensor, cache: KVCache) -> torch.Tensor:
    """Right-padded batched prefill: tokens [B, Tmax] with real lengths
    ``lens`` [B] → each row's last real token's logits [B, V]. Pad positions
    write junk keys at offsets >= lens[b]; decode never attends them (each
    row's length bounds its attention) and overwrites them one a step.
    ``lens`` is also the prompt length a prefix-LM model reads."""
    start = torch.zeros(tokens.shape[:1], dtype=torch.long,
                        device=tokens.device)
    return model(tokens, start, cache, prompt_len=lens,
                 logit_positions=lens - 1)[:, 0]


def _history(rows, rl: int, device):
    """Each row's last ``rl`` ids, right-aligned, with the validity mask;
    (None, None) when ``rl`` <= 0 turns the penalties off."""
    if rl <= 0:
        return None, None
    hist = torch.zeros((len(rows), rl), dtype=torch.long)
    valid = torch.zeros((len(rows), rl), dtype=torch.bool)
    for b, r in enumerate(rows):
        tail = list(r)[-rl:]
        if tail:
            hist[b, -len(tail):] = torch.tensor(tail)
            valid[b, -len(tail):] = True
    return hist.to(device), valid.to(device)


@torch.inference_mode()
def batched_generate(model: Transformer, cfg: ModelConfig, rows,
                     sampling: Optional[SamplingParams] = None,
                     max_new_tokens: int = 128, max_len: Optional[int] = None,
                     seed: int = 0, stop_at_eos: bool = True,
                     kv_dtype=torch.bfloat16) -> list:
    """Ragged multi-prompt generation: one padded prefill and one decode
    loop (:func:`sample_loop`) for all rows. Returns full id lists, each cut
    at the cache end and, with ``stop_at_eos``, after its first stop
    token."""
    sampling = sampling or SamplingParams()
    dev = model.device
    B = len(rows)
    lens = [len(r) for r in rows]
    Tmax = max(lens)
    S = max_len or min(cfg.max_seq_len, Tmax + max_new_tokens)
    if Tmax >= S:
        raise ValueError(f"prompt ({Tmax}) does not fit max_len {S}")
    # the longest row bounds the whole batch, as in the row-wise loop
    max_new_tokens = min(max_new_tokens, S - Tmax)
    toks = torch.zeros((B, Tmax), dtype=torch.long)
    for b, r in enumerate(rows):
        toks[b, :len(r)] = torch.tensor(list(r), dtype=torch.long)
    cache = init_cache(cfg, B, S, kv_dtype, device=dev)
    tlens = torch.tensor(lens, dtype=torch.long, device=dev)
    logits = _prefill_ragged(model, toks.to(dev), tlens, cache)
    gen = _generator(dev, seed)
    hist, valid = _history(rows, sampling.repeat_last_n, dev)
    tok0, _ = sample(logits, sampling, SamplerState.init(B, sampling, dev),
                     prev_tokens=hist, prev_valid=valid, generator=gen)
    new = tok0[:, None].cpu()
    if max_new_tokens > 1:
        if hist is not None:
            hist = torch.cat([hist[:, 1:], tok0[:, None].long()], dim=1)
            valid = torch.cat([valid[:, 1:], torch.ones_like(valid[:, :1])],
                              dim=1)
        rest = sample_loop(model, tok0[:, None], tlens, cache,
                           max_new_tokens - 1, sampling, gen, hist, valid,
                           prompt_lens(cfg, lens, dev))
        new = torch.cat([new, rest.T], dim=1)
    outs = []
    for b, r in enumerate(rows):
        ids = new[b, :min(max_new_tokens, S - len(r))].tolist()
        if stop_at_eos:
            ids = truncate_at_eos(ids, cfg)
        outs.append(list(r) + ids)
    return outs


@torch.inference_mode()
def batch_logits(model: Transformer, cfg: ModelConfig, input_ids,
                 max_len: Optional[int] = None) -> torch.Tensor:
    """Full-sequence logits [B, T, V] f32 of a [B, T] batch (teacher-forced
    evaluation)."""
    dev = model.device
    ids = torch.as_tensor(input_ids, dtype=torch.long).to(dev)
    B, T = ids.shape
    cache = init_cache(cfg, B, max_len or T, device=dev)
    return model_step(model, ids, torch.zeros(B, dtype=torch.long,
                                              device=dev), cache)
