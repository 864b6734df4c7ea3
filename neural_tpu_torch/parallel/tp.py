"""Tensor- and data-parallel generation (port of
``neural_tpu/parallel/tp.py``).

The JAX package wraps ``forward(tp_axis="tp")`` in ``shard_map`` over a
(dp, tp) mesh; here every rank runs the sharded decoder
(``parallel.sharding.shard_model``, a ``Transformer`` that carries its
mesh), whose graph sums and gathers over its tp group, on its dp rows of
the batch. The steps and loops below take the global batch, as the JAX
ones take dp-sharded global arrays, and give back the global result on
every rank (gathered over dp); the cache is the rank's own
(``parallel.sharding.init_cache`` / ``shard_cache``).

Every rank of a tp group computes the same logits (replicated after the
vocabulary gather) and so draws the same token from the same noise: each
rank's ``torch.Generator`` is seeded from ``seed``, with the dp
coordinate folded in under dp > 1 (the JAX ``fold_in(key,
axis_index("dp"))``). At dp = 1 the draws are those of the single-device
``batched_generate`` with the same seed.

A step that holds a collective runs eagerly (``Transformer.capturable``):
a gloo collective cannot be captured in a CUDA graph, and no NCCL capture
path is written yet. A step without one (dp only) is graphed as on one
device.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models.config import ModelConfig
from ..runtime.generate import (_history, _prefill_ragged, decode_loop,
                                prompt_lens, sample_loop, truncate_at_eos)
from ..runtime.sampling import SamplerState, SamplingParams, sample
from .sharding import Mesh, dp_rows, init_cache, shard_model

# fold_in's multiplier: the dp coordinate moves the seed by an odd 63-bit
# constant (the golden ratio's), so no two dp ranks share a stream
_FOLD = 0x9E3779B97F4A7C15 & ((1 << 63) - 1)


def rank_generator(mesh: Mesh, seed: int, device) -> torch.Generator:
    """This rank's generator: seeded with ``seed`` at dp = 1 (every rank,
    and the single-device loops, alike), with the dp coordinate folded in
    under dp > 1."""
    s = int(seed)
    if mesh.dp > 1:
        s = (s + mesh.index("dp") * _FOLD) % (1 << 63)
    return torch.Generator(device=device).manual_seed(s)


def make_tp_step(model):
    """A sharded model step: ``step(tokens, start, cache)`` with the global
    tokens [B, T] and offsets [B] (the same on every rank), this rank's
    cache (updated in place), → the global logits [B, T, V] f32 on every
    rank. The TP analog of ``model_step``; ``model`` is the rank's sharded
    decoder."""
    mesh = model.mesh

    @torch.inference_mode()
    def step(tokens, start, cache):
        dev = model.device
        logits = model(dp_rows(mesh, tokens.to(dev)),
                       dp_rows(mesh, start.to(dev)), cache)
        return mesh.all_gather(logits, "dp", dim=0)
    return step


def make_tp_prefill(model):
    """A sharded ragged prefill: ``prefill(tokens, lens, cache)`` with the
    global right-padded tokens [B, Tmax] and real lengths [B] → each row's
    last real token's logits [B, V] (the lm_head on one row a sequence,
    ``logit_positions``), on every rank. The TP analog of
    ``runtime.generate._prefill_ragged``."""
    mesh = model.mesh

    def prefill(tokens, lens, cache):
        dev = model.device
        logits = _prefill_ragged(model, dp_rows(mesh, tokens.to(dev)),
                                 dp_rows(mesh, lens.to(dev)), cache)
        return mesh.all_gather(logits, "dp", dim=0)
    return prefill


def make_tp_decode_loop(model, n_steps: int,
                        sampling: Optional[SamplingParams] = None):
    """A sharded decode loop of ``n_steps`` tokens, the ids kept on the
    device between steps.

    Greedy (``sampling`` None): ``loop(token, pos, cache)`` → ids
    [n_steps, B] (``runtime.generate.decode_loop``, its logits rounded to
    bf16 before the argmax, as the JAX loop's).

    Sampled: ``loop(token, pos, cache, generator, history, hvalid)`` → ids,
    with the whole sampling pipeline (penalties over the ``history`` ring,
    top-k/p, typical, TFS, mirostat) on the replicated logits
    (``runtime.generate.sample_loop``): every tp rank draws the same id, so
    no collective is added. ``generator`` is the rank's
    (:func:`rank_generator`).

    ``token`` [B, 1], ``pos`` [B], ``history``/``hvalid`` [B, R] and a
    prefix-LM model's ``prompt_len`` [B] are global; the ids come back
    global on every rank, on the host."""
    mesh = model.mesh

    def loop(token, pos, cache, generator=None, history=None, hvalid=None,
             prompt_len=None):
        dev = model.device
        rows = lambda t: None if t is None else dp_rows(mesh, t.to(dev))
        tok, p, plen = rows(token), rows(pos), rows(prompt_len)
        if sampling is None:
            ids = decode_loop(model, tok, p, cache, n_steps, plen)
        else:
            ids = sample_loop(model, tok, p, cache, n_steps, sampling,
                              generator, rows(history), rows(hvalid), plen)
        return mesh.all_gather(ids.to(dev), "dp", dim=1).cpu()
    return loop


@torch.inference_mode()
def tp_generate(params, cfg: ModelConfig, mesh: Mesh, rows,
                sampling: Optional[SamplingParams] = None,
                max_new_tokens: int = 128, max_len: Optional[int] = None,
                seed: int = 0, stop_at_eos: bool = True,
                kv_dtype=torch.bfloat16, sharded: bool = False) -> list:
    """Ragged multi-prompt generation under a (dp, tp) mesh: one sharded
    padded prefill and one sharded decode loop, the TP analog of
    ``runtime.generate.batched_generate`` and the library entry behind
    ``run_tp`` and ``Model.generate(mesh=...)``. Every rank calls it with
    the same ``rows`` (lists of prompt ids) and returns every row's full id
    list. The batch is padded to a multiple of dp by repeating the last row
    (dropped from the output); each dp rank prefills and decodes its rows
    (:func:`make_tp_prefill`, :func:`make_tp_decode_loop`).

    ``sharded=False``: ``params`` is the whole model (a ``Transformer`` or
    its param dict) and each rank keeps its shards here; ``sharded=True``:
    ``params`` is already the rank's sharded decoder (``shard_model``)."""
    sampling = sampling or SamplingParams()
    model = params if sharded else shard_model(params, cfg, mesh)
    dev = model.device
    n_rows = len(rows)
    rows = list(rows) + [rows[-1]] * ((-n_rows) % mesh.dp)
    B = len(rows)
    lens = [len(r) for r in rows]
    Tmax = max(lens)
    S = max_len or min(cfg.max_seq_len, Tmax + max_new_tokens)
    if Tmax >= S:
        raise ValueError(f"prompt ({Tmax}) does not fit max_len {S}")
    max_new_tokens = min(max_new_tokens, S - Tmax)
    toks = torch.zeros((B, Tmax), dtype=torch.long)
    for b, r in enumerate(rows):
        toks[b, :len(r)] = torch.tensor(list(r), dtype=torch.long)
    tlens = torch.tensor(lens, dtype=torch.long, device=dev)
    cache = init_cache(cfg, mesh, B, S, kv_dtype)
    logits = make_tp_prefill(model)(toks, tlens, cache)
    gen = rank_generator(mesh, seed, dev)
    hist, valid = _history(rows, sampling.repeat_last_n, dev)
    tok0, _ = sample(logits, sampling, SamplerState.init(B, sampling, dev),
                     prev_tokens=hist, prev_valid=valid, generator=gen)
    # each row's first id is the draw of the dp rank that decodes it
    tok0 = mesh.all_gather(dp_rows(mesh, tok0), "dp", dim=0)
    new = tok0[:, None].cpu()
    if max_new_tokens > 1:
        if hist is not None:
            hist = torch.cat([hist[:, 1:], tok0[:, None].long()], dim=1)
            valid = torch.cat([valid[:, 1:], torch.ones_like(valid[:, :1])],
                              dim=1)
        # one sampled loop for greedy and sampled alike (greedy sampling is
        # the argmax), as the single-device batched_generate runs
        loop = make_tp_decode_loop(model, max_new_tokens - 1, sampling)
        rest = loop(tok0[:, None], tlens, cache, gen, hist, valid,
                    prompt_lens(cfg, lens, dev))
        new = torch.cat([new, rest.T], dim=1)
    outs = []
    for b in range(n_rows):
        ids = new[b, :min(max_new_tokens, S - lens[b])].tolist()
        if stop_at_eos:
            ids = truncate_at_eos(ids, cfg)
        outs.append(list(rows[b]) + ids)
    return outs
