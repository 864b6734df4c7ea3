"""The multi-rank dry run, and the SP × EP mixture-of-experts training step
(port of ``__graft_entry__.py``'s ``dryrun_multichip``, whose MoE step the
JAX package has only there: ``moe_loss``, ``moe_train``, ``moe_wrap``).

One real execution of every parallel axis on tiny shapes, over the process
group's ranks (one process a rank; every rank calls it):

1. inference at dp × tp: q4_0 weights, a prompt step and one more;
   1b. the sampled TP decode loop, 4 steps;
2. the dp × pp × tp pipeline training step (``parallel.pp``);
3. the sp × ep MoE training step: ring attention over sequence shards and
   the experts' all-to-all dispatch, cross-entropy, SGD;
4. quantized-MoE inference under ep: q4_0 experts, the local experts'
   products through the kernels' routes.

    python -m neural_tpu_torch.parallel.run_tp --dryrun \\
        --coordinator 127.0.0.1:8476 --num-processes 8 --process-id i \\
        --backend gloo --device cpu
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from ..models.config import ModelConfig
from .ep import ep_param_specs
from .pp import cross_entropy, refuse_quantized, sgd_step
from .sharding import Mesh, make_mesh, shard_params


def make_moe_train_step(params, cfg: ModelConfig, mesh: Mesh,
                        lr: float = 1e-3, capacity_factor: float = 2.0):
    """The sp × ep training step of the JAX dry run (``moe_wrap``): the
    cache-less forward with the sequence over "sp" (ring attention) and the
    experts over "ep" (``parallel.ep.ep_moe`` with ``capacity_factor``),
    cross-entropy counted once (each sp rank's shard, over sp by 1/sp, on
    ep rank 0), SGD at ``lr``.

    ``params``: the whole DENSE param dict (or a Transformer's); a QTensor
    raises ``ValueError``. → ``step(local, tokens) -> (loss, new_local)``:
    ``local`` this rank's shards (``shard_params`` by
    ``ep_param_specs(params, cfg, tp=False)``), ``tokens`` [B, T+1] the
    same on every rank, T divisible by sp; each sp rank reads its T/sp
    positions plus one more column, its last target.

    At ep = 1 the port's layer runs the one-device mixture, which drops
    nothing; the JAX step calls ``ep_moe`` on its size-1 ep axis, whose
    buffers of ``capacity_factor`` can drop assignments."""
    from ..models.transformer import Transformer
    from .sharding import _param_dict
    params = _param_dict(params)
    refuse_quantized(params, "make_moe_train_step")
    specs = ep_param_specs(params, cfg, tp=False)
    sp = mesh.size("sp")
    share = 1.0 / sp if mesh.index("ep") == 0 else 0.0

    def loss_fn(local, toks):
        model = Transformer(cfg, local, mesh, capacity_factor)
        B, T1 = toks.shape
        T = T1 - 1
        if T % sp:
            raise ValueError(f"T={T} does not split over sp={sp}")
        Tl, r = T // sp, mesh.index("sp")
        my = toks[:, r * Tl:r * Tl + Tl + 1]
        start = torch.full((B,), r * Tl, dtype=torch.long, device=toks.device)
        logits = model(my[:, :-1], start, None)
        return cross_entropy(logits, my[:, 1:]) * share

    def step(local, tokens):
        toks = tokens.to(mesh.device)
        return sgd_step(local, specs, mesh, lr, lambda p: loss_fn(p, toks))
    return step


def _finite(t: torch.Tensor, what: str):
    if not bool(torch.isfinite(t).all()):
        raise AssertionError(f"dryrun_multichip: {what} is not finite")


def dryrun_multichip(n_devices: int = None, device=None,
                     seed: int = 0) -> Dict[str, Any]:
    """One real execution of every parallel axis over the first
    ``n_devices`` ranks of the process group (all of them by default);
    every rank of the group calls it (a rank outside a part's mesh waits
    for it). Raises when a result is not finite; → what this rank saw
    (each part's mesh shape, the losses), and on rank 0 prints the JAX
    dry run's summary line. ``device``: the ranks' device ("cpu" for the
    plain path; the card by default)."""
    from ..convert.hf import init_random
    from ..runtime.kvcache import init_cache as single_cache
    from ..runtime.sampling import SamplingParams
    from .multihost import rank, world
    from .sharding import init_cache, shard_model
    from .pp import make_pp_train_step, pp_shard_params
    from .tp import make_tp_decode_loop, make_tp_step, rank_generator

    n = world() if n_devices is None else int(n_devices)
    out: Dict[str, Any] = {}
    ranks = list(range(n))

    # ---- 1. inference: q4_0 weights, tp-split, dp batches ----------------
    dp = 2 if n % 2 == 0 and n > 1 else 1
    tp = n // dp
    mesh = make_mesh(dp=dp, tp=tp, device=device, ranks=ranks)
    cfg = ModelConfig(arch="llama", vocab_size=512, hidden_size=64 * tp,
                      n_layers=2, n_heads=2 * tp, n_kv_heads=tp, head_dim=32,
                      intermediate_size=128 * tp, max_seq_len=64)
    B, T, S = dp * 2, 8, 32
    tokens = torch.arange(T).repeat(B, 1)
    if mesh is not None:
        dev = mesh.device
        whole = init_random(cfg, seed, quant="q4_0", device=dev)
        sm = shard_model(whole, cfg, mesh)
        del whole
        step = make_tp_step(sm)
        cache = init_cache(cfg, mesh, B, S)
        logits = step(tokens, torch.zeros(B, dtype=torch.long), cache)
        _finite(logits, "the inference step's logits")
        nxt = logits[:, -1].argmax(-1)[:, None]
        logits2 = step(nxt, torch.full((B,), T), cache)
        _finite(logits2, "the second step's logits")
        # ---- 1b. the sampled TP decode loop ------------------------------
        dcache = init_cache(cfg, mesh, B, S)
        loop = make_tp_decode_loop(sm, 4, SamplingParams(
            temperature=0.8, repeat_last_n=4))
        hist = tokens[:, -4:]
        ids = loop(nxt, torch.full((B,), T), dcache,
                   rank_generator(mesh, 0, dev), hist,
                   torch.ones(hist.shape, dtype=torch.bool))
        ids = torch.as_tensor(ids)
        if tuple(ids.shape) != (4, B) or int(ids.min()) < 0 \
                or int(ids.max()) >= cfg.vocab_size:
            raise AssertionError(f"dryrun_multichip: the decode loop's ids "
                                 f"{tuple(ids.shape)}: {ids.tolist()}")
        out["inference"] = dict(mesh.shape)
        del sm, cache, dcache

    # ---- 2. training: dp x pp x tp pipeline step --------------------------
    if n >= 8:
        dp3, pp3, tp3 = 2, 2, n // 4
    elif n == 4:
        dp3, pp3, tp3 = 1, 2, 2
    elif n == 2:
        dp3, pp3, tp3 = 1, 2, 1
    else:
        dp3 = pp3 = tp3 = 1
    mesh3 = make_mesh(dp=dp3, pp=pp3, tp=tp3, device=device,
                      ranks=ranks[:dp3 * pp3 * tp3])
    cfg3 = ModelConfig(arch="llama", vocab_size=512, hidden_size=64 * tp3,
                       n_layers=2 * pp3, n_heads=2 * tp3,
                       n_kv_heads=max(tp3, 2), head_dim=32,
                       intermediate_size=128 * tp3, max_seq_len=64)
    Bt = max(2, dp3 * 2)
    toks2 = torch.from_numpy(np.random.default_rng(0).integers(
        0, 512, (Bt, T + 1)).astype(np.int64))
    if mesh3 is not None:
        params = init_random(cfg3, seed, dtype=torch.float32,
                             device=mesh3.device).param_dict()
        pp_step = make_pp_train_step(params, cfg3, mesh3, n_microbatches=2)
        loss, _ = pp_step(pp_shard_params(params, cfg3, mesh3), toks2)
        _finite(loss, "the pipeline step's loss")
        out["pp_loss"] = float(loss)
        out["pp"] = dict(mesh3.shape)
        del params

    # ---- 3. MoE training: sp x ep (ring attention + expert routing) ------
    sp = 2 if n >= 2 else 1
    ep = max(1, min(4, n // sp))
    mesh2 = make_mesh(dp=1, sp=sp, ep=ep, tp=1, device=device,
                      ranks=ranks[:sp * ep])
    cfg2 = ModelConfig(arch="mixtral", vocab_size=512, hidden_size=64,
                       n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
                       intermediate_size=128, max_seq_len=64,
                       n_experts=2 * ep, n_experts_active=2)
    Tm = 8 * sp
    mtoks = torch.from_numpy(np.random.default_rng(1).integers(
        0, 512, (2, Tm + 1)).astype(np.int64))
    if mesh2 is not None:
        mparams = init_random(cfg2, seed, dtype=torch.float32,
                              device=mesh2.device).param_dict()
        local = shard_params(mparams, cfg2, mesh2,
                             ep_param_specs(mparams, cfg2, tp=False))
        mloss, _ = make_moe_train_step(mparams, cfg2, mesh2)(local, mtoks)
        _finite(mloss, "the MoE step's loss")
        out["moe_loss"] = float(mloss)
        out["moe"] = dict(mesh2.shape)
        del mparams, local

    # ---- 4. quantized-MoE inference: int4 experts under EP ---------------
    ep4 = min(4, n)
    mesh4 = make_mesh(dp=1, ep=ep4, device=device, ranks=ranks[:ep4])
    cfg4 = ModelConfig(arch="mixtral", vocab_size=512, hidden_size=64,
                       n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
                       intermediate_size=128, max_seq_len=64,
                       n_experts=2 * ep4, n_experts_active=2)
    if mesh4 is not None:
        whole = init_random(cfg4, seed, quant="q4_0", device=mesh4.device)
        qm = shard_model(whole, cfg4, mesh4,
                         ep_param_specs(whole, cfg4, tp=False))
        del whole
        qtoks = torch.arange(8, device=mesh4.device)[None]
        with torch.inference_mode():
            qlogits = qm(qtoks, torch.zeros(1, dtype=torch.long,
                                            device=mesh4.device),
                         single_cache(cfg4, 1, 32, device=mesh4.device))
        _finite(qlogits, "the quantized MoE's logits")
        out["quantized_moe"] = dict(mesh4.shape)
    if rank() == 0:
        pl = out.get("pp_loss", math.nan)
        ml = out.get("moe_loss", math.nan)
        print(f"dryrun_multichip: inference(dp={dp},tp={tp}) + "
              f"tp-decode-loop(4 steps, sampled) ok; "
              f"pipeline train(dp={dp3},pp={pp3},tp={tp3}) loss={pl:.4f}; "
              f"moe train(sp={sp},ep={ep}) loss={ml:.4f}; "
              f"quantized-moe infer(ep={ep4}) ok", flush=True)
    return out


__all__ = ["make_moe_train_step", "dryrun_multichip"]
