"""Pipeline parallelism: the GPipe microbatch schedule over a "pp" mesh axis,
and the training step (port of ``neural_tpu/parallel/pp.py``).

The layers split over pp in contiguous runs: stage s holds ``layers[s·L/pp
:(s+1)·L/pp]`` (the JAX package shards its stacked [L, ...] leaves on the
leading axis; the port's layers are a list). Each tick every stage runs its
layers on the activation received from its predecessor and passes the
result on (``Mesh.ppermute``); M microbatches drain in M + pp - 1 ticks,
and the last stage's outputs reach every stage through one sum over pp.
Under the same mesh, dp splits the batch and tp splits each layer (the
split table, ``parallel.sharding``).

The step is functional, as the JAX one: ``step(params, tokens) -> (loss,
new_params)``, with this rank's shards in and out. Autograd differentiates
the graph of plain torch ops: the cache-less forward
(``models.transformer.attend_nocache``), the unquantized products, the
norms' torch chains. No kernel of the port runs there (none has a
backward), nor does any Pallas kernel in the JAX package's training path,
which is XLA throughout; so params must be DENSE (unquantized): a QTensor
raises ``ValueError``.

Gradients follow the JAX rule under ``check_vma=False``: every collective's
backward is its transpose (``parallel.collectives``), the loss is counted
once across the mesh (on the last stage's tp rank 0, over dp by 1/dp), and
a leaf replicated over an axis holds per-rank partials, which
:func:`fix_replicated_grads` sums over the axes its spec lacks. Every rank
records the same graph, so that each runs the backward's collectives in
the same order: stage-dependent choices are selections on tensors, not
branches.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch
from torch.utils._pytree import tree_leaves, tree_map

from ..core.qtensor import QTensor
from ..models.config import ModelConfig
from .sharding import Mesh, dp_rows, param_specs


def _map_specs(fn, specs):
    """``fn`` over every spec tuple of a spec tree (a QTensor's field dict
    and the experts' dict included); other leaves (None) kept."""
    return tree_map(lambda s: fn(s) if isinstance(s, tuple) else s, specs,
                    is_leaf=lambda x: isinstance(x, tuple))


def pp_param_specs(params, cfg: ModelConfig, tp: bool = True):
    """The split table's specs (``parallel.sharding.param_specs``) with the
    layer list over "pp": each layer leaf's spec starts with "pp", which
    names the list's split (the JAX ``P("pp", ...)`` on the stacked
    axis); ``tp=False`` drops every tp split."""
    specs = param_specs(params, cfg)
    specs["layers"] = [_map_specs(lambda s: ("pp",) + s, lp)
                       for lp in specs["layers"]]
    if not tp:
        specs = _map_specs(lambda s: tuple(None if a == "tp" else a
                                           for a in s), specs)
    return specs


def pp_shard_params(params, cfg: ModelConfig, mesh: Mesh, specs=None
                    ) -> Dict[str, Any]:
    """This rank's shards by :func:`pp_param_specs`: its stage's run of
    layers, each leaf split over tp where its spec says, the rest as
    ``parallel.sharding.shard_params`` splits them; contiguous copies on
    the mesh's device."""
    from .sharding import _param_dict, _to_device, shard_params
    params = _param_dict(params)
    specs = specs or pp_param_specs(params, cfg, mesh.tp > 1)
    L, S = len(params["layers"]), mesh.size("pp")
    if L % S:
        raise ValueError(f"{L} layers do not split over pp={S}")
    run = slice(mesh.index("pp") * L // S, (mesh.index("pp") + 1) * L // S)
    # the stage's layers, their specs without the list's "pp"
    stage = _map_specs(lambda t: t[1:], specs["layers"][run])
    return _to_device(shard_params(dict(params, layers=params["layers"][run]),
                                   cfg, mesh, dict(specs, layers=stage)),
                      mesh.device)


def _spec_axes(s) -> set:
    return {a for a in s if a is not None}


def fix_replicated_grads(grads, specs, mesh: Mesh):
    """Sum each gradient over the mesh axes its spec lacks (the JAX
    ``fix_replicated_grads``): a leaf replicated over an axis received
    per-rank partial cotangents, which add up to its gradient; a sharded
    leaf's arrived whole through the collectives' transposes."""
    def fix(g, s):
        if g is None:
            return None
        named = _spec_axes(s)
        missing = tuple(a for a in mesh.axis_names
                        if a not in named and mesh.size(a) > 1)
        return mesh.psum(g, missing) if missing else g
    return tree_map(fix, grads, specs)


def refuse_quantized(params, what: str):
    """Raise ``ValueError`` naming the first QTensor leaf: a train step takes
    dense (unquantized) params, as the JAX steps do; no kernel has a
    backward."""
    def walk(t, name):
        if isinstance(t, QTensor):
            raise ValueError(
                f"{what} takes DENSE (unquantized) params, as the JAX step "
                f"does: {name} is a QTensor ({t.cfg.short_name()}), and no "
                "kernel of the port has a backward")
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{name}.{k}" if name else k)
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, f"{name}[{i}]")
    walk(params, "")


def sgd_step(local, specs, mesh: Mesh, lr: float,
             loss_fn: Callable[[Dict[str, Any]], torch.Tensor]):
    """One SGD step on this rank's shards ``local`` (``specs`` their spec
    tree, the rank's layers only): every floating leaf
    becomes a leaf that requires grad, ``loss_fn(leaves)`` gives this
    rank's share of the loss (its part of a sum over the mesh that counts
    the loss once), autograd takes the gradients (every rank runs the same
    backward, collectives included), :func:`fix_replicated_grads` sums the
    replicated leaves', and each leaf moves by ``-lr`` times its gradient.
    → (the loss summed over the mesh, the new shards)."""
    def leaf(t):
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            # an inference-mode tensor (``init_random``'s) cannot require
            # grad: its first step takes a copy
            t = t.clone() if t.is_inference() else t.detach()
            return t.requires_grad_(True)
        return t
    leaves = tree_map(leaf, local)
    with torch.enable_grad():
        part = loss_fn(leaves)
        flat = [t for t in tree_leaves(leaves)
                if isinstance(t, torch.Tensor) and t.requires_grad]
        got = torch.autograd.grad(part, flat, allow_unused=True)
    by_id = {id(t): g if g is not None else torch.zeros_like(t)
             for t, g in zip(flat, got)}
    grads = tree_map(lambda t: by_id.get(id(t)), leaves)
    grads = fix_replicated_grads(grads, specs, mesh)
    with torch.no_grad():
        # w - lr·g, written into the gradient's own memory (each is a
        # tensor of its own), so a step holds the params and one more copy
        new = tree_map(lambda t, g: t if g is None
                   else g.mul_(-lr).add_(t.detach()), leaves, grads)
    loss = mesh.psum(part.detach().clone(), mesh.axis_names)
    return loss, new


def pipeline_apply(blocks, x_mb: torch.Tensor, positions: torch.Tensor,
                   rope, slopes, mesh: Mesh, prompt_len=None) -> torch.Tensor:
    """The microbatch pipeline on this rank (the JAX ``pipeline_apply``).

    ``blocks``: this stage's layers (``models.transformer.Block``); x_mb
    [M, mb, T, D] the microbatched activations (stage 0 reads them);
    ``positions`` [mb, T] and ``rope`` one microbatch's. Each of the M +
    pp - 1 ticks runs the stage's blocks on stage 0's next microbatch or on
    what the predecessor sent (a selection on a tensor, so every stage
    records the same graph), then sends the result on. → [M, mb, T, D],
    the last stage's outputs, on every stage (a sum over pp)."""
    S, M = mesh.size("pp"), x_mb.shape[0]
    stage = mesh.index("pp")
    first = torch.tensor(stage == 0, device=x_mb.device)
    recv = torch.zeros_like(x_mb[0])
    fwd = [(i, i + 1) for i in range(S - 1)]
    outs = []
    for t in range(M + S - 1):
        y = torch.where(first, x_mb[min(t, M - 1)], recv)
        for blk in blocks:
            y = blk(y, None, positions, rope, slopes, prompt_len)
        if t >= S - 1:
            outs.append(y)
        if S > 1 and t < M + S - 2:
            recv = mesh.ppermute(y, "pp", fwd)
    last = 1.0 if stage == S - 1 else 0.0
    return mesh.psum(torch.stack(outs) * last, "pp")


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
    """The mean next-token negative log-likelihood, in f32."""
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -lp.gather(-1, targets.long()[..., None]).mean()


def make_pp_train_step(params, cfg: ModelConfig, mesh: Mesh,
                       n_microbatches: int, lr: float = 1e-3):
    """A dp × pp × tp training step: cross-entropy, SGD at ``lr`` (the JAX
    ``make_pp_train_step``).

    ``params``: the whole DENSE param dict (or a Transformer's), read for
    its specs; a QTensor raises ``ValueError``. → ``step(local, tokens) ->
    (loss, new_local)``, with ``local`` this rank's shards
    (:func:`pp_shard_params`) and ``tokens`` [B, T+1] the global batch,
    the same on every rank, B divisible by dp · ``n_microbatches``. The
    loss is the mean over the batch, on every rank.

    Where the port's step differs from the JAX one, it follows the port's
    own forward: the final softcap (Gemma-2) and Bloom's embedding norm
    apply, and the lm_head's bias joins after the vocabulary gather."""
    from ..models.transformer import Transformer
    from .sharding import _param_dict
    params = _param_dict(params)
    refuse_quantized(params, "make_pp_train_step")
    S = mesh.size("pp")
    if cfg.n_layers % S:
        raise ValueError(f"{cfg.n_layers} layers do not split over pp={S}")
    specs = pp_param_specs(params, cfg, tp=mesh.tp > 1)
    per, s = cfg.n_layers // S, mesh.index("pp")
    local_specs = dict(specs, layers=specs["layers"][s * per:(s + 1) * per])
    M = n_microbatches
    # the loss counts once across the mesh: the last stage's tp rank 0,
    # each dp rank its rows' mean over dp
    mine = mesh.index("pp") == S - 1 and mesh.index("tp") == 0
    share = 1.0 / mesh.dp if mine else 0.0

    def loss_fn(local, toks):
        model = Transformer(cfg, local, mesh)
        B, T1 = toks.shape
        T = T1 - 1
        if B % M:
            raise ValueError(f"{B} rows a dp rank do not split into {M} "
                             "microbatches")
        positions = torch.arange(T, device=toks.device)[None].expand(B, T)
        x = model.embed_tokens(toks[:, :-1], positions)
        mb = B // M
        pos_mb = positions[:mb]
        plen = torch.full((mb,), T, dtype=torch.long, device=toks.device) \
            if cfg.prefix_lm or cfg.rope_style == "glm1" else None
        y = pipeline_apply(model.layers, x.reshape(M, mb, T, -1), pos_mb,
                           model.rope_tables(pos_mb, plen),
                           model.alibi_slopes, mesh, plen)
        logits = model.head(y.reshape(B, T, -1))
        return cross_entropy(logits, toks[:, 1:]) * share

    def step(local, tokens):
        toks = dp_rows(mesh, tokens.to(mesh.device))
        return sgd_step(local, local_specs, mesh, lr,
                        lambda p: loss_fn(p, toks))
    return step


__all__ = ["pp_param_specs", "pp_shard_params", "fix_replicated_grads",
           "pipeline_apply", "make_pp_train_step", "sgd_step",
           "cross_entropy", "refuse_quantized"]
