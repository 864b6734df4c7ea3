"""Expert parallelism: the ``[E, ...]`` expert stacks split over an "ep"
mesh axis (port of ``neural_tpu/parallel/ep.py``).

Each rank holds E/ep experts. A MoE layer routes its tokens with a
fixed-capacity dispatch and exchanges them with two all-to-alls (dispatch
and combine), the Switch/GShard pattern of the JAX ``ep_moe``, static
shapes throughout. Assignments past an expert's capacity are dropped;
``capacity_factor`` >= E/k keeps every one, and the layer then equals the
dense mixture. The router stays replicated; inside an expert the MLP may
also be split over tp (gate/up by columns, down by rows), with one sum over
tp of the experts' f32 outputs before the combine.

The local experts' products go through ``models.transformer.linear``, so
a quantized expert's capacity buffer reaches K1 (at most 16 rows), K5 or
K2 (256 rows and more) by its rows, as a dense product would; unquantized
experts take one ``torch.mm`` an expert with bf16 operands and f32 results,
the JAX ``einsum(..., preferred_element_type=f32)``.
"""
from __future__ import annotations

import math

import torch

from ..models.config import ModelConfig


def ep_param_specs(params, cfg: ModelConfig, tp: bool = True):
    """:func:`~neural_tpu_torch.parallel.sharding.param_specs` with every
    expert leaf's leading E dim split over "ep" (the router and the other
    leaves as they were); ``tp=False`` drops every tp split."""
    from .sharding import param_specs
    specs = param_specs(params, cfg)

    def epify(s):
        if isinstance(s, dict):            # a QTensor's fields
            return {k: epify(v) for k, v in s.items()}
        return ("ep",) + tuple(s[1:])

    def untp(s):
        if isinstance(s, dict):
            return {k: untp(v) for k, v in s.items()}
        if isinstance(s, list):
            return [untp(v) for v in s]
        return tuple(None if a == "tp" else a for a in s)

    for lp in specs["layers"]:
        if "experts" in lp:
            lp["experts"] = {k: epify(v) for k, v in lp["experts"].items()}
    return specs if tp else untp(specs)


def expert_capacity(n_tokens: int, n_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Rows of each expert's buffer: ceil(tokens·k/E·factor), at least 8
    and a multiple of 8 (the JAX package's sublane alignment)."""
    c = math.ceil(n_tokens * top_k / n_experts * capacity_factor)
    return max(8, -(-c // 8) * 8)


def _local_experts(recv: torch.Tensor, block, cfg: ModelConfig,
                   tp: int) -> torch.Tensor:
    """Every local expert's MLP on its received rows ``recv`` [E_loc, R,
    D] → f32 [E_loc, R, D]; w_down's bias only where nothing is summed
    after (tp = 1). A quantized expert is the JAX ``_mlp`` with
    n_experts=0 (``Experts.mlp``: its products in the activation dtype);
    an unquantized one the JAX ``einsum`` path, bf16 operands and f32
    products (``_rdot``), the activation in f32."""
    from ..models.transformer import _rdot
    ex, act = block.experts, block.act
    outs = []
    for e in range(recv.shape[0]):
        h = recv[e]
        if ex.quantized:
            outs.append(ex.mlp(e, h, cfg, act, down_bias=tp == 1)
                        .to(torch.float32))
            continue

        def edot(t, name, bias=True):
            y = _rdot(t, ex.weight(name, e))
            b = getattr(ex, "b" + name[1:])
            return y if b is None or not bias else y + b[e].to(torch.float32)
        g = act(edot(h, "w_gate")) * edot(h, "w_up") if cfg.mlp_gated \
            else act(edot(h, "w_up"))
        outs.append(edot(g.to(torch.bfloat16), "w_down", bias=tp == 1))
    return torch.stack(outs)


def ep_moe(x: torch.Tensor, block, cfg: ModelConfig, mesh,
           capacity_factor: float = 2.0) -> torch.Tensor:
    """The expert-parallel MoE MLP of one rank: x [B, T, D] (this rank's
    tokens, or replicated ones), ``block`` the layer
    (:class:`~neural_tpu_torch.models.transformer.Block`: its replicated
    ``router`` and its ``experts``, this rank's E/ep local stacks). Returns
    [B, T, D] in x's dtype.

    The router's top-k (``moe_route``); each assignment's slot in its
    expert's buffer of C rows (:func:`expert_capacity`), in token order;
    dispatch [E, C, D] → all-to-all over ep → [E/ep, ep·C, D]; the local
    experts; a sum over tp (plus w_down's bias); all-to-all back → [E, C,
    D]; each kept assignment's row times its router weight, added into its
    token's f32 row (dropped ones add nothing)."""
    from ..models.transformer import moe_route
    B, T, D = x.shape
    S, k, E = B * T, cfg.n_experts_active, cfg.n_experts
    ep = mesh.ep
    E_loc = E // ep
    C = expert_capacity(S, E, k, capacity_factor)
    dev = x.device

    logits = block.router(x).to(torch.float32)              # [B, T, E]
    top_w, top_idx = moe_route(logits, k, cfg.moe_norm_topk)
    xf = x.reshape(S, D)
    eid = top_idx.reshape(S * k)
    w = top_w.reshape(S * k).to(torch.float32)
    tok = torch.arange(S * k, device=dev) // k
    # the position of each assignment within its expert's buffer
    oh = (eid[:, None] == torch.arange(E, device=dev)[None, :]).long()
    pos = ((torch.cumsum(oh, 0) - 1) * oh).sum(1)            # [S·k]
    keep = pos < C
    slot = torch.where(keep, pos, torch.full_like(pos, C))  # C: the drop row
    disp = torch.zeros((E, C + 1, D), dtype=x.dtype, device=dev)
    disp[eid, slot] = xf[tok]
    # dispatch: expert e's buffer to its owner, rank e // E_loc; receive,
    # for the local experts, the buffers every rank built, by source rank
    recv = mesh.all_to_all(disp[:, :C].reshape(ep, E_loc, C, D), "ep")
    recv = recv.transpose(0, 1).reshape(E_loc, ep * C, D)
    out_e = _local_experts(recv, block, cfg, mesh.tp)       # f32
    if mesh.tp > 1:
        out_e = mesh.psum(out_e, "tp")
        bd = block.experts.b_down
        if bd is not None:
            out_e = out_e + bd.to(torch.float32)[:, None, :]
    # combine: each source rank's rows back to it, in global expert order
    back = mesh.all_to_all(out_e.reshape(E_loc, ep, C, D).transpose(0, 1),
                           "ep").reshape(E * C, D)
    y = back[eid * C + torch.clamp(pos, max=C - 1)]
    y = y * (w * keep.to(torch.float32))[:, None]
    out = torch.zeros((S, D), dtype=torch.float32, device=dev)
    out.index_add_(0, tok, y)
    return out.reshape(B, T, D).to(x.dtype)
