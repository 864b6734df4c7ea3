"""Sequence (context) parallelism: ring attention over an "sp" mesh axis
(port of ``neural_tpu/parallel/sp.py``).

Each rank holds T/sp tokens of every sequence. Norms, projections and the
MLP act per token and need no communication; the attention runs as a ring:
the K/V blocks and their global positions pass one rank on around the sp
axis (``Mesh.ppermute``) while every rank accumulates online-softmax
statistics in f32 for its own queries. After sp hops each query has seen
the whole sequence. Causality comes from the global positions carried with
each block, so the hop order does not matter. The one-device oracle is the
cache-less forward (``models.transformer.attend_nocache``), whose
``masked_scores`` the ring shares.

Under autograd the ring differentiates as it runs: ``Mesh.ppermute``'s
backward sends the K/V cotangents back the reverse way.
"""
from __future__ import annotations

import torch

from ..models.config import ModelConfig
from ..ops.attention import attn_scale


def ring_attend(q: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor,
                positions: torch.Tensor, cfg: ModelConfig, mesh, slopes=None,
                window: int = 0) -> torch.Tensor:
    """Ring attention for one sequence shard (the JAX ``ring_attend``).

    q [B, Tl, Hq, Dh] this rank's queries; kt/vt [B, Hkv, Tl, Dh] its K/V
    block; ``positions`` [B, Tl] the global positions of its tokens;
    ``window`` the layer's sliding window (0: none). → [B, Tl, Hq·Dh] f32,
    equal (up to the order of f32 sums) to ``attend_nocache`` on the
    gathered sequence. A row whose keys in a block are all masked has its
    p zeroed through the mask, not through the exp (its running max is
    still -1e30 there, where exp(0) = 1)."""
    from ..models.transformer import masked_scores
    B, Tl, Hq, Dh = q.shape
    Hkv = kt.shape[1]
    G = Hq // Hkv
    sp = mesh.size("sp")
    qh = q.reshape(B, Tl, Hkv, G, Dh).permute(0, 2, 3, 1, 4) \
        .to(torch.float32) * attn_scale(cfg, Dh)
    q_pos = positions[:, :, None]
    m = torch.full((B, Hkv, G, Tl), -1e30, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, G, Tl, Dh), dtype=torch.float32,
                      device=q.device)
    perm = [(i, (i + 1) % sp) for i in range(sp)]
    kb, vb, pb = kt, vt, positions
    for hop in range(sp):
        s, mask = masked_scores(qh, kb, q_pos, pb[:, None, :], cfg, slopes,
                                window)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(mask[:, None, None], p, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgts,bhsd->bhgtd", p, vb.to(torch.float32))
        m = m_new
        if hop < sp - 1:          # the last hop's blocks would go unread
            kb, vb, pb = (mesh.ppermute(t, "sp", perm) for t in (kb, vb, pb))
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tl, Hq * Dh)


def sequence_sharded_forward(model, tokens: torch.Tensor,
                             logits_dtype: torch.dtype = torch.float32,
                             gather: bool = False) -> torch.Tensor:
    """The cache-less forward with the sequence sharded over "sp" (the JAX
    ``sequence_sharded_forward``). ``model``: this rank's decoder on a mesh
    with an "sp" axis (``parallel.sharding.shard_model``; tp may split it
    too); ``tokens`` [B, T], the same on every rank, T divisible by sp.
    The rank runs its shard, tokens ``index("sp")·T/sp`` on, through
    ``Transformer.forward(..., cache=None)``, whose attention rings over
    sp. → this rank's logits [B, T/sp, V], or with ``gather`` the whole
    [B, T, V] on every rank."""
    mesh = model.mesh
    sp = mesh.size("sp")
    B, T = tokens.shape
    if T % sp:
        raise ValueError(f"T={T} does not split over sp={sp}")
    Tl = T // sp
    r = mesh.index("sp")
    dev = model.device
    toks = tokens[:, r * Tl:(r + 1) * Tl].to(dev)
    start = torch.full((B,), r * Tl, dtype=torch.long, device=dev)
    logits = model(toks, start, None, logits_dtype)
    return mesh.all_gather(logits, "sp", dim=1) if gather else logits


__all__ = ["ring_attend", "sequence_sharded_forward"]
