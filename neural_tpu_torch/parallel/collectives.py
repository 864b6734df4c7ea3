"""The mesh's collectives under autograd: ``psum``, the tiled
``all_gather``, ``all_to_all`` and ``ppermute`` as ``torch.autograd.
Function``\\ s whose backward is the transpose JAX takes under
``shard_map(check_vma=False)``:

- psum → psum (every rank's cotangent summed: a replicated value's
  cotangents are per-rank partials);
- the tiled all_gather → psum, then this rank's slice (gloo has no
  reduce_scatter);
- all_to_all → all_to_all (the exchange is its own inverse: chunk j of
  rank r's cotangent goes back to rank j as its chunk r);
- ppermute → the reverse permutation.

``torch.distributed``'s own ``all_reduce``, ``all_gather`` and
``all_to_all_single`` write in place and autograd cannot differentiate
them. Each rank's backward runs the same collectives in the same order, as
every rank records the same graph (``parallel.pp`` keeps its stages'
graphs alike for that reason). Without a tensor that requires grad,
:class:`~neural_tpu_torch.parallel.sharding.Mesh` calls the in-place forms
itself, so that inference keeps its buffers and its counts.

``ppermute`` runs over ``isend``/``irecv`` pairs, all posted before any is
waited on, so a ring cannot deadlock. gloo's point-to-point operations read
and write host memory only, so under gloo a card's tensor is staged
through the host for them.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist


def psum_(x: torch.Tensor, group) -> torch.Tensor:
    """The in-place sum of ``x`` over ``group`` (x returned)."""
    dist.all_reduce(x, group=group)
    return x


def all_gather_(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    x = x.contiguous()
    outs = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(outs, x, group=group)
    return torch.cat(outs, dim=dim)


def all_to_all_(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def ppermute_(x: torch.Tensor, me: int, pairs: Sequence[Tuple[int, int]],
              host: bool) -> torch.Tensor:
    """``x`` sent along ``pairs`` of world ranks (src, dst): a rank that is
    some pair's dst gets its src's x, any other rank zeros. ``host``:
    stage a card's tensor through the host (gloo)."""
    x = x.contiguous()
    out = torch.zeros_like(x)
    send = x.cpu() if host and x.is_cuda else x
    recv = torch.zeros_like(send) if host and x.is_cuda else out
    ops, got = [], False
    for src, dst in pairs:
        if src == me:
            ops.append(dist.isend(send, dst))
        if dst == me:
            ops.append(dist.irecv(recv, src))
            got = True
    for op in ops:
        op.wait()
    if got and recv is not out:
        out.copy_(recv)
    return out


class PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return psum_(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        return psum_(g.clone(memory_format=torch.contiguous_format),
                     ctx.group), None


class AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, index, dim):
        ctx.group, ctx.index, ctx.dim = group, index, dim
        ctx.size = x.shape[dim]
        return all_gather_(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        g = psum_(g.contiguous().clone(), ctx.group)
        return (g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size)
                .contiguous(), None, None, None, None)


class AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all_(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_(g, ctx.group), None


class PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, me, pairs, host):
        ctx.me, ctx.pairs, ctx.host = me, pairs, host
        return ppermute_(x, me, pairs, host)

    @staticmethod
    def backward(ctx, g):
        back = tuple((dst, src) for src, dst in ctx.pairs)
        return ppermute_(g, ctx.me, back, ctx.host), None, None, None
