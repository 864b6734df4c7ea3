"""Process-group bootstrap and the mesh laid over it (port of
``neural_tpu/parallel/multihost.py``).

One process per rank, SPMD, as ``torchrun`` launches them: every rank calls
the same entry point on the same prompts. The JAX package bootstraps with
``jax.distributed``; here ``torch.distributed.init_process_group`` does,
with a ``timeout`` on the rendezvous and on every collective, so a rank
that dies makes the others raise instead of hang.

    from neural_tpu_torch.parallel import init_distributed, auto_mesh
    init_distributed()                      # under torchrun: env://
    mesh = auto_mesh(tp=8)                  # tp within a host, dp across

The backend is the caller's choice: ``gloo`` on the CPU, and for several
ranks sharing one card; ``nccl`` on a host with a card per rank.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

#: seconds a rendezvous or a collective may wait before it raises
DEFAULT_TIMEOUT = 60.0


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     timeout: float = DEFAULT_TIMEOUT):
    """Join the process group. With no arguments, ``torchrun``'s
    environment (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``)
    says where and who; explicit arguments bring a group up by hand
    (``coordinator`` "host:port" of rank 0, the world size and this rank),
    the ``mpirun`` analog. ``backend``: "gloo" or "nccl"; by default
    "nccl" where a card is present, else "gloo". Under NCCL each rank takes
    the card of its local rank (``LOCAL_RANK``, else its rank modulo the
    host's cards). ``timeout`` bounds the rendezvous and every collective."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = dict(backend=backend,
              timeout=datetime.timedelta(seconds=float(timeout)))
    if coordinator is not None:
        kw.update(init_method=f"tcp://{coordinator}",
                  world_size=int(num_processes), rank=int(process_id))
    else:
        kw["init_method"] = "env://"
        if num_processes is not None:
            kw["world_size"] = int(num_processes)
        if process_id is not None:
            kw["rank"] = int(process_id)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", kw.get(
            "rank", os.environ.get("RANK", 0))))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(**kw)


def world() -> int:
    """Ranks in the process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def local_world() -> int:
    """Ranks on this host: ``torchrun``'s ``LOCAL_WORLD_SIZE``, else the
    whole world (one host)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world()))


def auto_mesh(tp: Optional[int] = None, dp: Optional[int] = None,
              device=None):
    """The world as a ("dp", "tp") mesh with tp over the ranks of one host
    (consecutive ranks, as ``torchrun`` numbers a host's processes) and dp
    across hosts: the layout that keeps the per-layer sums off the slow
    network. tp defaults to the host's ranks, dp to the rest."""
    from .sharding import make_mesh
    n = world()
    if tp is None:
        tp = min(local_world(), n)
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp {dp} x tp {tp} != world size {n}")
    return make_mesh(dp=dp, tp=tp, device=device)


def is_primary() -> bool:
    """Rank 0, or no process group (the reference's ``is_master``)."""
    return rank() == 0


def checksum(tree) -> int:
    """An exact integer digest of every tensor of a param tree (dicts,
    lists, QTensors; a module's ``param_dict()``): each tensor's bytes,
    each weighted by its position modulo 251, summed in int64 on the
    tensor's device. Ranks that loaded the same weights give the same
    number."""
    from ..core.qtensor import QTensor
    total = 0
    stack = [tree]
    while stack:
        t = stack.pop()
        if isinstance(t, QTensor):
            stack.extend([*t.planes, t.scales, t.zeros, t.perm])
        elif isinstance(t, dict):
            stack.extend(t[k] for k in sorted(t))
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
        elif isinstance(t, torch.Tensor):
            b = t.detach().contiguous().reshape(-1).view(torch.uint8)
            for off in range(0, b.numel(), _CHUNK):
                seg = b[off:off + _CHUNK].to(torch.int64)
                w = torch.arange(off, off + seg.numel(),
                                 device=b.device) % 251 + 1
                total += int((seg * w).sum())
    return total


# bytes a checksum widens to int64 at once
_CHUNK = 1 << 24


def agree(value: int, what: str = "value", group=None):
    """Raise unless every rank of ``group`` (the world by default) holds the
    same integer ``value``: its min and max over the ranks must meet."""
    if not dist.is_initialized():
        return
    dev = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    lo = torch.tensor([value], dtype=torch.int64, device=dev)
    hi = lo.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    if int(lo) != int(hi):
        raise RuntimeError(f"ranks disagree on {what}: {int(lo)} .. "
                           f"{int(hi)}")
