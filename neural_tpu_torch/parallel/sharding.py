"""The mesh and the per-tensor split table (port of
``neural_tpu/parallel/sharding.py``).

The JAX package is single-controller: one program ``shard_map``\\ s the
model over a named device ``Mesh`` and XLA slices every array by its
PartitionSpec. Here each rank is a process (SPMD), and :class:`Mesh` is
the small object a rank holds: the world's shape over named axes ("dp",
then "ep"/... in the order given, "tp" last, so consecutive ranks share a
tp group), this rank's coordinates, and a ``torch.distributed`` subgroup
per axis, made with ``dist.new_group``. Its collectives are the identity
on an axis of size 1, so ``make_mesh(dp=1, tp=1)`` works in one process
without a process group.

The split table is the JAX one (:data:`_LAYER_SPLITS`): "col" splits N (no
communication), "row" splits K (a sum after the product), "col_b" splits a
bias along N, "rep" keeps the whole. A spec is a tuple with one mesh axis
(or None) per dimension, read from the left, as a PartitionSpec is;
:func:`shard_params` gives each rank a contiguous copy of its slice of
every leaf, so that the full weights can be freed: every rank loads the
whole checkpoint and keeps its shards, as ``tp_generate(sharded=False)``
does in the JAX package.

A QTensor splits in its own fields, whatever its layout (the JAX storage
layout or the port's at-rest one: native-pack nibbles, int8 code planes,
fp8, nf4/fp4 bit planes): a "col" split takes N columns of the planes,
scales and zero-points; a "row" split takes packed-K rows of the planes and
the matching scale-group rows. Every layout packs K in runs that never
cross a scale group (the bit planes chunk-locally by the group, native-pack
two or four codes a byte), so a K split on a group boundary is exact in
every layout, and splitting then converting to the at-rest layout equals
converting then splitting.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from ..core.device import resolve_device
from ..core.qtensor import QTensor
from ..models.config import ModelConfig
from ..runtime.kvcache import KVCache
from ..runtime.kvcache import init_cache as _init_cache
from . import collectives as C
from . import multihost

class Mesh:
    """This rank's view of a named mesh of ranks: ``shape`` (axis → size,
    mesh-major, the last axis varying fastest), ``coords`` (axis → this
    rank's index), ``groups`` (axis → the subgroup of the ranks that differ
    from this one along that axis only; None where the axis has size 1),
    the ``backend``, the ``device`` the rank's tensors live on, and
    ``ranks``, the process group's ranks in mesh order (``rank`` is this
    rank's place among them).

    Its collectives are differentiable: given a tensor that requires grad
    under autograd they run as the ``parallel.collectives`` Functions,
    whose backward is the JAX transpose; otherwise in place, as
    inference takes them."""

    def __init__(self, shape: Dict[str, int], rank: int, groups,
                 backend: Optional[str], device: torch.device, ranks=None):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.rank = rank
        idx = np.unravel_index(rank, tuple(shape.values())) if shape else ()
        self.coords = {a: int(i) for a, i in zip(self.axis_names, idx)}
        self.groups = groups
        self.backend = backend
        self.device = device
        n = int(np.prod(list(shape.values()))) if shape else 1
        self.ranks = tuple(range(n)) if ranks is None else tuple(ranks)

    def __repr__(self):
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords})"

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    @property
    def tp(self) -> int:
        return self.size("tp")

    @property
    def dp(self) -> int:
        return self.size("dp")

    @property
    def ep(self) -> int:
        return self.size("ep")

    @property
    def collective_free_step(self) -> bool:
        """No collective inside a model step (tp = ep = 1): a step can be
        captured in a CUDA graph as on one device. Under tp or ep > 1 the
        step runs eagerly: a gloo collective cannot be captured (and no
        NCCL capture path is written yet)."""
        return self.tp == 1 and self.ep == 1

    def world_rank(self, **coords) -> int:
        """The process group's rank at this rank's coordinates with
        ``coords`` (axis → index) changed."""
        at = dict(self.coords, **coords)
        i = np.ravel_multi_index(tuple(at[a] for a in self.axis_names),
                                 tuple(self.shape.values())) \
            if self.shape else 0
        return self.ranks[int(i)]

    def psum(self, x: torch.Tensor, axis="tp") -> torch.Tensor:
        """The sum of ``x`` over ``axis`` (or over each of a tuple of axes,
        one after the other), in x's dtype. In place, into x (a tensor of
        its own), unless autograd records x: then a new tensor, and the
        backward sums the cotangents over the same axes."""
        for a in (axis,) if isinstance(axis, str) else axis:
            g = self.groups.get(a)
            if g is None:
                continue
            _count(f"{a}_all_reduce")
            x = C.PSum.apply(x, g) if _grad(x) else C.psum_(x, g)
        return x

    def all_gather(self, x: torch.Tensor, axis: str = "tp",
                   dim: int = -1) -> torch.Tensor:
        """Every rank's ``x`` along ``axis``, concatenated along ``dim`` in
        rank order (the JAX ``all_gather(..., tiled=True)``; its backward
        sums the cotangent over the axis and keeps this rank's slice)."""
        g = self.groups.get(axis)
        if g is None:
            return x
        _count(f"{axis}_all_gather")
        dim = dim % x.ndim
        if _grad(x):
            return C.AllGather.apply(x, g, self.size(axis), self.index(axis),
                                     dim)
        return C.all_gather_(x, g, self.size(axis), dim)

    def all_to_all(self, x: torch.Tensor, axis: str = "ep") -> torch.Tensor:
        """``x`` [n, ...] (n the axis size): chunk j goes to the axis's rank
        j; returns [n, ...] with chunk i from rank i."""
        g = self.groups.get(axis)
        if g is None:
            return x
        _count(f"{axis}_all_to_all")
        return C.AllToAll.apply(x, g) if _grad(x) else C.all_to_all_(x, g)

    def ppermute(self, x: torch.Tensor, axis: str, perm) -> torch.Tensor:
        """The JAX ``ppermute`` over ``axis``: ``perm`` lists (source,
        destination) indices along the axis; a rank that is a destination
        gets its source's ``x``, any other zeros. Over ``isend``/``irecv``
        (every one posted before any is waited on); under gloo a card's
        tensor goes through the host. Its backward sends the cotangents
        the reverse way."""
        if self.size(axis) == 1:
            return x if any(s == d for s, d in perm) else torch.zeros_like(x)
        _count(f"{axis}_ppermute")
        pairs = tuple((self.world_rank(**{axis: s}),
                       self.world_rank(**{axis: d})) for s, d in perm)
        me = self.ranks[self.rank]
        host = self.backend == "gloo"
        if _grad(x):
            return C.PPermute.apply(x, me, pairs, host)
        return C.ppermute_(x, me, pairs, host)


def _count(name: str):
    from ..ops import _cuda
    _cuda.ROUTES.count(name)


def _grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def make_mesh(dp: int = 1, tp: int = 1, device=None, ranks=None,
              **axes) -> Optional[Mesh]:
    """The mesh over the process group's ranks (one process without a
    group: every axis of size 1). Axes ("dp", then ``axes`` by keyword in
    mesh-major order, "tp" last), as the JAX ``make_mesh``: rank r sits at
    the row-major coordinates of r, so tp, the chattiest axis, joins
    consecutive ranks. Every rank must call this with the same shape: each
    subgroup is made by all ranks in one order. ``device``: where this
    rank's tensors live (the card unless "cpu"; under NCCL the current
    card). ``ranks``: the process group's ranks the mesh is laid over, in
    mesh order (the JAX ``make_mesh(devices=devices[:n])``), all of them
    by default; every rank of the group calls this, and one outside
    ``ranks`` gets None."""
    named = {"dp": dp, **axes}
    named["tp"] = tp
    n = int(np.prod(list(named.values())))
    world, rank = multihost.world(), multihost.rank()
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if n != len(ranks) or not set(ranks) <= set(range(world)) \
            or len(set(ranks)) != n:
        raise ValueError(f"mesh {named} has {n} ranks, laid over {ranks} of "
                         f"a process group of {world}")
    backend = dist.get_backend() if dist.is_initialized() else None
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    groups: Dict[str, Any] = {}
    for name, axis_lines in lines(named).items():
        groups[name] = None
        if named[name] == 1:
            continue
        # every line of ranks along this axis, in one order on every rank
        for line in axis_lines:
            members = [ranks[i] for i in line]
            g = dist.new_group(members)
            if rank in members:
                groups[name] = g
    if rank not in ranks:
        return None
    return Mesh(named, ranks.index(rank), groups, backend, dev, ranks)


# Split type per layer-param name, the JAX table: "col" = shard the output
# dim (N), no communication; "row" = shard the input dim (K), a sum after;
# "col_b" = a bias of a "col" product; "rep" = replicated.
_LAYER_SPLITS: Dict[str, str] = {
    "wq": "col", "wk": "col", "wv": "col",
    "bq": "col_b", "bk": "col_b", "bv": "col_b",
    "wo": "row", "bo": "rep",
    "w_gate": "col", "w_up": "col", "b_gate": "col_b", "b_up": "col_b",
    "w_down": "row", "b_down": "rep",
    "router": "rep",
    "attn_norm_w": "rep", "attn_norm_b": "rep",
    "ffn_norm_w": "rep", "ffn_norm_b": "rep",
    "post_attn_norm_w": "rep", "post_attn_norm_b": "rep",
    "q_norm_w": "rep", "k_norm_w": "rep",
}

Spec = Tuple[Optional[str], ...]

#: act-order under a K split: the JAX package keeps ``perm`` whole while the
#: planes split along K, and its ``linear`` then gathers the rank's K/tp
#: activations by indices of the whole K
PERM_ROW_SPLIT = (
    "an act-order (perm) weight cannot take a row (K) split: the reference "
    "keeps perm whole while the planes split along K, and its TP step "
    "fails there (ValueError: Incompatible shapes for broadcasting); "
    "dequantize or requantize the weight without act-order first")


def _qtensor_spec(split: str, lead: int) -> Dict[str, Spec]:
    """Specs of a QTensor's fields: planes [*lead, Kp, N], scales and zeros
    [*lead, G, N], perm [*lead, K] (kept whole)."""
    pad = (None,) * lead
    if split == "col":
        s = pad + (None, "tp")
        return {"planes": s, "scales": s, "zeros": s, "perm": ()}
    if split == "row":
        s = pad + ("tp", None)
        return {"planes": s, "scales": s, "zeros": s, "perm": ()}
    return {"planes": (), "scales": (), "zeros": (), "perm": ()}


def _leaf_spec(name: str, leaf, lead: int):
    """Spec of one layer entry (a QTensor or a tensor); ``lead`` counts the
    stacking dims before the tensor's own (1 for an expert stack)."""
    split = _LAYER_SPLITS.get(name, "rep")
    pad = (None,) * lead
    if isinstance(leaf, QTensor):
        return _qtensor_spec(split, lead)
    if not isinstance(leaf, torch.Tensor):
        return ()
    ndim = leaf.ndim - lead
    if split == "col" and ndim == 2:
        return pad + (None, "tp")
    if split == "row" and ndim == 2:
        return pad + ("tp", None)
    if split == "col_b" and ndim == 1:
        return pad + ("tp",)
    return ()


def param_specs(params, cfg: ModelConfig) -> Dict[str, Any]:
    """The spec tree of the port's param dict (``layers`` a list of
    per-layer dicts; a layer's ``experts`` a dict of ``[E, ...]`` stacks):
    the JAX ``param_specs``. The lm_head splits as ``w_up`` (its vocabulary
    over tp), the embedding is replicated (gathered per token), the ALiBi
    slopes follow the rank's q heads."""
    params = _param_dict(params)
    layers = []
    for lp in params["layers"]:
        spec = {}
        for name, leaf in lp.items():
            if name == "experts":
                spec["experts"] = {s: _leaf_spec(s, v, 1)
                                   for s, v in leaf.items()}
            else:
                spec[name] = _leaf_spec(name, leaf, 0)
        layers.append(spec)
    out: Dict[str, Any] = {"layers": layers}
    for name, leaf in params.items():
        if name == "layers":
            continue
        if name == "lm_head" and leaf is not None:
            out[name] = _leaf_spec("w_up", leaf, 0)
        elif name == "alibi_slopes":
            out[name] = ("tp",)
        else:
            out[name] = ()
    return out


def _param_dict(params) -> Dict[str, Any]:
    return params.param_dict() if hasattr(params, "param_dict") else params


def _take(t: Optional[torch.Tensor], spec: Spec, mesh: Mesh, what: str):
    """This rank's slice of ``t`` by ``spec``, as a contiguous copy."""
    if t is None:
        return None
    for dim, axis in enumerate(spec):
        n = mesh.size(axis) if axis else 1
        if n == 1:
            continue
        if t.shape[dim] % n:
            raise ValueError(f"{what}: dim {dim} of {tuple(t.shape)} does "
                             f"not split {n} ways over {axis}")
        step = t.shape[dim] // n
        t = t.narrow(dim, mesh.index(axis) * step, step)
    return t.clone(memory_format=torch.contiguous_format)


def _check_row_split(qt: QTensor, n: int, what: str):
    """Refuse what the JAX split cannot do exactly: an act-order weight, or
    a K split that cuts a scale group."""
    if qt.perm is not None:
        raise ValueError(f"{what}: {PERM_ROW_SPLIT}")
    G = qt.scales.shape[-2]
    if qt.cfg.group_size == -1 or G % n:
        raise ValueError(
            f"{what}: a K split {n} ways cuts a scale group (K={qt.K}, "
            f"{G} groups of {qt.group_size})")


def _shard_leaf(leaf, spec, mesh: Mesh, what: str):
    if isinstance(leaf, QTensor):
        if spec["planes"][-2:] == ("tp", None) and mesh.tp > 1:
            _check_row_split(leaf, mesh.tp, what)
        return QTensor(tuple(_take(p, spec["planes"], mesh, what)
                             for p in leaf.planes),
                       _take(leaf.scales, spec["scales"], mesh, what),
                       _take(leaf.zeros, spec["zeros"], mesh, what),
                       _take(leaf.perm, spec["perm"], mesh, what), leaf.cfg)
    if isinstance(leaf, torch.Tensor):
        return _take(leaf, spec, mesh, what)
    return leaf


def check_shardable(params, cfg: ModelConfig, mesh: Mesh):
    """Refuse what the split cannot carry: q or kv heads, or a quantized
    vocabulary, not divisible by tp; experts not divisible by ep; the fused
    ``wqkv``/``w_gateup`` of ``fuse_layer_weights`` (single-device only:
    TP splits the unfused names); expert biases under tp > 1 without ep
    (the JAX ``_moe_mlp`` adds them before its deferred sum)."""
    params = _param_dict(params)
    tp, ep = mesh.tp, mesh.ep
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(f"{cfg.n_heads} q heads over {cfg.n_kv_heads} kv "
                         f"heads do not split over tp={tp}")
    if ep > 1 and (not cfg.is_moe or cfg.n_experts % ep):
        raise ValueError(f"{cfg.n_experts} experts do not split over "
                         f"ep={ep}")
    for l, lp in enumerate(params["layers"]):
        fused = [n for n in ("wqkv", "w_gateup") if n in lp]
        if fused and tp > 1:
            raise ValueError(
                f"layer {l} holds {fused} (fuse_layer_weights), which is "
                "single-device only: tensor parallelism splits the unfused "
                "names")
        ex = lp.get("experts") or {}
        if tp > 1 and ep == 1 and any(ex.get(b) is not None
                                      for b in ("b_gate", "b_up", "b_down")):
            raise NotImplementedError(
                "expert biases under tp > 1: the reference's deferred sum "
                "adds each expert's b_down before it (tp times); no family "
                "the port runs has expert biases")


def shard_params(params, cfg: ModelConfig, mesh: Mesh,
                 specs=None) -> Dict[str, Any]:
    """This rank's slice of every leaf of a param dict (or a Transformer's
    ``param_dict()``) by ``specs`` (:func:`param_specs` by default), each a
    contiguous copy: the returned dict holds no view of the full weights."""
    params = _param_dict(params)
    check_shardable(params, cfg, mesh)
    specs = specs or param_specs(params, cfg)
    layers = []
    for l, (lp, sp) in enumerate(zip(params["layers"], specs["layers"])):
        out = {}
        for name, leaf in lp.items():
            if name == "experts":
                out[name] = {s: _shard_leaf(v, sp[name][s], mesh,
                                            f"layer {l} experts.{s}")
                             for s, v in leaf.items()}
            else:
                out[name] = _shard_leaf(leaf, sp[name], mesh,
                                        f"layer {l} {name}")
        layers.append(out)
    top = {name: _shard_leaf(leaf, specs[name], mesh, name)
           for name, leaf in params.items() if name != "layers"}
    return {"layers": layers, **top}


def shard_model(params, cfg: ModelConfig, mesh: Mesh, specs=None,
                capacity_factor: float = 2.0):
    """The rank's decoder: :func:`shard_params` built into a
    :class:`~neural_tpu_torch.models.transformer.Transformer` that carries
    ``mesh`` (its graph sums and gathers over it), on the mesh's device.
    ``capacity_factor``: the expert-parallel dispatch's buffer size
    (:func:`~neural_tpu_torch.parallel.ep.expert_capacity`)."""
    from ..models.transformer import Transformer
    if specs is None and mesh.ep > 1:
        from .ep import ep_param_specs
        specs = ep_param_specs(params, cfg)
    sharded = _to_device(shard_params(params, cfg, mesh, specs), mesh.device)
    return Transformer(cfg, sharded, mesh=mesh,
                       capacity_factor=capacity_factor)


def _to_device(tree, dev):
    def move(t):
        if isinstance(t, QTensor):
            return dataclasses.replace(
                t, planes=tuple(p.to(dev) for p in t.planes),
                scales=t.scales.to(dev),
                zeros=None if t.zeros is None else t.zeros.to(dev),
                perm=None if t.perm is None else t.perm.to(dev))
        return t.to(dev) if isinstance(t, torch.Tensor) else t
    return tree_map(move, tree, is_leaf=lambda x: isinstance(x, QTensor))


def cache_specs() -> KVCache:
    """KVCache spec tree: k/v [L, B, Hkv, S, Dh] and the flat int8-KV
    scales [L, B, Hkv, S]: batch over dp, kv heads over tp."""
    kv, sc = (None, "dp", "tp", None, None), (None, "dp", "tp", None)
    return KVCache(kv, kv, sc, sc)


def shard_cache(cache: KVCache, mesh: Mesh) -> KVCache:
    """This rank's rows (dp) and kv heads (tp) of a whole cache, copied."""
    s = cache_specs()
    return KVCache(*(None if c is None else _take(c, spec, mesh, "cache")
                     for c, spec in ((cache.k, s.k), (cache.v, s.v),
                                     (cache.k_scale, s.k_scale),
                                     (cache.v_scale, s.v_scale))))


def init_cache(cfg: ModelConfig, mesh: Mesh, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device=None) -> KVCache:
    """A zeroed per-rank cache for a global ``batch``: batch/dp rows and
    Hkv/tp kv heads (int8 scales to match), on the mesh's device unless
    ``device`` says otherwise."""
    if batch % mesh.dp or cfg.n_kv_heads % mesh.tp:
        raise ValueError(f"batch {batch} / kv heads {cfg.n_kv_heads} do not "
                         f"split over dp={mesh.dp}, tp={mesh.tp}")
    local = dataclasses.replace(cfg, n_kv_heads=cfg.n_kv_heads // mesh.tp)
    return _init_cache(local, batch // mesh.dp, max_len, dtype,
                       device=device or mesh.device)


def dp_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global batch ``x`` [B, ...] (B divisible by
    dp)."""
    n = x.shape[0] // mesh.dp
    return x[mesh.index("dp") * n:(mesh.index("dp") + 1) * n]


def lines(shape: Dict[str, int]) -> Dict[str, list]:
    """The rank lists of a mesh shape's lines along each axis, by axis:
    what :func:`make_mesh` makes a subgroup of (the ranks that differ only
    along that axis), readable without a process group."""
    names = tuple(shape)
    sizes = tuple(shape.values())
    grid = np.arange(int(np.prod(sizes))).reshape(sizes)
    return {name: [list(map(int, line)) for line in
                   np.moveaxis(grid, ax, -1).reshape(-1, sizes[ax])]
            for ax, name in enumerate(names)}


__all__ = ["Mesh", "make_mesh", "param_specs", "shard_params",
           "shard_model", "cache_specs", "shard_cache", "init_cache",
           "dp_rows", "check_shardable", "PERM_ROW_SPLIT"]
