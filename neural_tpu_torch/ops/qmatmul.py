"""Quantized matmul: the K1, K2 and K5 kernels, their plain versions and
the dispatch (port of ``neural_tpu/ops/qmatmul.py``).

The weights arrive in the layouts of :mod:`neural_tpu_torch.core.qtensor`:
at rest (native-pack 2-4 bit, int8 code planes for 5-8 bit, bf16 scales) or
stored (bit planes, nf4/fp4 indices, fp8; f32 or bf16 scales).

- **K1** :func:`qmm_native` (``csrc/qmm4_npack.cu``) replaces the TPU's
  ``_qmm4_kernel``: ``out = x @ (codes · s)`` for at-rest codes at M <= 16,
  f32 dequant and f32 accumulation, the group scale applied to each group's
  partial sum, zero-points as a rank-G correction. Its fusion options
  (the TPU kernel's ``fuse``: an RMS-norm or ``act(g) · u`` prologue, a
  residual epilogue) are :func:`qmm_native_fused`, driven by
  :func:`qmatmul_fused` on the fused decode path.
- **K2** :func:`qmm_a8` (``csrc/qmm_a8.cu``) replaces ``_qmm_a8_kernel``:
  x is quantized per row and per ``gd`` K-group to sym int8, each group is
  an int8·int8→int32 dot, folded as ``acc += d · (sa_g ⊗ sw_g)`` in f32;
  asymmetric weights start the accumulator at ``-(xsa @ zwp)``. The
  weights are at rest: native-pack int4/int3 nibbles, int2 fields or int8
  code planes (5-8 bit). The TPU kernel quantizes x inside the kernel or
  in ``quantize_act_i8`` depending on N; the two are bit-identical, so one
  port kernel serves both. TMA-staged wgmma tiles (:func:`k2_schedule`).
- **K5** :func:`qmm_general` (``csrc/qmm_general.cu``) replaces
  ``_qmm_kernel``: every weight dequantized in f32 and rounded once to
  bf16, a bf16 × bf16 product with f32 accumulation, any M, every layout;
  a GEMV body at M <= 16, pipelined wgmma tiles above (:func:`k5_schedule`).

:func:`qmatmul` routes as the JAX package does (:func:`route`), a shape
that no kernel takes to :func:`qmm_plain`, the JAX package's own
fallback. Each wrapper takes its plain PyTorch version only for CPU
tensors; on a CUDA tensor it launches the kernel or raises.

Act-order weights (GPTQ ``perm``: stored row r is W's row perm[r]) take x
gathered by the permutation, ``x[:, perm]``, before any of the kernels, as
the JAX package's ``gathered`` does in XLA; the kernels read the stored row
order, and the int8 path quantizes the gathered x, so its K-groups are the
stored ones.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache, partial
from typing import Optional

import torch
import torch.nn.functional as F

from ..core.qtensor import (QTensor, dequantize, is_native, lut_on,
                           native_fields, pack_chunk)
from . import _cuda
from .norms import rms_norm_plain

# ---------------------------------------------------------------------------
# activation quantization (K2's first pass)
# ---------------------------------------------------------------------------


def quantize_act_i8(x: torch.Tensor, gd: int):
    """Dynamic per-row, per-K-group sym int8 quantization: x [M, K] → (int8
    codes [M, K], f32 scales [M, K//gd]). Scale ``(absmax + 1e-9) / 127``;
    codes ``round(x / scale)`` with round half to even — a division, not a
    multiplication by the reciprocal, as in the JAX package."""
    M, K = x.shape
    if K % gd:
        raise ValueError(f"K={K} is not a multiple of gd={gd}")
    xg = x.to(torch.float32).reshape(M, K // gd, gd)
    absmax = xg.abs().amax(dim=2) + 1e-9
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by the reciprocal, which is not the IEEE quotient
    sa = absmax / torch.full_like(absmax, 127.0)
    q = torch.round(xg / sa[:, :, None]).to(torch.int8)
    return q.reshape(M, K), sa


def act_quant_i8(x: torch.Tensor, gd: int):
    """:func:`quantize_act_i8` through K2's quantization kernel on the card
    (bit-identical by construction: same scale formula, IEEE division,
    ``rintf``)."""
    _cuda.refuse_grad("quantize_act_i8", x)
    if x.device.type == "cpu":
        return quantize_act_i8(x, gd)
    x = x.contiguous()
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bf16 or f32, got {x.dtype}")
    M, K = x.shape
    if K % gd or gd % 32:
        raise ValueError(f"K={K}, gd={gd}: need gd % 32 == 0 and K % gd == 0")
    xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
    sa = torch.empty((M, K // gd), dtype=torch.float32, device=x.device)
    _cuda.QMM_A8.call("quantize_act_i8", _cuda.ptr(x),
                      int(x.dtype == torch.float32), _cuda.ptr(xq),
                      _cuda.ptr(sa), M, K, gd, _cuda.stream_ptr())
    return xq, sa


def matmul_a8_ref(x: torch.Tensor, qt: QTensor, gd: int, dtype=None):
    """Oracle of the int8-compute path: quantize the activations, then exact
    f32 arithmetic over the same integer values the kernel sees."""
    out_dtype = dtype or x.dtype
    *lead, K = x.shape
    x2 = x.reshape(-1, K)
    if qt.perm is not None:
        # quantization groups follow the stored (act-order) row order, as
        # on the kernel path
        x2 = x2.index_select(1, qt.perm)
        qt = dataclasses.replace(qt, perm=None)
    x_i8, sa = quantize_act_i8(x2, gd)
    xd = x_i8.to(torch.float32).reshape(-1, K // gd, gd) * sa[:, :, None]
    out = xd.reshape(-1, K) @ dequantize(qt, torch.float32)
    return out.to(out_dtype).reshape(*lead, qt.N)


# ---------------------------------------------------------------------------
# K1: native-code GEMV / skinny GEMM (M <= 16)
# ---------------------------------------------------------------------------


def native_codes(planes: torch.Tensor, bits: int) -> torch.Tensor:
    """Centered codes int32 [K, N] of an at-rest plane: int8 code planes as
    they are, native-pack fields sign-extended."""
    if planes.dtype == torch.int8:
        return planes.to(torch.int32)
    return native_fields(planes, bits)


def qmm_native_plain(x: torch.Tensor, planes: torch.Tensor,
                     scales: torch.Tensor, zeros: Optional[torch.Tensor],
                     group: int, bits: int,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of K1, with its rounding: x rounded to bf16 then widened
    to f32, f32 codes, one f32 partial product per group times the group's
    bf16 scale widened to f32, summed over groups; zero-points as the rank-G
    correction ``- xs @ (z · s)``, xs the f32 per-group sums of x."""
    M, K = x.shape
    N = planes.shape[1]
    G = K // group
    xf = x.to(torch.bfloat16).to(torch.float32).reshape(M, G, group)
    w = native_codes(planes, bits).to(torch.float32).reshape(G, group, N)
    s = scales.to(torch.float32)
    part = torch.einsum("mgk,gkn->mgn", xf, w)
    out = (part * s[None]).sum(dim=1)
    if zeros is not None:
        out = out - xf.sum(dim=2) @ (zeros.to(torch.float32) * s)
    return out.to(out_dtype)


# K1's schedule (``csrc/qmm4_npack.cu``): 128 output columns a block, K
# streamed in stages of 128 values through a 32 KB TMA ring, four consumer
# warps and a producer warp a block, about one block an SM and at most two
# (the shared memory each may take for the ring, the staged slice of x, the
# warps' sums and the scale rows), one wave: a block is one (column tile, K
# split) item
K1_TILE_N, K1_STAGE_K, K1_RING_BYTES, K1_XPAD = 128, 128, 32768, 8
K1_CONSUMERS = 4
K1_BLOCKS_PER_SM = 2
K1_SMEM_CAP = 112 * 1024    # a block's share of an SM's 228 KB, less 2 KB
K1_TICKETS = 1 << 16      # ticket counters kept per device, a column tile each
H100_SMS = 132


def k1_smem(M: int, spk: int, group: int = 128, asym: bool = False) -> int:
    """Dynamic shared memory of a K1 block with ``spk`` stages a split: the
    ring (1024-aligned), the staged x slice (bf16, padded rows), the
    consumer warps' sums and the bf16 scale rows of the groups a split
    touches (with zero-points also their rows and x's f32 group sums); the
    C source's ``smem_bytes``."""
    g_rows = spk * K1_STAGE_K // group + 2
    return 1024 + K1_RING_BYTES + M * (spk * K1_STAGE_K + K1_XPAD) * 2 \
        + K1_CONSUMERS * M * K1_TILE_N * 4 \
        + (g_rows * (K1_TILE_N * 4 + M * 4) if asym
           else g_rows * K1_TILE_N * 2)


@lru_cache(maxsize=None)
def k1_schedule(M: int, K: int, N: int, group: int = 128, asym: bool = False,
                n_sm: int = H100_SMS) -> dict:
    """K1's launch for ``[M, K] @ [K, N]`` with scale groups of ``group``
    rows (and zero-points when ``asym``): the column tiles, the K stages,
    the split of the stages into ``splits`` items a column tile of
    ``stages_per_split`` stages (the C source derives it from the splits),
    and the grid (splits, column tiles). The splits fill the card's
    K1_BLOCKS_PER_SM·SMs block slots at most once (no split where the
    column tiles alone fill them, as the gate/up products and the lm_head
    do), then grow until K1_BLOCKS_PER_SM blocks fit an SM's shared
    memory. The
    decision rests on the shapes and the SM count alone."""
    tiles = -(-N // K1_TILE_N)
    kst = -(-K // K1_STAGE_K)
    splits = max(1, min(kst, round(n_sm / tiles)))
    spk = -(-kst // splits)
    while k1_smem(M, spk, group, asym) > K1_SMEM_CAP and spk > 1:
        splits += 1
        spk = -(-kst // splits)
    splits = -(-kst // spk)
    return dict(tiles=tiles, stages=kst, splits=splits,
                stages_per_split=spk, grid=(splits, tiles),
                smem=k1_smem(M, spk, group, asym))


def k1_items(M: int, K: int, N: int, group: int = 128, asym: bool = False,
             n_sm: int = H100_SMS) -> dict:
    """The work of :func:`k1_schedule`'s grid, as the C source walks it:
    ``items`` maps each block (split, column tile) to its output columns
    and its K range (a split's ``stages_per_split`` stages of K1_STAGE_K,
    the last one cut at K); ``merge`` each column tile's splits in the
    order its last block adds their partials."""
    sch = k1_schedule(M, K, N, group, asym, n_sm)
    spk = sch["stages_per_split"] * K1_STAGE_K
    items = {(sp, t): (range(t * K1_TILE_N, min(N, (t + 1) * K1_TILE_N)),
                       range(sp * spk, min(K, (sp + 1) * spk)))
             for sp in range(sch["splits"]) for t in range(sch["tiles"])}
    return dict(items=items,
                merge={t: list(range(sch["splits"]))
                       for t in range(sch["tiles"])})


def _k1_launch(fn, x, N, group, out_dtype, head, branches=()):
    """Launch one K1 entry point: ``head`` are its pointer and option
    arguments up to the planes and scales (sym and asym: x, planes,
    scales, zeros, xs; fused: x and its options, planes, scales), then the
    f32 scratch of :func:`k1_schedule`'s splits, the per-device ticket
    counters (``_cuda.tickets``) and the output."""
    M, K = x.shape
    sch = k1_schedule(M, K, N, group, fn.endswith("_asym"),
                      _cuda.sm_count(x.device))
    splits = sch["splits"]
    partial = torch.empty((splits, M, N) if splits > 1 else (1,),
                          dtype=torch.float32, device=x.device)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    tickets = _cuda.tickets("K1", x.device, sch["tiles"], K1_TICKETS)
    _cuda.QMM4.call(fn, *head, _cuda.ptr(partial), _cuda.ptr(tickets),
                    _cuda.ptr(out), M, K, N, group,
                    int(out_dtype == torch.float32), splits,
                    _cuda.stream_ptr(), branches=branches)
    return out


def qmm_native(x: torch.Tensor, planes: torch.Tensor, scales: torch.Tensor,
               zeros: Optional[torch.Tensor], group: int, bits: int,
               out_dtype: torch.dtype) -> torch.Tensor:
    """K1: ``x [M, K] @ W`` for at-rest native codes, M <= 16: native-pack
    nibbles (int3/int4), native-pack int2, or int8 code planes (5-8 bit),
    with optional bf16 zero-points. One launch (:func:`k1_schedule`): the
    K splits' f32 partials are added in split order by the last block of
    each column tile, so reruns give identical outputs. The C entry point
    names the branch: the
    layout (``qmm4_npack`` nibbles, ``qmm2_npack``, ``qmm8_native``), with
    ``_asym`` when there are zero-points."""
    _cuda.refuse_grad("qmm_native (K1)", x, planes, scales, zeros)
    if x.device.type == "cpu":
        return qmm_native_plain(x, planes, scales, zeros, group, bits,
                                out_dtype)
    x = x.to(torch.bfloat16).contiguous()
    M, K = x.shape
    N = planes.shape[1]
    _cuda.check(x, "x", torch.bfloat16)
    if planes.dtype == torch.int8:
        fn, rows = "qmm8_native", K
    elif bits == 2:
        fn, rows = "qmm2_npack", K // 4
    else:
        fn, rows = "qmm4_npack", K // 2
    _cuda.check(planes, "planes", planes.dtype, (rows, N))
    _cuda.check(scales, "scales", torch.bfloat16, (K // group, N))
    if zeros is not None:
        _cuda.check(zeros, "zeros", torch.bfloat16, (K // group, N))
    _check_k1(M, K, N, group)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bf16 or f32, got {out_dtype}")
    if any(t.data_ptr() % 16 for t in (planes, scales)
           + (() if zeros is None else (zeros,))):
        raise ValueError("planes, scales and zeros must be 16-byte aligned")
    xs = None
    if zeros is not None:   # per-group sums of x, outside the kernel
        fn += "_asym"
        xs = x.to(torch.float32).reshape(M, K // group, group).sum(dim=2)
    return _k1_launch(fn, x, N, group, out_dtype, (
        _cuda.ptr(x), _cuda.ptr(planes), _cuda.ptr(scales),
        None if zeros is None else _cuda.ptr(zeros),
        None if xs is None else _cuda.ptr(xs)))


def k1_takes(M: int, K: int, N: int, group: int) -> bool:
    """The shapes K1 takes: 1 <= M <= 16, K and the group multiples of 32,
    K a multiple of the group, N a multiple of 16."""
    return 1 <= M <= 16 and K % 32 == 0 and group % 32 == 0 \
        and K % group == 0 and N % 16 == 0


def _check_k1(M: int, K: int, N: int, group: int):
    if not k1_takes(M, K, N, group):
        raise ValueError(f"K1 takes 1 <= M <= 16, K and the group multiples "
                         f"of 32 and N of 16 (M={M}, K={K}, group={group}, "
                         f"N={N})")


# ---------------------------------------------------------------------------
# K1's fusion options (the TPU kernel's ``fuse``)
# ---------------------------------------------------------------------------

# the activations of the graph (``models/transformer.py``) and of the glu
# prologue, by the config's name, and their codes in csrc/qmm4_npack.cu (Act)
ACTS = {"silu": F.silu, "gelu": F.gelu,
        "gelu_tanh": partial(F.gelu, approximate="tanh"), "relu": F.relu}
_ACT_CODE = {"silu": 0, "gelu": 1, "gelu_tanh": 2, "relu": 3}


def fused_input_plain(x: torch.Tensor, norm=None, u=None,
                      act: Optional[str] = None) -> torch.Tensor:
    """The fused prologue's output, bf16 [M, K]: ``bf16(act(x) · u)`` in
    f32 with one rounding (glu: x is the gate input), then the torch chain
    ``rms_norm_plain`` with ``norm = (weight, eps, offset)`` (rms: x is the
    raw residual stream). On the card this stays torch ops, so K1's rms
    prologue is held against a norm that does not share its routine."""
    if u is not None:
        x = (ACTS[act](x.to(torch.float32))
             * u.to(torch.float32)).to(torch.bfloat16)
    if norm is not None:
        w, eps, offset = norm
        x = rms_norm_plain(x.to(torch.bfloat16), w, eps, offset)
    return x.to(torch.bfloat16)


def qmm_native_fused_plain(x: torch.Tensor, planes: torch.Tensor,
                           scales: torch.Tensor, group: int, bits: int,
                           out_dtype: torch.dtype, norm=None, u=None,
                           act: Optional[str] = None,
                           res: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain version of K1 with its fusion options, composed of the port's
    own ops: :func:`fused_input_plain`, :func:`qmm_native_plain`, then
    ``out + res`` in ``out_dtype``. Without glu it is the unfused chain
    (``rms_norm``, the product, the residual add) bit for bit on the CPU,
    where ``rms_norm`` is ``rms_norm_plain``; with glu the activation is
    rounded once, where the unfused ``act(g) * u`` in bf16 rounds twice."""
    h = fused_input_plain(x, norm, u, act)
    out = qmm_native_plain(h, planes, scales, None, group, bits, out_dtype)
    if res is not None:
        out = out + res.to(out_dtype)
    return out


def qmm_native_fused(x: torch.Tensor, planes: torch.Tensor,
                     scales: torch.Tensor, group: int, bits: int,
                     out_dtype: torch.dtype, norm=None, u=None,
                     act: Optional[str] = None,
                     res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1 with the TPU kernel's fusion options, for symmetric codes at rest:
    ``norm = (weight [K], eps, offset)`` RMS-normalises the raw residual
    stream x in the prologue; ``u`` (with ``act``) makes x the gate input
    and the product's input ``act(x) · u``; ``res`` [M, N] is added to the
    output in the second pass. One C entry point per code layout
    (``qmm4_npack_fused``, ``qmm2_npack_fused``, ``qmm8_native_fused``),
    each launch also counted under its options (``+rms``, ``+glu``,
    ``+res``)."""
    _cuda.refuse_grad("qmm_native_fused (K1)", x, planes, scales, u, res,
                      None if norm is None else norm[0])
    if x.device.type == "cpu":
        return qmm_native_fused_plain(x, planes, scales, group, bits,
                                      out_dtype, norm, u, act, res)
    x = x.contiguous()
    M, K = x.shape
    N = planes.shape[1]
    _cuda.check(x, "x", torch.bfloat16)
    if planes.dtype == torch.int8:
        fn, rows = "qmm8_native_fused", K
    elif bits == 2:
        fn, rows = "qmm2_npack_fused", K // 4
    else:
        fn, rows = "qmm4_npack_fused", K // 2
    _cuda.check(planes, "planes", planes.dtype, (rows, N))
    _cuda.check(scales, "scales", torch.bfloat16, (K // group, N))
    _check_k1(M, K, N, group)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bf16 or f32, got {out_dtype}")
    branches = []
    nw, eps, offset, norm_f32 = None, 0.0, 0.0, 0
    if norm is not None:
        nw, eps, offset = norm
        if nw.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"the norm weight must be bf16 or f32, got "
                             f"{nw.dtype}")
        _cuda.check(nw, "norm weight", nw.dtype, (K,))
        norm_f32 = int(nw.dtype == torch.float32)
        branches.append("rms")
    if u is not None:
        if act not in _ACT_CODE:
            raise ValueError(f"glu takes {sorted(_ACT_CODE)}, got {act!r}")
        u = u.contiguous()
        _cuda.check(u, "u", torch.bfloat16, (M, K))
        branches.append("glu")
    if res is not None:
        res = res.contiguous()
        _cuda.check(res, "res", torch.bfloat16, (M, N))
        branches.append("res")
    if any(t.data_ptr() % 16 for t in (x, planes, scales)
           + tuple(t for t in (u, nw) if t is not None)):
        raise ValueError("x, u, the norm weight, planes and scales must be "
                         "16-byte aligned")
    opt = lambda t: None if t is None else _cuda.ptr(t)
    return _k1_launch(fn, x, N, group, out_dtype, (
        _cuda.ptr(x), opt(u), opt(nw), norm_f32, float(eps), float(offset),
        _ACT_CODE.get(act, 0), opt(res), _cuda.ptr(planes),
        _cuda.ptr(scales)), branches=branches)


def has_decode_tile(M: int, K: int, N: int, group: int,
                    code_bits: int) -> bool:
    """The JAX package's ``_pick_decode_tiles`` rule, which decides whether
    a product can take the fused kernel: M <= 16, K a multiple of 32 and of
    the group, and a tile width of 128-2048 under the 6 MB code-block cap
    that divides N. The port's K1 takes no tiles; only the rule matters."""
    if M > 16 or K % 32 or K % group:
        return False
    cap = (6 << 20) * 8 // (K * code_bits)
    return any(tn <= cap and N % tn == 0
               for tn in (2048, 1024, 640, 512, 384, 256, 128))


def fusable(qt: QTensor) -> bool:
    """Whether the fused K1 takes the weight ``qt`` at all: the weight's
    half of :func:`qmatmul_fused`'s rule, which a decoder block reads once
    at load to choose its route before computing anything."""
    if qt.zeros is not None or qt.perm is not None or not is_native(qt) \
            or qt.group_size % 32:
        return False
    code_bits = 8 if qt.planes[0].dtype == torch.int8 else \
        2 if qt.cfg.bits == 2 else 4
    return has_decode_tile(1, qt.K, qt.N, qt.group_size, code_bits)


def qmatmul_fused(x, qt: QTensor, out_dtype: Optional[torch.dtype] = None,
                  norm=None, glu: Optional[str] = None,
                  res: Optional[torch.Tensor] = None
                  ) -> Optional[torch.Tensor]:
    """A decode step's product with its elementwise neighbours folded into
    K1 (the JAX package's ``qmatmul_fused``). x: [M, K], the raw residual
    stream when ``norm = (weight, eps, offset)`` is set, or a pair (gate,
    up) when ``glu`` names the activation; ``res`` [M, N] is added to the
    output in ``out_dtype``.

    Returns the [M, N] result, or None exactly where the JAX function does:
    zero-points, an act-order ``perm``, codes not at rest, M > 16, K not a
    multiple of 32 or of the group, no tile for N (N not a multiple of
    128); and, where the port's K1 differs, a group that is not a multiple
    of 32 (which :func:`route` sends to K5). The caller then takes the
    unfused ops. The decision rests on the shapes and the weight alone
    (:func:`fusable`); a kernel that fails raises."""
    u = None
    if glu is not None:
        x, u = x
    if x.ndim != 2 or x.shape[0] > 16 or not fusable(qt):
        return None
    M = x.shape[0]
    out_dtype = out_dtype or x.dtype
    if u is not None:
        u = u.to(torch.bfloat16)
    if res is not None:
        res = res.reshape(M, qt.N)
    return qmm_native_fused(x.to(torch.bfloat16), qt.planes[0], qt.scales,
                            qt.group_size, qt.cfg.bits, out_dtype, norm, u,
                            glu, res)


# ---------------------------------------------------------------------------
# K2: w4a8 GEMM (M >= 256)
# ---------------------------------------------------------------------------


def _a8_zero_terms(xq: torch.Tensor, sa: torch.Tensor, zeros: torch.Tensor,
                   scales: torch.Tensor, gd: int):
    """The asymmetric K2's two rank-K/gd operands, as the JAX launcher
    computes them: ``xsa = sa · rowsum_gd(x_i8)`` [M, K/gd] and ``zwp = z ·
    sw`` repeated to one row per dot group [K/gd, N], both f32."""
    M, K = xq.shape
    Ga = K // gd
    xsa = xq.to(torch.float32).reshape(M, Ga, gd).sum(dim=2) * sa
    zwp = zeros.to(torch.float32) * scales.to(torch.float32)
    if zwp.shape[0] != Ga:
        zwp = torch.repeat_interleave(zwp, Ga // zwp.shape[0], dim=0)
    return xsa, zwp.contiguous()


def qmm_a8_plain(x: torch.Tensor, planes: torch.Tensor, scales: torch.Tensor,
                 group: int, gd: int, out_dtype: torch.dtype,
                 zeros: Optional[torch.Tensor] = None,
                 bits: int = 4) -> torch.Tensor:
    """Plain version of K2: int8 codes of x, the centered codes of W
    (native-pack int2-4 fields of ``bits``, or an int8 code plane), one
    integer dot per gd-group (exact in f32: |d| < 2^24), and the fold
    ``acc = acc + d * (sa_g * sw_g)`` in f32 in group order — the kernel's
    own order of operations. With zero-points the accumulator starts at
    ``-(xsa @ zwp)``."""
    M, K = x.shape
    N = planes.shape[1]
    xq, sa = quantize_act_i8(x, gd)
    w = native_codes(planes, bits).to(torch.float32)
    sw = scales.to(torch.float32)
    r = max(group // gd, 1)
    if zeros is None:
        acc = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    else:
        xsa, zwp = _a8_zero_terms(xq, sa, zeros, scales, gd)
        acc = -(xsa @ zwp)
    for ga in range(K // gd):
        d = xq[:, ga * gd:(ga + 1) * gd].to(torch.float32) \
            @ w[ga * gd:(ga + 1) * gd]
        acc = acc + d * (sa[:, ga, None] * sw[ga // r][None, :])
    return acc.to(out_dtype)


# K2's tiles (``csrc/qmm_a8.cu``): 128 rows of x by 128 output columns a
# block over the whole K in 128-deep tiles (a dot group is one or more
# whole tiles), no split
K2_BM, K2_BN, K2_BK = 128, 128, 128


def k2_schedule(M: int, K: int, N: int) -> dict:
    """K2's launch for an [M, K] @ [K, N] product, as the C entry point
    computes it: the rows and columns of a block, the K step and the grid
    (N blocks, M blocks)."""
    return dict(rows=K2_BM, cols=K2_BN, k_step=K2_BK,
                grid=(N // K2_BN, -(-M // K2_BM)))


def qmm_a8(x: torch.Tensor, planes: torch.Tensor, scales: torch.Tensor,
           group: int, gd: int, out_dtype: torch.dtype,
           zeros: Optional[torch.Tensor] = None,
           bits: int = 4) -> torch.Tensor:
    """K2: int8-activation GEMM over weights at rest, sym or with bf16
    zero-points (the ``_asym`` entry points). The C entry point names the
    layout: ``qmm_a8`` native-pack nibbles (int4; int3 also counts as
    ``qmm_a8+int3``), ``qmm_a8_int2`` native-pack 2-bit fields,
    ``qmm_a8_int8`` int8 code planes. Two launches: the activation
    quantization, then the int8 tensor-core GEMM with the per-group f32
    fold."""
    _cuda.refuse_grad("qmm_a8 (K2)", x, planes, scales, zeros)
    if x.device.type == "cpu":
        return qmm_a8_plain(x, planes, scales, group, gd, out_dtype, zeros,
                            bits)
    M, K = x.shape
    N = planes.shape[1]
    if planes.dtype == torch.int8:
        fn, rows = "qmm_a8_int8", K
    elif bits == 2:
        fn, rows = "qmm_a8_int2", K // 4
    elif bits in (3, 4):
        fn, rows = "qmm_a8", K // 2
    else:
        raise ValueError(f"K2 reads native-pack int2-4 or int8 code planes, "
                         f"got {planes.dtype} at {bits} bits")
    _cuda.check(planes, "planes", planes.dtype, (rows, N))
    _cuda.check(scales, "scales", torch.bfloat16, (K // group, N))
    if gd % 128 or K % gd or group % gd or N % 128:
        raise ValueError(f"qmm_a8 needs gd % 128 == 0, K % gd == 0, "
                         f"group % gd == 0, N % 128 == 0 (K={K}, N={N}, "
                         f"group={group}, gd={gd})")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bf16 or f32, got {out_dtype}")
    xq, sa = act_quant_i8(x, gd)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    tail = (M, K, N, gd, group, int(out_dtype == torch.float32),
            _cuda.stream_ptr())
    branches = ("int3",) if bits == 3 and planes.dtype == torch.uint8 else ()
    if zeros is None:
        _cuda.QMM_A8.call(fn, _cuda.ptr(xq), _cuda.ptr(sa),
                          _cuda.ptr(planes), _cuda.ptr(scales),
                          _cuda.ptr(out), *tail, branches=branches)
        return out
    _cuda.check(zeros, "zeros", torch.bfloat16, (K // group, N))
    xsa, zwp = _a8_zero_terms(xq, sa, zeros, scales, gd)
    _cuda.QMM_A8.call(fn + "_asym", _cuda.ptr(xq), _cuda.ptr(sa),
                      _cuda.ptr(planes), _cuda.ptr(scales), _cuda.ptr(zwp),
                      _cuda.ptr(xsa), _cuda.ptr(out), *tail,
                      branches=branches)
    return out


# ---------------------------------------------------------------------------
# K5: the general dequant GEMM (any M, every weight layout)
# ---------------------------------------------------------------------------


def dequant_bf16(qt: QTensor) -> torch.Tensor:
    """The weight as K5 multiplies it, [K, N] bf16: each element taken in
    f32 (code minus zero-point, table value, fp8 value or ±1), times its
    group's scale in f32, rounded once to bf16 — ``_dequant_tile``'s
    rounding, which is :func:`dequantize`'s f32 value rounded to bf16 (in
    W's row order: an act-order weight is un-permuted)."""
    return dequantize(qt, torch.float32).to(torch.bfloat16)


def qmm_general_plain(x: torch.Tensor, qt: QTensor,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of K5: x rounded to bf16 times :func:`dequant_bf16`,
    accumulated in f32 (the products of two bf16 values are exact in f32),
    cast to ``out_dtype``. The weight's rows in their stored order, as the
    kernel reads them: x of an act-order weight comes gathered."""
    _check_no_perm(qt)
    xf = x.to(torch.bfloat16).to(torch.float32)
    return (xf @ dequant_bf16(qt).to(torch.float32)).to(out_dtype)


# the layouts K5 reads (csrc/qmm_general.cu Fmt) and the values of PLANES
K5_PLANES, K5_NPACK4, K5_NPACK2, K5_INT8, K5_FP8 = range(5)
V_INT, V_ONEBIT, V_LUT = range(3)
_ZKIND = {None: 0, torch.uint8: 1, torch.bfloat16: 2, torch.float32: 3}
# K5's tiles (``csrc/qmm_general.cu``). Both routes cover K5_BN = 128
# output columns a block. The gemv route (M <= K5_GEMV_M) takes K5_GEMV_K =
# 512 K rows and up to 8 rows of x a block. The tc route takes BM = 128
# rows of x a block (M <= 128) or 256 over K tiles of K5_BK = 64 rows, one
# block on each SM at a time (its ring fills most of the shared memory),
# so its K is split only while the output tiles fill less than one wave of
# K5_TARGET_BLOCKS, each split keeping at least 4 K tiles.
K5_BN, K5_BK, K5_GEMV_K, K5_GEMV_M = 128, 64, 512, 16
K5_TARGET_BLOCKS = 132          # the H100's SMs: one tc block each
K5_MAX_SPLITS = 8               # tc: the second pass reads M·N·4 a split


def _k5_layout(qt: QTensor):
    """(fmt, vmode, zconst) of a QTensor for K5."""
    cfg = qt.cfg
    if cfg.kind.startswith("fp8"):
        return K5_FP8, V_INT, 0.0
    if cfg.kind in ("nf4", "fp4"):
        return K5_PLANES, V_LUT, 0.0
    if qt.planes[0].dtype == torch.int8:
        return K5_INT8, V_INT, 0.0
    if cfg.native_pack:
        return (K5_NPACK2 if cfg.bits == 2 else K5_NPACK4), V_INT, 0.0
    if cfg.bits == 1:
        return K5_PLANES, V_ONEBIT, 0.0
    # sym bit-plane codes are unsigned: the zero-point is 2^(bits-1)
    return K5_PLANES, V_INT, 0.0 if qt.zeros is not None \
        else float(1 << (cfg.bits - 1))


def k5_route(M: int) -> str:
    """K5's body for M rows of x: "gemv" at M <= 16, else "tc"."""
    return "gemv" if M <= K5_GEMV_M else "tc"


def k5_rows(M: int) -> int:
    """Rows of x a K5 block takes: 1, 2, 4 or 8 on the gemv route, 128 or
    256 on the tc route."""
    if k5_route(M) == "gemv":
        return 1 if M == 1 else 2 if M == 2 else 4 if M <= 4 else 8
    return 128 if M <= 128 else 256


def k5_splits(M: int, K: int, N: int):
    """(splits, K rows per split) of K5's grid. gemv: one split per 512 K
    rows. tc: no split once the output tiles fill a wave of the card;
    below that the split count up to K5_MAX_SPLITS that wastes the least
    of its waves (the fewest waves per split), each split keeping >= 4 K
    tiles."""
    if k5_route(M) == "gemv":
        return -(-K // K5_GEMV_K), K5_GEMV_K
    tiles = -(-N // K5_BN) * -(-M // k5_rows(M))
    ktiles = -(-K // K5_BK)
    splits = 1
    if tiles < K5_TARGET_BLOCKS:
        splits = min(range(1, max(1, min(K5_MAX_SPLITS, ktiles // 4)) + 1),
                     key=lambda s: (-(-tiles * s // K5_TARGET_BLOCKS) / s, s))
    kps = -(-ktiles // splits) * K5_BK
    return -(-K // kps), kps


def k5_schedule(M: int, K: int, N: int) -> dict:
    """K5's launch for an [M, K] @ [K, N] product, as the C entry point
    computes it from M and the wrapper's splits: the route, the rows of x a
    block, the splits and K rows per split, the K step a split is cut in
    and the grid (N blocks, splits, M blocks)."""
    splits, kps = k5_splits(M, K, N)
    rows = k5_rows(M)
    return dict(route=k5_route(M), rows=rows, splits=splits, kps=kps,
                k_step=K5_GEMV_K if k5_route(M) == "gemv" else K5_BK,
                grid=(-(-N // K5_BN), splits, -(-M // rows)))


def k5_takes(K: int, N: int, group: int) -> bool:
    """The shapes K5 takes: K a multiple of 32 and of the group, N of 16,
    the group of 8."""
    return K % 32 == 0 and N % 16 == 0 and K % group == 0 and group % 8 == 0


def qmm_general(x: torch.Tensor, qt: QTensor,
                out_dtype: torch.dtype) -> torch.Tensor:
    """K5: ``x [M, K] @ W`` for any M and every weight layout of the port
    (bit-plane 1-8 bit int, nf4/fp4, fp8, native-pack int2-4, int8 codes;
    f32 or bf16 scales; uint8, bf16 or f32 zero-points). The C entry point
    takes the gemv body at M <= 16 and the tensor-core tiles above
    (:func:`k5_schedule`); each launch also counts under its route,
    ``qmm_general+gemv`` or ``qmm_general+tc``."""
    _cuda.refuse_grad("qmm_general (K5)", x, *qt.planes, qt.scales, qt.zeros)
    if x.device.type == "cpu":
        return qmm_general_plain(x, qt, out_dtype)
    _check_no_perm(qt)
    x = x.to(torch.bfloat16).contiguous()
    _cuda.check(x, "x", torch.bfloat16)
    M, K = x.shape
    N, g = qt.N, qt.group_size
    cfg = qt.cfg
    fmt, vmode, zconst = _k5_layout(qt)
    for i, p in enumerate(qt.planes):
        _cuda.check(p, f"plane {i}", p.dtype)
    if qt.K != K or not k5_takes(K, N, g):
        raise ValueError(f"K5 needs K % 32 == 0, N % 16 == 0, K % group "
                         f"== 0 and group % 8 == 0 (x K={K}, weight "
                         f"{qt.shape}, group {g})")
    if len(qt.planes) > 3 or qt.scales.dtype not in (torch.float32,
                                                     torch.bfloat16):
        raise ValueError("K5 takes at most 3 planes and f32/bf16 scales")
    _cuda.check(qt.scales, "scales", qt.scales.dtype, (K // g, N))
    zeros = qt.zeros
    if zeros is not None:
        if zeros.dtype not in _ZKIND:
            raise ValueError(f"zeros must be uint8, bf16 or f32, got "
                             f"{zeros.dtype}")
        _cuda.check(zeros, "zeros", zeros.dtype, (K // g, N))
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bf16 or f32, got {out_dtype}")
    tensors = (x, *qt.planes, qt.scales) + (() if zeros is None
                                            else (zeros,))
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("x, planes, scales and zeros must be 16-byte "
                         "aligned")
    lut = lut_on(cfg, x.device) if vmode == V_LUT else None
    splits, kps = k5_splits(M, K, N)
    partial = torch.empty((splits, M, N) if splits > 1 else (1,),
                          dtype=torch.float32, device=x.device)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    planes = [_cuda.ptr(p) for p in qt.planes] + [None] * (3 - len(qt.planes))
    _cuda.QMM_GENERAL.call(
        "qmm_general", _cuda.ptr(x), *planes, _cuda.ptr(qt.scales),
        None if zeros is None else _cuda.ptr(zeros),
        None if lut is None else _cuda.ptr(lut), _cuda.ptr(partial),
        _cuda.ptr(out), M, K, N, g, pack_chunk(cfg, K), fmt, cfg.bits, vmode,
        int(qt.scales.dtype == torch.float32),
        _ZKIND[None if zeros is None else zeros.dtype], zconst,
        int(cfg.kind == "fp8_e5m2"), int(out_dtype == torch.float32), splits,
        kps, _cuda.stream_ptr(), branches=(k5_route(M),))
    return out


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def _pick_a8(M: int, K: int, N: int, qt: QTensor) -> Optional[int]:
    """The dot group ``gd`` of the int8-compute path, or None: the rule of
    the JAX package's ``_pick_a8`` (int kind, act_bits 8, M >= 256, gd =
    min(g, 512) a multiple of 128 dividing g and K, and an N tile that
    divides N)."""
    cfg = qt.cfg
    if cfg.kind != "int" or cfg.act_bits != 8 or cfg.bits < 2 or M < 256:
        return None
    g = qt.group_size
    gd = min(g, 512)
    if gd % 128 or g % gd or K % gd or N % 128:
        return None
    return gd


def route(M: int, K: int, N: int, qt: QTensor) -> str:
    """The kernel that takes ``[M, K] @ qt``, by the JAX package's rule
    (``ops/qmatmul.py qmatmul``): "K2" when the int8-activation rule picks
    it, "K1" for at-rest native codes (native-pack or int8 planes) at
    M <= 16, "K5" for everything else; and "plain" (:func:`qmm_plain`) for
    a shape that neither K1 nor K5 takes (N not a multiple of 16, as a
    vocab of 32001; K not a multiple of 32), where the JAX package falls
    back to ``qmatmul_native`` / ``qmatmul_xla``. The answer rests on the
    shapes and the weight alone, before any launch."""
    g = qt.group_size
    if _pick_a8(M, K, N, qt) is not None:
        return "K2"
    if is_native(qt) and k1_takes(M, K, N, g):
        return "K1"
    if k5_takes(K, N, g):
        return "K5"
    return "plain"


def qmm_plain(x: torch.Tensor, qt: QTensor,
              out_dtype: torch.dtype) -> torch.Tensor:
    """The route for shapes the kernels decline: the weight dequantized to
    bf16 (:func:`dequant_bf16`, K5's rounding), then one product with f32
    sums; the JAX package's ``qmatmul_native`` / ``qmatmul_xla`` fallback.
    On the card one ``torch.mm`` of the bf16 operands with ``out_dtype``
    f32 (aten::mm.dtype); on the CPU K5's plain version. Counted as the
    route ``qmm_plain``."""
    _cuda.ROUTES.count("qmm_plain")
    if x.device.type == "cpu":
        return qmm_general_plain(x, qt, out_dtype)
    _check_no_perm(qt)
    x2 = x.to(torch.bfloat16)
    return torch.mm(x2, dequant_bf16(qt),
                    out_dtype=torch.float32).to(out_dtype)


def gather_act_order(x2: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """x [M, K] in W's row order → ``x[:, perm]``, the stored (act-order)
    row order that the kernels read: one ``index_select``, as the JAX
    package's ``gathered`` is one XLA gather outside the kernels; ``perm``
    lives beside the weight on its device, so a CUDA-graph capture copies
    nothing from the host. Counted as the route ``act_order_gather``."""
    _cuda.ROUTES.count("act_order_gather")
    return x2.index_select(1, perm)


def _check_no_perm(qt: QTensor):
    if qt.perm is not None:
        raise ValueError("the kernels read the stored row order of an "
                         "act-order weight: gather x by its perm first "
                         "(qmatmul does)")


def qmatmul(x: torch.Tensor, qt: QTensor,
            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x [..., K] @ W_q`` → ``[..., N]``, through the kernel
    :func:`route` names; an act-order weight first gathers x
    (:func:`gather_act_order`)."""
    out_dtype = out_dtype or x.dtype
    cfg = qt.cfg
    *lead, K = x.shape
    if K != qt.K:
        raise ValueError(f"x has K={K}, weight is {qt.shape}")
    x2 = x.reshape(-1, K)
    if qt.perm is not None:
        x2 = gather_act_order(x2, qt.perm)
        qt = dataclasses.replace(qt, perm=None)
    M = x2.shape[0]
    kernel = route(M, K, qt.N, qt)
    if kernel == "K2":
        if not is_native(qt):
            raise ValueError(
                f"qmatmul({cfg.short_name()}) at M={M}: the int8-activation "
                "path reads weights at rest; convert the weight once with "
                "runtime.generate.params_to_native")
        out = qmm_a8(x2, qt.planes[0], qt.scales, qt.group_size,
                     _pick_a8(M, K, qt.N, qt), out_dtype, qt.zeros,
                     cfg.bits)
    elif kernel == "K1":
        out = qmm_native(x2, qt.planes[0], qt.scales, qt.zeros,
                         qt.group_size, cfg.bits, out_dtype)
    elif kernel == "K5":
        out = qmm_general(x2, qt, out_dtype)
    else:
        out = qmm_plain(x2, qt, out_dtype)
    return out.reshape(*lead, qt.N)
