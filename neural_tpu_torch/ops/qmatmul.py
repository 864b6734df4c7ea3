"""Quantized matmul: the K1 and K2 kernels, their plain versions, dispatch.

Port of ``neural_tpu/ops/qmatmul.py`` for the at-rest layout of the port:
int4 sym native-pack weights, a uint8 plane ``[K/2, N]`` of centered
nibbles with bf16 scales ``[G, N]``.

- **K1** :func:`qmm4_npack` (``csrc/qmm4_npack.cu``) replaces the TPU's
  ``_qmm4_kernel``: ``out = x @ (codes · s)`` for any M below 256, f32
  dequant and f32 accumulation, the group scale applied to each group's
  partial sum.
- **K2** :func:`qmm_a8` (``csrc/qmm_a8.cu``) replaces ``_qmm_a8_kernel``:
  x is quantized per row and per ``gd`` K-group to sym int8, each group is
  an int8·int8→int32 dot, folded as ``acc += d · (sa_g ⊗ sw_g)`` in f32.
  The TPU kernel quantizes x inside the kernel or in ``quantize_act_i8``
  depending on N; the two are bit-identical, so one port kernel serves both.

Each wrapper takes its plain PyTorch version only for CPU tensors; on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.qtensor import QTensor, native_fields, dequantize
from . import _cuda

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
        raise NotImplementedError("act-order weights are a later slice")
    x_i8, sa = quantize_act_i8(x2, gd)
    xd = x_i8.to(torch.float32).reshape(-1, K // gd, gd) * sa[:, :, None]
    out = xd.reshape(-1, K) @ dequantize(qt, torch.float32)
    return out.to(out_dtype).reshape(*lead, qt.N)


# ---------------------------------------------------------------------------
# K1: int4 native-pack GEMV / skinny GEMM (M < 256)
# ---------------------------------------------------------------------------


def qmm4_npack_plain(x: torch.Tensor, planes: torch.Tensor,
                     scales: torch.Tensor, group: int,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of K1, with its rounding: x rounded to bf16 then widened
    to f32, f32 codes, one f32 partial product per group, times the group's
    bf16 scale widened to f32, summed over groups."""
    M, K = x.shape
    N = planes.shape[1]
    G = K // group
    xf = x.to(torch.bfloat16).to(torch.float32).reshape(M, G, group)
    w = native_fields(planes, 4).to(torch.float32).reshape(G, group, N)
    part = torch.einsum("mgk,gkn->mgn", xf, w)
    return (part * scales.to(torch.float32)[None]).sum(dim=1).to(out_dtype)


QMM4_CTA_K = 512      # K values per CTA of the first pass (16 chunks of 32)


def qmm4_npack(x: torch.Tensor, planes: torch.Tensor, scales: torch.Tensor,
               group: int, out_dtype: torch.dtype) -> torch.Tensor:
    """K1: ``x [M, K] @ W`` for native-pack int4 sym ``W``, M < 256.
    Split over K into ``ceil(K/512)`` f32 partials that a second pass adds
    in a fixed order: no atomics, so reruns give identical outputs."""
    if x.device.type == "cpu":
        return qmm4_npack_plain(x, planes, scales, group, out_dtype)
    x = x.to(torch.bfloat16).contiguous()
    M, K = x.shape
    N = planes.shape[1]
    _cuda.check(x, "x", torch.bfloat16)
    _cuda.check(planes, "planes", torch.uint8, (K // 2, N))
    _cuda.check(scales, "scales", torch.bfloat16, (K // group, N))
    if not 1 <= M < 256:
        raise ValueError(f"qmm4_npack takes 1 <= M < 256, got M={M}")
    if K % 32 or group % 32 or K % group or N % 16:
        raise ValueError(f"qmm4_npack needs K, group % 32 == 0 and "
                         f"N % 16 == 0 (K={K}, group={group}, N={N})")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bf16 or f32, got {out_dtype}")
    if planes.data_ptr() % 16 or scales.data_ptr() % 16:
        raise ValueError("planes and scales must be 16-byte aligned")
    splits = -(-K // QMM4_CTA_K)
    partial = torch.empty((splits, M, N), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    _cuda.QMM4.call("qmm4_npack", _cuda.ptr(x), _cuda.ptr(planes),
                    _cuda.ptr(scales), _cuda.ptr(partial), _cuda.ptr(out),
                    M, K, N, group, int(out_dtype == torch.float32), splits,
                    _cuda.stream_ptr())
    return out


# ---------------------------------------------------------------------------
# K2: w4a8 GEMM (M >= 256)
# ---------------------------------------------------------------------------


def qmm_a8_plain(x: torch.Tensor, planes: torch.Tensor, scales: torch.Tensor,
                 group: int, gd: int, out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of K2: int8 codes of x, int4 codes of W, one integer
    dot per gd-group (exact in f32: |d| < 2^24), and the fold
    ``acc = acc + d * (sa_g * sw_g)`` in f32 in group order — the kernel's
    own order of operations."""
    M, K = x.shape
    N = planes.shape[1]
    xq, sa = quantize_act_i8(x, gd)
    w = native_fields(planes, 4).to(torch.float32)
    sw = scales.to(torch.float32)
    r = max(group // gd, 1)
    acc = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    for ga in range(K // gd):
        d = xq[:, ga * gd:(ga + 1) * gd].to(torch.float32) \
            @ w[ga * gd:(ga + 1) * gd]
        acc = acc + d * (sa[:, ga, None] * sw[ga // r][None, :])
    return acc.to(out_dtype)


def qmm_a8(x: torch.Tensor, planes: torch.Tensor, scales: torch.Tensor,
           group: int, gd: int, out_dtype: torch.dtype) -> torch.Tensor:
    """K2: int8-activation GEMM over native-pack int4 sym weights. Two
    launches: the activation quantization, then the int8 tensor-core GEMM
    with the per-group f32 fold."""
    if x.device.type == "cpu":
        return qmm_a8_plain(x, planes, scales, group, gd, out_dtype)
    M, K = x.shape
    N = planes.shape[1]
    _cuda.check(planes, "planes", torch.uint8, (K // 2, N))
    _cuda.check(scales, "scales", torch.bfloat16, (K // group, N))
    if gd % 128 or K % gd or group % gd or N % 128:
        raise ValueError(f"qmm_a8 needs gd % 128 == 0, K % gd == 0, "
                         f"group % gd == 0, N % 128 == 0 (K={K}, N={N}, "
                         f"group={group}, gd={gd})")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bf16 or f32, got {out_dtype}")
    xq, sa = act_quant_i8(x, gd)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    _cuda.QMM_A8.call("qmm_a8", _cuda.ptr(xq), _cuda.ptr(sa),
                      _cuda.ptr(planes), _cuda.ptr(scales), _cuda.ptr(out),
                      M, K, N, gd, group, int(out_dtype == torch.float32),
                      _cuda.stream_ptr())
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


def qmatmul(x: torch.Tensor, qt: QTensor,
            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x [..., K] @ W_q`` → ``[..., N]``.

    int4 sym native-pack only: K2 when the int8-activation rule picks it
    (M >= 256), else K1 for M < 256. Anything else raises: the general
    dequant kernel (act16 prefill, other widths, nf4/fp4/fp8), asymmetric
    and act-order weights come in later slices."""
    out_dtype = out_dtype or x.dtype
    cfg = qt.cfg
    if not (cfg.kind == "int" and cfg.bits == 4 and cfg.native_pack
            and cfg.sym and qt.zeros is None and qt.perm is None):
        raise NotImplementedError(
            f"qmatmul({cfg.short_name()}, native_pack={cfg.native_pack}): "
            "this slice runs int4 sym native-pack weights only")
    *lead, K = x.shape
    if K != qt.K:
        raise ValueError(f"x has K={K}, weight is {qt.shape}")
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    planes, scales = qt.planes[0], qt.scales
    gd = _pick_a8(M, K, qt.N, qt)
    if gd is not None:
        out = qmm_a8(x2, planes, scales, qt.group_size, gd, out_dtype)
    elif M < 256:
        out = qmm4_npack(x2, planes, scales, qt.group_size, out_dtype)
    else:
        raise NotImplementedError(
            f"qmatmul at M={M} without the int8-activation path runs the "
            "general dequant kernel (TPU _qmm_kernel), a later slice")
    return out.reshape(*lead, qt.N)
