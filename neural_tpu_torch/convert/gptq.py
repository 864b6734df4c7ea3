"""GPTQ / AWQ quantized-checkpoint import (port of
``neural_tpu/convert/gptq.py``).

The unpacked weights repack losslessly into QTensors: act-order becomes the
QTensor ``perm`` (x is gathered by it before each product), zeros become
per-group uint8 zero-points. Every unpack here is integer shift/mask on
torch tensors, so a checkpoint converts on whatever device its tensors are
moved to (``device``), the card by default, a 7B in seconds.

Conventions:
- GPTQ (AutoGPTQ v1): qweight int32 [K/(32/bits), N], codes along K,
  LSB first; qzeros int32 [G, N/(32/bits)], codes along N, stored as z - 1
  (``zero_plus_one``); scales [G, N] f16; an optional g_idx [K] for
  act-order. 2, 3, 4 and 8 bits; 3-bit in the straddled layout or ten a
  word.
- AWQ (GEMM kernels): qweight int32 [K, N/8], nibbles along N in the
  interleaved order (0, 2, 4, 6, 1, 3, 5, 7); qzeros [G, N/8] the same
  way, no +1; scales [G, N]. 4-bit only.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtypes import QuantConfig
from ..core.qtensor import QTensor, pack_codes

AWQ_ORDER = np.array([0, 2, 4, 6, 1, 3, 5, 7])


def _t(x, device=None) -> torch.Tensor:
    """numpy or torch → a torch tensor (on ``device`` when given)."""
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x)
    return t if device is None else t.to(device)


def _spread(v: torch.Tensor, axis: int) -> torch.Tensor:
    """[..., per] codes of each word, the words' array along ``axis`` → the
    codes laid out along ``axis`` (per codes in place of each word)."""
    nd = v.dim() - 1
    axis = axis % nd
    v = v.movedim(-1, axis + 1)
    shape = list(v.shape[:axis]) + [v.shape[axis] * v.shape[axis + 1]] \
        + list(v.shape[axis + 2:])
    return v.reshape(shape)


def unpack_int32_nibbles(x, axis: int,
                         order: Optional[np.ndarray] = None) -> torch.Tensor:
    """int32 words → uint8 nibbles expanded 8x along ``axis`` (LSB first,
    optionally permuted by ``order``)."""
    x = _t(x).to(torch.int32)
    shifts = np.arange(8) * 4
    if order is not None:
        shifts = shifts[np.argsort(order)]  # logical position j ← nibble
    sh = torch.as_tensor(shifts, dtype=torch.int32, device=x.device)
    nib = (x[..., None] >> sh) & 0xF
    return _spread(nib, axis).to(torch.uint8)


def unpack_int32_fields(x, bits: int, axis: int, fmt3: str = "straddle",
                        out_len: Optional[int] = None) -> torch.Tensor:
    """GPTQ word unpack for bits in {2, 3, 4, 8}: int32 words → uint8 codes
    expanded along ``axis``, LSB first. 2/4/8-bit words hold 32 // bits
    codes. 3-bit has two layouts: ``"straddle"``, AutoGPTQ's pack(), 32
    codes per 3 words, codes 10 and 21 split across word boundaries; and
    ``"tenper"``, 10 codes a word with the top 2 bits unused, the unpacked
    run cut to ``out_len`` real codes."""
    x = _t(x).to(torch.int32)
    if bits in (2, 4, 8):
        per = 32 // bits
        sh = torch.arange(per, dtype=torch.int32, device=x.device) * bits
        v = (x[..., None] >> sh) & ((1 << bits) - 1)
        return _spread(v, axis).to(torch.uint8)
    if bits != 3:
        raise ValueError(f"GPTQ words hold 2, 3, 4 or 8-bit codes, not {bits}")
    x = x.movedim(axis, 0)
    if fmt3 == "tenper":
        sh = torch.arange(10, dtype=torch.int32, device=x.device) * 3
        out = ((x[..., None] >> sh) & 7).movedim(-1, 1)
        out = out.reshape(x.shape[0] * 10, *x.shape[1:])
        if out_len is not None:
            out = out[:out_len]
        return out.to(torch.uint8).movedim(0, axis)
    if x.shape[0] % 3:
        raise ValueError(f"straddled 3-bit words come in threes: {x.shape}")
    w = x.reshape(x.shape[0] // 3, 3, *x.shape[1:])
    w0, w1, w2 = w[:, 0], w[:, 1], w[:, 2]
    sh = torch.arange(10, dtype=torch.int32, device=x.device) * 3
    parts = [((w0[..., None] >> sh) & 7).movedim(-1, 1),
             (((w0 >> 30) & 3) | ((w1 & 1) << 2))[:, None],
             ((w1[..., None] >> (sh + 1)) & 7).movedim(-1, 1),
             (((w1 >> 31) & 1) | ((w2 & 3) << 1))[:, None],
             ((w2[..., None] >> (sh + 2)) & 7).movedim(-1, 1)]
    out = torch.cat(parts, dim=1).reshape(w.shape[0] * 32, *x.shape[1:])
    return out.to(torch.uint8).movedim(0, axis)


def _sniff_fmt3(qzeros, N: int) -> str:
    """The 3-bit layout from the zeros' packed width along N (N from the
    scales): ten a word → ceil(N/10) words; straddled → N*3/32 words."""
    width = qzeros.shape[1]
    if width == -(-N // 10):
        return "tenper"
    if width * 32 == N * 3:
        return "straddle"
    raise ValueError(
        f"unrecognized 3-bit qzeros width {width} for N={N} "
        f"(expected {-(-N // 10)} ten-per-word or {N * 3 // 32} straddled)")


def gptq_layer_to_qtensor(qweight, qzeros, scales, g_idx=None,
                          bits: int = 4, zero_plus_one: bool = True,
                          fmt: str = "gptq",
                          group_size: Optional[int] = None,
                          device=None) -> QTensor:
    """One quantized linear → QTensor ([K, N], groups along K, asym, f32
    scales, uint8 zero-points), its tensors on ``device`` (where the
    inputs are, by default). An act-order g_idx becomes ``perm``, the
    stable sort of g_idx, with the rows stored as W[perm]."""
    qweight, qzeros, scales = (_t(a, device) for a in (qweight, qzeros,
                                                        scales))
    if fmt == "gptq":
        if bits not in (2, 3, 4, 8):
            raise ValueError(f"GPTQ bits must be 2, 3, 4 or 8, not {bits}")
        G_, N_ = scales.shape
        fmt3 = _sniff_fmt3(qzeros, N_) if bits == 3 else "straddle"
        if bits == 3 and fmt3 == "tenper":
            # the real K strips the word-pad rows: from g_idx when given,
            # else group_size * n_groups
            if g_idx is not None:
                K_ = len(g_idx)
            elif group_size is not None and group_size > 0:
                K_ = G_ * group_size
            else:
                raise ValueError(
                    "ten-per-word 3-bit import needs g_idx or a positive "
                    "group_size to determine K (the packed rows carry pad "
                    f"values; got group_size={group_size!r})")
            codes = unpack_int32_fields(qweight, 3, 0, fmt3, out_len=K_)
            zeros = unpack_int32_fields(qzeros, 3, 1, fmt3, out_len=N_)
        else:
            codes = unpack_int32_fields(qweight, bits, axis=0)   # [K, N]
            zeros = unpack_int32_fields(qzeros, bits, axis=1)    # [G, N]
    elif fmt == "awq":
        if bits != 4:
            raise ValueError("AWQ GEMM checkpoints are 4-bit")
        codes = unpack_int32_nibbles(qweight, axis=1, order=AWQ_ORDER)
        zeros = unpack_int32_nibbles(qzeros, axis=1, order=AWQ_ORDER)
    else:
        raise ValueError(fmt)
    if zero_plus_one:
        zeros = (zeros.to(torch.int32) + 1).to(torch.uint8)
    K, N = codes.shape
    G = scales.shape[0]
    g = K // G

    perm = None
    if g_idx is not None:
        g_idx = _t(g_idx, codes.device).to(torch.int64)
        groups = torch.arange(K, device=codes.device) // g
        if not torch.equal(g_idx, groups):
            # act-order: rows sorted so that groups are contiguous
            perm = torch.argsort(g_idx, stable=True)
            codes = codes[perm]
            if not torch.equal(g_idx[perm], groups):
                raise ValueError("g_idx groups are not uniformly sized")
            perm = perm.to(torch.int32)

    cfg = QuantConfig(bits=bits, kind="int", group_size=g, sym=False)
    return QTensor(pack_codes(codes, bits, g), scales.to(torch.float32),
                   zeros, perm, cfg)


def gptq_reference_dequant(qweight, qzeros, scales, g_idx=None, bits=4,
                           zero_plus_one=True, fmt="gptq") -> np.ndarray:
    """The published GPTQ formula, w[k, n] = (q[k, n] - z[g(k), n]) ·
    s[g(k), n], in numpy f32: a test oracle independent of the QTensor
    path."""
    if fmt == "gptq":
        codes = unpack_int32_fields(qweight, bits, axis=0).numpy()
        zeros = unpack_int32_fields(qzeros, bits, axis=1).numpy()
    else:
        codes = unpack_int32_nibbles(qweight, 1, AWQ_ORDER).numpy()
        zeros = unpack_int32_nibbles(qzeros, 1, AWQ_ORDER).numpy()
    if zero_plus_one:
        zeros = zeros.astype(np.int32) + 1
    scales = np.asarray(scales)
    K, N = codes.shape
    g = K // scales.shape[0]
    gk = np.asarray(g_idx) if g_idx is not None else np.arange(K) // g
    return ((codes.astype(np.float32) - zeros[gk].astype(np.float32))
            * scales[gk].astype(np.float32))


def permute_cols(qt: QTensor, p: torch.Tensor) -> QTensor:
    """Reorder a QTensor's output columns (N): planes are packed along K
    only, so a column take on planes, scales and zeros is exact."""
    p = p.long().to(qt.scales.device)
    zeros = None if qt.zeros is None else qt.zeros[..., p]
    return QTensor(tuple(pl[..., p] for pl in qt.planes), qt.scales[..., p],
                   zeros, qt.perm, qt.cfg)


def qtensor_state_dict(sd: Dict[str, Any], fmt: str = "gptq", bits: int = 4,
                       zero_plus_one: Optional[bool] = None,
                       group_size: Optional[int] = None,
                       device=None) -> Dict[str, Any]:
    """Every quantized linear's ``<base>.qweight`` / ``qzeros`` / ``scales``
    / ``g_idx`` collapses to ONE QTensor at ``<base>.weight`` (the [K, N]
    orientation: GPTQ packs along the in-features), converted on
    ``device``; everything else (norms, biases, embeddings, an fp lm_head)
    passes through as it is. The result feeds the family's ordinary tensor
    maps (``convert.hf.build_param_dict``)."""
    if zero_plus_one is None:
        zero_plus_one = fmt == "gptq"
    bases = {k[: -len(".qweight")] for k in sd if k.endswith(".qweight")}
    out: Dict[str, Any] = {}
    for k, v in sd.items():
        base, _, leaf = k.rpartition(".")
        if leaf == "qweight":
            out[base + ".weight"] = gptq_layer_to_qtensor(
                sd[base + ".qweight"], sd[base + ".qzeros"],
                sd[base + ".scales"], sd.get(base + ".g_idx"), bits=bits,
                zero_plus_one=zero_plus_one, fmt=fmt, group_size=group_size,
                device=device)
        elif base in bases and leaf in ("qzeros", "scales", "g_idx"):
            continue
        else:
            out[k] = v
    return out


def _take(b, p: torch.Tensor):
    """A bias (numpy or torch) with its entries reordered by ``p``."""
    if isinstance(b, torch.Tensor):
        return b[p.long().to(b.device)]
    return np.asarray(b)[p.cpu().numpy()]


def _fold_act_order_sd(qsd: Dict[str, Any], cfg, mod) -> None:
    """Per layer, fold w_down's stored-row permutation into the output
    columns of gate and up (and their biases), in place: exact, because the
    elementwise act(gate)·up between them commutes with any column
    permutation; w_down then needs no gather. A mixture-of-experts layer
    folds each expert's w_down into that expert's gate and up."""
    for i in range(cfg.n_layers):
        m = mod.hf_layer_map(i, cfg)
        groups = [("w_down", "w_gate", "w_up", "b_gate", "b_up")]
        if cfg.is_moe:
            groups = [(f"experts.{e}.w_down", f"experts.{e}.w_gate",
                       f"experts.{e}.w_up", None, None)
                      for e in range(cfg.n_experts)]
        for nd, ng, nu, nbg, nbu in groups:
            ed, eg, eu = m.get(nd), m.get(ng), m.get(nu)
            if not (ed and eg and eu):
                continue
            wd, wg, wu = (qsd.get(e[0]) for e in (ed, eg, eu))
            if not all(isinstance(w, QTensor) for w in (wd, wg, wu)) \
                    or wd.perm is None:
                continue
            p = wd.perm
            qsd[eg[0]] = permute_cols(wg, p)
            qsd[eu[0]] = permute_cols(wu, p)
            qsd[ed[0]] = QTensor(wd.planes, wd.scales, wd.zeros, None,
                                 wd.cfg)
            for nb in (nbg, nbu):
                eb = m.get(nb) if nb else None
                if eb and eb[0] in qsd:
                    qsd[eb[0]] = _take(qsd[eb[0]], p)


def params_from_gptq_state_dict(sd: Dict[str, Any], cfg, fmt: str = "gptq",
                                bits: int = 4,
                                zero_plus_one: Optional[bool] = None,
                                dtype: torch.dtype = torch.bfloat16,
                                group_size: Optional[int] = None,
                                arch_mod=None, device=None):
    """A GPTQ/AWQ HF state dict (numpy or torch values) → the port's
    decoder, on ``device`` (the card unless ``device="cpu"``). The
    quartets become QTensors, w_down's act-order perm folds into gate/up,
    the unquantized tensors take the ordinary family maps, and, when any
    projection is act-order, q/k/v and gate/up are fused
    (``fuse_layer_weights``) so that each fused product pays one gather:
    three a layer (wqkv, wo, w_gateup) on a Llama-family decode."""
    from ..models import llama as llama_mod
    from ..models.transformer import Transformer
    from ..runtime.generate import fuse_layer_weights, params_to_native
    from .hf import ARCH_MODULES, build_param_dict
    mod = arch_mod or ARCH_MODULES.get(cfg.arch, llama_mod)
    dev = resolve_device(device)
    qsd = qtensor_state_dict(sd, fmt, bits, zero_plus_one, group_size, dev)
    if hasattr(mod, "preprocess_state_dict"):
        qsd = mod.preprocess_state_dict(dict(qsd), cfg)
    _fold_act_order_sd(qsd, cfg, mod)
    params = build_param_dict(qsd, cfg, mod, quant=None, dtype=dtype,
                              device=dev)
    if any(isinstance(v, QTensor) and v.perm is not None
           for lp in params["layers"] for v in lp.values()):
        params = fuse_layer_weights(params, cfg)
    return Transformer(cfg, params_to_native(params))
