"""GGUF checkpoint ↔ the port's decoder, llama-family tensor map (port of
``neural_tpu/convert/gguf_models.py``).

Reference: the NE/GGUF loader path (model_files.h:246 gguf_loader →
per-arch tensor maps in <arch>_utils.cpp) and the HF→GGUF converter
(convert/convert-hf-to-gguf.py).

Loading moves each tensor's raw block bytes from the file's mmap to the
target device and unpacks them there with integer shift/mask
(:func:`unpack_blocks`, the torch twin of ``GGUFReader.unpack_quantized``),
straight into the at-rest layout the kernels read: native-pack nibbles or
2-bit fields for 2-4 bit codes, int8 code planes for 5-8 bit, bf16 scales
and zero-points shifted like the codes. The asymmetric types' additive
mins become float zero-points ``-m/d`` first, as in the JAX package, so
the result equals, field for field, the JAX ``load_gguf`` followed by the
port's ``params_to_native`` (``tests/test_torch_gguf.py
test_load_gguf_equals_jax_at_rest``, every ggml type, a constant group
included). No GGUF tensor is padded: Llama-2-7B's FFN stays 11008 wide.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Optional, Tuple

import torch

from ..core.device import resolve_device
from ..core.dtypes import QuantConfig
from ..core.qtensor import QTensor, pack_codes
from ..models import llama as llama_mod
from ..models.config import ModelConfig
from ..models.transformer import Transformer
from .gguf import (GGUFReader, GGUFWriter, GGML_BF16, GGML_F16, GGML_F32,
                   GGML_I32, GGML_Q2_K, GGML_Q3_K, GGML_Q4_0, GGML_Q4_1,
                   GGML_Q4_K, GGML_Q5_0, GGML_Q5_1, GGML_Q5_K, GGML_Q6_K,
                   GGML_Q8_0, QK, _BLOCK_BYTES, _BLOCK_ELEMS)
from .hf import _add_aux

_QUANT_TYPES = {GGML_Q4_0, GGML_Q4_1, GGML_Q5_0, GGML_Q5_1, GGML_Q8_0,
                GGML_Q2_K, GGML_Q3_K, GGML_Q4_K, GGML_Q5_K, GGML_Q6_K}
BITS = {GGML_Q4_0: 4, GGML_Q4_1: 4, GGML_Q5_0: 5, GGML_Q5_1: 5,
        GGML_Q8_0: 8, GGML_Q2_K: 2, GGML_Q3_K: 3, GGML_Q4_K: 4,
        GGML_Q5_K: 5, GGML_Q6_K: 6}

# our param name → gguf tensor name (llama family)
_LAYER_MAP = {
    "attn_norm_w": "blk.{i}.attn_norm.weight",
    "wq": "blk.{i}.attn_q.weight",
    "wk": "blk.{i}.attn_k.weight",
    "wv": "blk.{i}.attn_v.weight",
    "wo": "blk.{i}.attn_output.weight",
    "ffn_norm_w": "blk.{i}.ffn_norm.weight",
    "w_gate": "blk.{i}.ffn_gate.weight",
    "w_up": "blk.{i}.ffn_up.weight",
    "w_down": "blk.{i}.ffn_down.weight",
}
_TOP_MAP = {
    "embed": "token_embd.weight",
    "final_norm_w": "output_norm.weight",
    "lm_head": "output.weight",
}


# GGUF files of either package hold no experts: the JAX tensor map
# (neural_tpu/convert/gguf_models.py) has no ``*_exps`` tensors (ROADMAP §C)
GGUF_NO_EXPERTS = ("GGUF export of a mixture-of-experts model: the GGUF "
                   "tensor map of the JAX package, the port's reference, "
                   "has no expert tensors (*_exps); use an NTPU checkpoint")


def config_from_gguf(r: GGUFReader) -> ModelConfig:
    kv = r.kv
    arch = kv.get("general.architecture", "llama")
    p = arch  # key prefix
    D = int(kv[f"{p}.embedding_length"])
    H = int(kv[f"{p}.attention.head_count"])
    n_kv = int(kv.get(f"{p}.attention.head_count_kv", H))
    n_vocab = r.tensors["token_embd.weight"].shape[0]
    return ModelConfig(
        arch="llama" if arch in ("llama", "mistral") else arch,
        vocab_size=int(n_vocab), hidden_size=D,
        n_layers=int(kv[f"{p}.block_count"]),
        n_heads=H, n_kv_heads=n_kv, head_dim=D // H,
        intermediate_size=int(kv[f"{p}.feed_forward_length"]),
        norm_eps=float(kv.get(
            f"{p}.attention.layer_norm_rms_epsilon", 1e-5)),
        rope_theta=float(kv.get(f"{p}.rope.freq_base", 10000.0)),
        max_seq_len=int(kv.get(f"{p}.context_length", 4096)),
        bos_token_id=int(kv.get("tokenizer.ggml.bos_token_id", 1)),
        eos_token_id=int(kv.get("tokenizer.ggml.eos_token_id", 2)),
    )


def block_bytes(r: GGUFReader, name: str, device) -> torch.Tensor:
    """A tensor's raw data as uint8 on ``device``: block rows [nb, bytes a
    block] for the quantized types, a flat row otherwise. The copy leaves
    no view of the mmap behind, so the reader can close."""
    t = r.tensors[name]
    with warnings.catch_warnings():     # the mmap is read-only; we copy
        warnings.simplefilter("ignore", UserWarning)
        raw = torch.frombuffer(r.tensor_bytes(t), dtype=torch.uint8)
    out = raw.to(device, copy=True)
    del raw
    if t.ggml_type in _BLOCK_BYTES:
        return out.reshape(-1, _BLOCK_BYTES[t.ggml_type])
    return out


def _unpack_scmin_k4(s: torch.Tensor):
    """12 packed bytes → 8 six-bit scales and 8 six-bit mins per block
    (``gguf._unpack_scmin_k4`` on torch): [nb, 12] → ([nb, 8], [nb, 8])
    int32."""
    s = s.to(torch.int32)
    sc = torch.cat([s[:, 0:4] & 63,
                    (s[:, 8:12] & 0xF) | ((s[:, 0:4] >> 6) << 4)], 1)
    mn = torch.cat([s[:, 4:8] & 63,
                    (s[:, 8:12] >> 4) | ((s[:, 4:8] >> 6) << 4)], 1)
    return sc, mn


def unpack_blocks(blk: torch.Tensor, tt: int):
    """``GGUFReader.unpack_quantized`` on the block bytes ``blk`` [nb,
    bytes a block] (uint8, any device) → (codes int32 [n], scales [n/g],
    mins [n/g] or None, g), ``w = codes * scales (+ mins)``. Codes are
    centered for the symmetric types. The legacy types' scales and mins
    are f32; the K-quants' are f64, numpy's type for their f32 super-scale
    times an int32 sub-scale, which the JAX package then divides in."""
    nb = blk.shape[0]
    dev = blk.device
    b32 = blk.to(torch.int32)

    def fp16(col):
        return blk[:, col:col + 2].contiguous().view(torch.float16)[:, 0] \
            .to(torch.float32)

    def nibbles(q):
        return torch.cat([q & 0xF, q >> 4], 1)

    if tt == GGML_Q4_0:
        return (nibbles(b32[:, 2:18]) - 8).reshape(-1), fp16(0), None, QK
    if tt == GGML_Q4_1:
        return nibbles(b32[:, 4:20]).reshape(-1), fp16(0), fp16(2), QK
    if tt in (GGML_Q5_0, GGML_Q5_1):
        off = 2 if tt == GGML_Q5_0 else 4
        qh = blk[:, off:off + 4].contiguous().view(torch.int32)
        hibits = (qh >> torch.arange(32, device=dev)[None, :]) & 1
        codes = nibbles(b32[:, off + 4:off + 20]) | (hibits << 4)
        if tt == GGML_Q5_0:
            return (codes - 16).reshape(-1), fp16(0), None, QK
        return codes.reshape(-1), fp16(0), fp16(2), QK
    if tt == GGML_Q8_0:
        codes = blk[:, 2:34].contiguous().view(torch.int8).to(torch.int32)
        return codes.reshape(-1), fp16(0), None, QK
    sh = (2 * torch.arange(4, device=dev))[None, None, :, None]
    if tt == GGML_Q2_K:
        sc = b32[:, :16]
        qs = b32[:, 16:80].reshape(nb, 2, 32)
        d, dmin = fp16(80).double(), fp16(82).double()
        codes = ((qs[:, :, None, :] >> sh) & 3).reshape(-1)
        scales = (d[:, None] * (sc & 0xF)).reshape(-1)
        mins = (-dmin[:, None] * (sc >> 4)).reshape(-1)
        return codes, scales, mins, 16
    if tt == GGML_Q3_K:
        hm = b32[:, :32]
        qs = b32[:, 32:96].reshape(nb, 2, 32)
        sb = b32[:, 96:108]
        d = fp16(108).double()
        low = (qs[:, :, None, :] >> sh) & 3                   # [nb,2,4,32]
        bit = (4 * torch.arange(2, device=dev)[:, None, None]
               + torch.arange(4, device=dev)[None, :, None])  # [2,4,1]
        h = (hm[:, None, None, :] >> bit[None]) & 1
        codes = (low - torch.where(h != 0, 0, 4)).reshape(-1)
        sc = torch.cat([
            (sb[:, 0:4] & 0xF) | ((sb[:, 8:12] & 3) << 4),
            (sb[:, 4:8] & 0xF) | (((sb[:, 8:12] >> 2) & 3) << 4),
            (sb[:, 0:4] >> 4) | (((sb[:, 8:12] >> 4) & 3) << 4),
            (sb[:, 4:8] >> 4) | (((sb[:, 8:12] >> 6) & 3) << 4)], 1)
        return codes, (d[:, None] * (sc - 32)).reshape(-1), None, 16
    if tt in (GGML_Q4_K, GGML_Q5_K):
        d, dmin = fp16(0).double(), fp16(2).double()
        sc6, mn6 = _unpack_scmin_k4(blk[:, 4:16])
        off = 16 if tt == GGML_Q4_K else 48
        qs = b32[:, off:off + 128].reshape(nb, 4, 32)
        lo, hi = qs & 0xF, qs >> 4
        if tt == GGML_Q5_K:
            qh = b32[:, 16:48]
            c = torch.arange(4, device=dev)
            lo = lo + 16 * ((qh[:, None, :] >> (2 * c)[None, :, None]) & 1)
            hi = hi + 16 * ((qh[:, None, :] >> (2 * c + 1)[None, :, None])
                            & 1)
        codes = torch.stack([lo, hi], dim=2).reshape(-1)
        return (codes, (d[:, None] * sc6).reshape(-1),
                (-dmin[:, None] * mn6).reshape(-1), QK)
    if tt == GGML_Q6_K:
        ql = b32[:, :128].reshape(nb, 2, 64)
        qh = b32[:, 128:192].reshape(nb, 2, 32)
        sc = blk[:, 192:208].contiguous().view(torch.int8).to(torch.int32)
        d = fp16(208).double()
        q1 = (ql[:, :, 0:32] & 0xF) | ((qh & 3) << 4)
        q2 = (ql[:, :, 32:64] & 0xF) | (((qh >> 2) & 3) << 4)
        q3 = (ql[:, :, 0:32] >> 4) | (((qh >> 4) & 3) << 4)
        q4 = (ql[:, :, 32:64] >> 4) | (((qh >> 6) & 3) << 4)
        codes = torch.stack([q1, q2, q3, q4], dim=2).reshape(-1) - 32
        return codes, (d[:, None] * sc).reshape(-1), None, 16
    raise ValueError(f"unsupported ggml type {tt}")


def _at_rest(centered: torch.Tensor, scales, zeros, cfg: QuantConfig
             ) -> QTensor:
    """Centered codes int32 [K, N] (``code - 2^(bits-1)``), f32 scales and
    zero-points [G, N] → the at-rest QTensor of ``core.qtensor.to_native``:
    native-pack for 2-4 bits, an int8 plane for 5-8."""
    shift = 1 << (cfg.bits - 1)
    z = None if zeros is None else (zeros - shift).to(torch.bfloat16)
    s = scales.to(torch.bfloat16)
    if cfg.bits > 4:
        return QTensor((centered.to(torch.int8),), s, z, None, cfg)
    if cfg.bits == 2:
        f = centered & 0x3
        plane = f[0::4] | (f[1::4] << 2) | (f[2::4] << 4) | (f[3::4] << 6)
    else:
        nib = centered & 0xF
        plane = nib[0::2] | (nib[1::2] << 4)
    return QTensor((plane.to(torch.uint8),), s, z, None,
                   dataclasses.replace(cfg, native_pack=True))


def qtensor_from_gguf(r: GGUFReader, name: str, device,
                      at_rest: bool = True) -> QTensor:
    """A ggml-quantized [out, in] tensor → its at-rest QTensor ([K=in,
    N=out], groups along K), unpacked on ``device``; with ``at_rest``
    False, the JAX package's ``_qtensor_from_gguf`` itself (bit-plane
    packed codes, f32 scales and zero-points), for requantization. The
    JAX ``_qtensor_from_gguf`` then ``to_native``: the codes of a symmetric
    type are stored shifted by 2^(bits-1) and centered again at rest;
    an asymmetric type's ``w = q·d + m`` becomes ``(q - (-m/d))·d``, a
    float zero-point, with the stand-in scale 1e-10 where ``d == 0`` (a
    constant group, which ``(q - z)·1e-10`` still reproduces)."""
    t = r.tensors[name]
    out_f, in_f = t.shape
    tt = t.ggml_type
    codes, d, m, g = unpack_blocks(block_bytes(r, name, device), tt)
    bits = BITS[tt]
    sym = m is None
    centered = codes.reshape(out_f, in_f).T.contiguous()
    if not sym:
        centered = centered - (1 << (bits - 1))
    G = in_f // g
    zeros = None
    if not sym:
        # the stand-in scale takes d's dtype (f32, or the K-quants' f64),
        # as numpy's ``where`` does
        d = torch.where(d == 0, d.new_tensor(1e-10), d)
        zeros = (-m / d).to(torch.float32).reshape(out_f, G).T.contiguous()
    scales = d.to(torch.float32).reshape(out_f, G).T.contiguous()
    cfg = QuantConfig(bits=bits, kind="int", group_size=g, sym=sym)
    if not at_rest:
        ucodes = centered + (1 << (bits - 1))
        return QTensor(pack_codes(ucodes, bits, g), scales, zeros, None, cfg)
    return _at_rest(centered, scales, zeros, cfg)


def dequantize_on(r: GGUFReader, name: str, device) -> torch.Tensor:
    """``GGUFReader.dequantize`` on ``device``: f32 in the file's numpy
    order (row-major [out, in]). A quantized type's ``codes·d (+ m)`` is
    taken in the dtype of its scales (f64 for the K-quants, as numpy
    promotes them) and rounded to f32 once."""
    t = r.tensors[name]
    tt = t.ggml_type
    raw = block_bytes(r, name, device)
    if tt == GGML_F32:
        return raw.view(torch.float32).reshape(t.shape)
    if tt == GGML_F16:
        return raw.view(torch.float16).to(torch.float32).reshape(t.shape)
    if tt == GGML_BF16:
        return raw.view(torch.bfloat16).to(torch.float32).reshape(t.shape)
    if tt == GGML_I32:
        return raw.view(torch.int32).reshape(t.shape)
    codes, d, m, g = unpack_blocks(raw, tt)
    w = codes.to(torch.float32).to(d.dtype) * torch.repeat_interleave(d, g)
    if m is not None:
        w = w + torch.repeat_interleave(m, g)
    return w.to(torch.float32).reshape(t.shape)


def load_gguf_params(path: str, dtype: torch.dtype = torch.bfloat16,
                     device=None, at_rest: bool = True
                     ) -> Tuple[Dict[str, Any], ModelConfig]:
    """GGUF file → (param dict at rest, its ``layers`` a list of per-layer
    dicts; cfg), every tensor unpacked on ``device`` (the card unless
    ``device="cpu"``); ``at_rest`` False keeps the QTensors in the JAX
    package's loaded layout (:func:`qtensor_from_gguf`). Quantized
    projections and lm_head stay quantized;
    the embedding is dequantized to ``dtype``, 2-D float projections go to
    ``dtype`` in [K, N], and norm weights to f32, as the JAX ``load_gguf``
    stores them. A file without ``output.weight`` ties the lm_head to the
    embedding."""
    dev = resolve_device(device)
    r = GGUFReader(path)
    try:
        cfg = config_from_gguf(r)

        def get(name, quantizable):
            t = r.tensors[name]
            if quantizable and t.ggml_type in _QUANT_TYPES:
                return qtensor_from_gguf(r, name, dev, at_rest)
            w = dequantize_on(r, name, dev)
            if w.ndim == 2:
                return w.T.contiguous().to(dtype)   # [out, in] → [K, N]
            return w.to(torch.float32)

        layers = [{ours: get(tmpl.format(i=i), ours.startswith("w"))
                   for ours, tmpl in _LAYER_MAP.items()}
                  for i in range(cfg.n_layers)]
        params: Dict[str, Any] = {
            "layers": layers,
            "embed": dequantize_on(r, "token_embd.weight", dev).to(dtype),
            "final_norm_w": dequantize_on(r, "output_norm.weight", dev)}
        if "output.weight" in r.tensors:
            params["lm_head"] = get("output.weight", quantizable=True)
        else:
            cfg = dataclasses.replace(cfg, tie_word_embeddings=True)
        _add_aux(params, cfg, dev)
    finally:
        r.close()
    return params, cfg


def load_gguf(path: str, dtype: torch.dtype = torch.bfloat16,
              device=None) -> Tuple[Transformer, ModelConfig]:
    """GGUF file → (Transformer, cfg), unpacked on ``device``
    (:func:`load_gguf_params`)."""
    params, cfg = load_gguf_params(path, dtype, device)
    return Transformer(cfg, params), cfg


def export_gguf(hf_model, path: str, ggml_type: int = GGML_Q4_0,
                tokenizer=None, extra_kv=None):
    """An HF llama-family model → GGUF file (reference converter path:
    convert_llama.py). Only ``hf_model.config`` (read as attributes) and
    ``hf_model.state_dict()`` are used, so no transformers import is
    needed. Norms and the embedding write as F32, the projections and the
    lm_head as ``ggml_type``. ``tokenizer``: an HF-style tokenizer whose
    vocab (+ BPE merges when present, or SPM scores) is embedded as
    tokenizer.ggml.* kvs, as the reference converters do; ``extra_kv``:
    additional raw kvs. The file is byte for byte the JAX
    ``export_gguf``'s."""
    cfg = llama_mod.config_from_hf(hf_model.config)
    if cfg.is_moe:
        raise NotImplementedError(GGUF_NO_EXPERTS)
    sd = {k: v.detach().float().cpu().numpy()
          for k, v in hf_model.state_dict().items()}

    w = GGUFWriter(path)
    if tokenizer is not None:
        vocab = tokenizer.get_vocab()
        tokens = [""] * (max(vocab.values()) + 1)
        for t, i in vocab.items():
            tokens[i] = t
        w.add_kv("tokenizer.ggml.tokens", tokens)
        ranks = getattr(tokenizer, "bpe_ranks", None)
        if ranks:   # byte-level BPE (slow GPT2-family tokenizer)
            w.add_kv("tokenizer.ggml.model", "gpt2")
            w.add_kv("tokenizer.ggml.merges",
                     [f"{a} {b}" for (a, b), _ in
                      sorted(ranks.items(), key=lambda kv: kv[1])])
        else:       # SPM-style: per-token scores if available
            w.add_kv("tokenizer.ggml.model", "llama")
            sp = getattr(tokenizer, "sp_model", None)
            if sp is not None:
                w.add_kv("tokenizer.ggml.scores",
                         [float(sp.get_score(i)) for i in range(len(tokens))])
    for k, v in (extra_kv or {}).items():
        w.add_kv(k, v)
    w.add_kv("general.architecture", "llama")
    w.add_kv("general.name", "neural-tpu-export")
    w.add_kv("llama.embedding_length", cfg.hidden_size)
    w.add_kv("llama.block_count", cfg.n_layers)
    w.add_kv("llama.attention.head_count", cfg.n_heads)
    w.add_kv("llama.attention.head_count_kv", cfg.n_kv_heads)
    w.add_kv("llama.feed_forward_length", cfg.intermediate_size)
    w.add_kv("llama.context_length", cfg.max_seq_len)
    w.add_kv("llama.rope.freq_base", float(cfg.rope_theta))
    w.add_kv("llama.attention.layer_norm_rms_epsilon", float(cfg.norm_eps))
    w.add_kv("tokenizer.ggml.bos_token_id", cfg.bos_token_id)
    w.add_kv("tokenizer.ggml.eos_token_id", cfg.eos_token_id)

    for ours, (hf_name, _) in llama_mod.hf_top_map(cfg).items():
        arr = sd[hf_name]               # HF stores [out, in], as gguf does
        ttype = GGML_F32 if arr.ndim == 1 or ours != "lm_head" \
            else ggml_type
        w.add_tensor(_TOP_MAP[ours], arr, ttype)
    for i in range(cfg.n_layers):
        for ours, (hf_name, _) in llama_mod.hf_layer_map(i, cfg).items():
            arr = sd[hf_name]
            ttype = GGML_F32 if arr.ndim == 1 else ggml_type
            w.add_tensor(_LAYER_MAP[ours].format(i=i), arr, ttype)
    w.write()
    return cfg


def random_block_bytes(ggml_type: int, n: int,
                       gen: Optional[torch.Generator] = None,
                       device="cpu", scale: float = 0.02) -> torch.Tensor:
    """Random ggml blocks of ``ggml_type`` holding ``n`` elements, uint8
    [nb, bytes a block], made on ``device``: random code bytes, and every
    fp16 super-scale or scale (and min) a finite value of order ``scale``
    (so the weights are of order ``scale`` too). For a synthetic checkpoint
    written with ``GGUFWriter.add_tensor_raw`` without quantizing any
    floats."""
    bb, be = _BLOCK_BYTES[ggml_type], _BLOCK_ELEMS[ggml_type]
    nb = n // be
    dev = torch.device(device)
    blk = torch.randint(0, 256, (nb, bb), generator=gen, device=dev,
                        dtype=torch.uint8)
    # fp16 fields: (offset, magnitude relative to scale)
    cols = {GGML_Q4_0: ((0, 1 / 8),), GGML_Q4_1: ((0, 1 / 8), (2, 1.0)),
            GGML_Q5_0: ((0, 1 / 16),), GGML_Q5_1: ((0, 1 / 16), (2, 1.0)),
            GGML_Q8_0: ((0, 1 / 127),), GGML_Q2_K: ((80, 1 / 16),
                                                    (82, 1 / 16)),
            GGML_Q3_K: ((108, 1 / 128),), GGML_Q4_K: ((0, 1 / 512),
                                                      (2, 1 / 64)),
            GGML_Q5_K: ((0, 1 / 1024), (2, 1 / 64)),
            GGML_Q6_K: ((208, 1 / 1024),)}[ggml_type]
    for off, rel in cols:
        v = (torch.rand((nb, 1), generator=gen, device=dev) + 0.5) \
            * scale * rel
        if off in (2, 82) and ggml_type in (GGML_Q4_1, GGML_Q5_1):
            v = -v                      # the min of a legacy asym block
        blk[:, off:off + 2] = v.to(torch.float16).view(torch.uint8)
    return blk


__all__ = ["config_from_gguf", "unpack_blocks", "qtensor_from_gguf",
           "dequantize_on", "load_gguf", "load_gguf_params", "export_gguf",
           "random_block_bytes", "BITS"]
