"""The native checkpoint file and session files (port of
``neural_tpu/convert/checkpoint.py``; byte-compatible with it both ways).

Reference analogs: the NE/GGUF model files with versioned magics
(model_types.h:108-114), and the inference-state snapshot
(model_copy_state_data / model_set_state_data model_utils.cpp:1551-1773,
session files :1775-1869 with MODEL_SESSION_MAGIC).

Format: ``NTPU``, a little-endian uint32 version and uint64 header length,
a JSON header (the model config, ``extra``, and a tree spec whose leaves
name an array by index with its dtype and shape; a QTensor carries its
QuantConfig fields), then the raw little-endian arrays, each 64-byte
aligned, in index order. The dtype names are numpy's and ml_dtypes':
``bfloat16`` crosses as uint16 bits viewed as ``torch.bfloat16``,
``float8_e4m3fn``/``float8_e5m2`` through uint8 views, and ``int4``/
``uint4`` take one byte an element, as int8/uint8 (no ml_dtypes here).

QTensors are written as they are: the port's at-rest ones (native-pack
nibbles, int8 code planes, bf16 scales) say so in their QuantConfig's
``native_pack`` or by their int8 planes, which the JAX package reads as
its own at-rest layouts. A JAX file's bit-plane packed tensors, or its
``jnp.int4`` code planes, are converted to the port's at-rest layouts on
loading (:func:`params_from_tree`).

A session file holds a KV cache, the positions, and optionally the last
step's logits, mirostat's ``mu`` and the sampler's random state. The port's
random state is its ``torch.Generator`` state under ``torch_generator``;
the JAX package's key is ``rng_key``. Each package ignores the other's,
since their random streams differ anyway.
"""
from __future__ import annotations

import dataclasses
import json
import mmap
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtypes import QuantConfig
from ..core.qtensor import FP8_DTYPES, QTensor
from ..models.config import ModelConfig

MAGIC = b"NTPU"
VERSION = 1
ALIGN = 64

# file dtype name → (numpy dtype of its bytes, torch dtype viewed from it)
_DTYPES = {
    "float32": (np.float32, None), "float16": (np.float16, None),
    "bfloat16": (np.int16, torch.bfloat16), "uint8": (np.uint8, None),
    "int8": (np.int8, None), "int32": (np.int32, None),
    "int64": (np.int64, None), "bool": (np.bool_, None),
    "uint32": (np.uint32, None),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
    "int4": (np.int8, None), "uint4": (np.uint8, None)}
_NAMES = {torch.float32: "float32", torch.float16: "float16",
          torch.bfloat16: "bfloat16", torch.uint8: "uint8",
          torch.int8: "int8", torch.int32: "int32", torch.int64: "int64",
          torch.bool: "bool", torch.uint32: "uint32",
          torch.float8_e4m3fn: "float8_e4m3fn",
          torch.float8_e5m2: "float8_e5m2"}


def _to_bytes(t) -> Tuple[str, list, bytes]:
    """A tensor or numpy array → (dtype name, shape, raw bytes)."""
    if isinstance(t, np.ndarray):
        a = np.ascontiguousarray(t)
        return str(a.dtype), list(a.shape), a.tobytes()
    t = t.detach().contiguous().cpu()
    name = _NAMES[t.dtype]
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    elif t.dtype in FP8_DTYPES.values():
        t = t.view(torch.uint8)
    return name, list(t.shape), t.numpy().tobytes()


def _encode_tree(obj, arrays: list):
    """A tree of dicts, lists, tuples, QTensors and tensors → its JSON spec;
    the arrays are appended to ``arrays`` by index."""
    if isinstance(obj, QTensor):
        return {"__qtensor__": dataclasses.asdict(obj.cfg),
                "planes": [_encode_tree(p, arrays) for p in obj.planes],
                "scales": _encode_tree(obj.scales, arrays),
                "zeros": _encode_tree(obj.zeros, arrays),
                "perm": _encode_tree(obj.perm, arrays)}
    if obj is None:
        return None
    if isinstance(obj, dict):
        return {"__dict__": {k: _encode_tree(v, arrays) for k, v in
                             sorted(obj.items())}}
    if isinstance(obj, (list, tuple)):
        return {"__list__": [_encode_tree(v, arrays) for v in obj],
                "tuple": isinstance(obj, tuple)}
    if not isinstance(obj, (torch.Tensor, np.ndarray)):
        obj = np.asarray(obj)
    name, shape, data = _to_bytes(obj)
    arrays.append(data)
    return {"__arr__": len(arrays) - 1, "dtype": name, "shape": shape}


def _decode_tree(spec, arrays):
    if spec is None:
        return None
    if "__qtensor__" in spec:
        return QTensor(tuple(_decode_tree(p, arrays) for p in spec["planes"]),
                       _decode_tree(spec["scales"], arrays),
                       _decode_tree(spec["zeros"], arrays),
                       _decode_tree(spec["perm"], arrays),
                       QuantConfig(**spec["__qtensor__"]))
    if "__dict__" in spec:
        return {k: _decode_tree(v, arrays)
                for k, v in spec["__dict__"].items()}
    if "__list__" in spec:
        vals = [_decode_tree(v, arrays) for v in spec["__list__"]]
        return tuple(vals) if spec.get("tuple") else vals
    return arrays[spec["__arr__"]]


def save_checkpoint(path: str, params, cfg: Optional[ModelConfig] = None,
                    extra: Optional[dict] = None):
    """Write a param tree (a Transformer's ``param_dict()``, or any tree of
    dicts, lists, QTensors and tensors) with its config."""
    arrays: list = []
    spec = _encode_tree(params, arrays)
    header = {"version": VERSION,
              "config": dataclasses.asdict(cfg) if cfg else None,
              "extra": extra or {}, "tree": spec}
    hdr = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(MAGIC + struct.pack("<IQ", VERSION, len(hdr)))
        f.write(hdr)
        pos = f.tell()
        for data in arrays:
            pad = (-pos) % ALIGN
            f.write(b"\0" * pad)
            f.write(data)
            pos += pad + len(data)


def _array_specs(spec, out):
    if spec is None:
        return
    if "__arr__" in spec:
        out.append(spec)
    elif "__qtensor__" in spec:
        for p in spec["planes"]:
            _array_specs(p, out)
        for k in ("scales", "zeros", "perm"):
            _array_specs(spec[k], out)
    elif "__dict__" in spec:
        for v in spec["__dict__"].values():
            _array_specs(v, out)
    elif "__list__" in spec:
        for v in spec["__list__"]:
            _array_specs(v, out)


def load_checkpoint(path: str, device=None
                    ) -> Tuple[Any, Optional[ModelConfig], dict]:
    """→ (tree of tensors on ``device``, the card unless ``device="cpu"``;
    config or None; extra). Each array is copied from the file's mmap to
    the device on its own; no view of the mmap outlives the call."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    try:
        if mm[:4] != MAGIC:
            raise ValueError(f"{path} is not a neural-tpu checkpoint")
        _, hlen = struct.unpack_from("<IQ", mm, 4)
        header = json.loads(mm[16:16 + hlen].decode())
        pos = 16 + hlen
        specs: list = []
        _array_specs(header["tree"], specs)
        specs.sort(key=lambda s: s["__arr__"])
        arrays = {}
        for s in specs:
            pos += (-pos) % ALIGN
            np_dt, view = _DTYPES[s["dtype"]]
            shape = tuple(s["shape"])
            n = int(np.prod(shape))
            a = np.frombuffer(mm, np_dt, n, pos).reshape(shape)
            t = torch.from_numpy(a.copy()).to(dev)
            del a
            arrays[s["__arr__"]] = t if view is None else t.view(view)
            pos += n * np.dtype(np_dt).itemsize
        tree = _decode_tree(header["tree"], arrays)
    finally:
        mm.close()
    cfg = None
    if header["config"]:
        c = dict(header["config"])
        if c.get("rope_scaling"):  # JSON turns the tuple of pairs into lists
            c["rope_scaling"] = dict(tuple(x) for x in c["rope_scaling"])
        cfg = ModelConfig(**c)
    return tree, cfg, header.get("extra", {})


def _int4_to_native(qt: QTensor) -> QTensor:
    """A JAX ``jnp.int4`` (or ``uint4``) code plane [..., K, N], read as one
    byte an element, → native-pack nibbles, the port's at-rest layout for
    the same centered codes (two's-complement low nibble first); leading
    dims (an expert stack) stay."""
    codes = qt.planes[0].to(torch.int32)
    nib = codes & 0xF
    plane = (nib[..., 0::2, :] | (nib[..., 1::2, :] << 4)).to(torch.uint8)
    return QTensor((plane,), qt.scales, qt.zeros, qt.perm,
                   dataclasses.replace(qt.cfg, native_pack=True))


def _unstack(layers: Dict[str, Any]):
    """One dict of [L, ...] stacks (QTensors and a MoE layer's ``experts``
    dict of [L, E, ...] stacks included) → L dicts."""
    def take(v, i):
        if isinstance(v, QTensor):
            opt = lambda t: None if t is None else t[i]
            return QTensor(tuple(p[i] for p in v.planes), v.scales[i],
                           opt(v.zeros), opt(v.perm), v.cfg)
        if isinstance(v, dict):
            return {k: take(x, i) for k, x in v.items()}
        return v[i]
    first = next(v for v in layers.values() if not isinstance(v, dict))
    L = (first.scales if isinstance(first, QTensor) else first).shape[0]
    return [{k: take(v, i) for k, v in layers.items()} for i in range(L)]


def param_tree(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A loaded param tree (the port's, or the JAX package's: stacked
    ``layers``, bit-plane packed or ``int4`` planes) → the port's param
    dict, ``layers`` a list of per-layer dicts (a MoE layer's ``experts``
    each an [E, ...] stack), JAX ``int4`` planes as native-pack; other
    QTensors as they were stored."""
    def fix(v):
        if isinstance(v, dict):                    # a layer's experts
            return {k: fix(x) for k, x in v.items()}
        # a one-byte plane of a 2-4 bit weight that is not native-pack is
        # a JAX int4 plane (bit-plane packing stores uint8, never int8)
        if isinstance(v, QTensor) and v.cfg.kind == "int" \
                and 2 <= v.cfg.bits <= 4 and not v.cfg.native_pack \
                and v.planes[0].dtype == torch.int8:
            return _int4_to_native(v)
        return v
    layers = tree["layers"]
    if isinstance(layers, dict):
        layers = _unstack(layers)
    out = {k: fix(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = [{k: fix(v) for k, v in lp.items()} for lp in layers]
    return out


def params_from_tree(tree: Dict[str, Any], cfg: ModelConfig):
    """A loaded param tree (:func:`param_tree`) → Transformer, every
    QTensor at rest (``runtime.generate.params_to_native``)."""
    from ..models.transformer import Transformer
    from ..runtime.generate import params_to_native
    return Transformer(cfg, params_to_native(param_tree(tree)))


# -- session state (KV cache + generation position) -------------------------


def save_session(path: str, cache, lengths, extra: Optional[dict] = None,
                 logits=None, generator_state=None, sampler_mu=None):
    """Snapshot the inference state (reference model_save_session_file):
    the KV cache and positions and, for a resume with no re-evaluation,
    the last step's ``logits`` [B, V], the sampler's ``torch.Generator``
    state and mirostat's ``mu``. With all three a resumed generation, a
    sampled one too, is the uninterrupted run's."""
    state = {"k": cache.k, "v": cache.v}
    if cache.k_scale is not None:
        state["k_scale"] = cache.k_scale
        state["v_scale"] = cache.v_scale
    state["lengths"] = np.asarray(lengths, np.int32)
    if logits is not None:
        state["logits"] = logits.to(torch.float32)
    if generator_state is not None:
        state["torch_generator"] = generator_state
    if sampler_mu is not None:
        state["sampler_mu"] = sampler_mu
    save_checkpoint(path, state, None, extra)


def load_session(path: str, device=None):
    """→ (KVCache on ``device``, lengths as numpy, extra). ``extra`` holds
    the file's ``prompt_ids`` and whichever of ``logits``,
    ``torch_generator`` (on the CPU, where ``torch.Generator.set_state``
    takes it) and ``sampler_mu`` it has. A JAX file's ``rng_key`` is not
    read."""
    from ..runtime.kvcache import KVCache
    dev = resolve_device(device)
    state, _, extra = load_checkpoint(path, dev)

    def _scale(a):
        # sessions saved before the flat scale layout stored
        # [L, B, Hkv, 8, S] f32 (8-replicated rows)
        if a is not None and a.ndim == 5:
            a = a[:, :, :, 0].to(torch.bfloat16)
        return a
    cache = KVCache(state["k"], state["v"], _scale(state.get("k_scale")),
                    _scale(state.get("v_scale")))
    extra = dict(extra or {})
    for aux in ("logits", "sampler_mu"):
        if aux in state:
            extra[aux] = state[aux]
    if "torch_generator" in state:
        extra["torch_generator"] = state["torch_generator"].cpu()
    return cache, state["lengths"].cpu().numpy(), extra
