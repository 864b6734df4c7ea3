"""JAX parameter trees, carried as numpy, → the port's decoder.

The tree is the JAX package's param pytree with every array turned into
numpy, so that no JAX import is needed here:

- a bf16 array arrives as its ``uint16`` bit pattern (numpy has no bf16);
  the int8 code planes of 5-8 bit weights and float zero-points (f32, or
  bf16 bits) arrive as themselves, as do the other integer and f32 arrays;
- a QTensor arrives as a dict ``{"planes": [...], "scales": ...,
  "zeros": ... | None, "perm": ... | None, "cfg": {QuantConfig fields}}``;
  an fp8 plane (an ml_dtypes float8 array on the JAX side, which torch
  cannot read) arrives as its ``uint8`` bit pattern, and the cfg's kind
  says which fp8 it is;
- ``layers`` is a list of per-layer dicts (the JAX at-rest tuple layout) or
  one dict of arrays stacked along a leading L axis; a per-layer flag
  (Gemma-2's ``use_sliding``) is a bool array, [L] when stacked, and
  becomes a 0-d bool tensor in each layer;
- every other leaf crosses under its own name: the projection and
  LayerNorm biases, the qk-norm weights ``q_norm_w``/``k_norm_w``, Bloom's
  ``embed_norm_w``/``_b``, ``final_norm_b``, the learned position table
  ``pos_embed`` (OPT, StarCoder), the ``lm_head_b`` (GPT-J, Phi-2) and the
  ``alibi_slopes`` (a tree without RoPE has no ``rope_inv_freqs``; a
  parallel-residual layer with one shared norm has no ``ffn_norm_w``);
- a mixture-of-experts layer has its ``router`` and an ``experts`` dict of
  ``[E, ...]`` stacks (``[L, E, ...]`` in a stacked tree), QTensor dicts or
  arrays.

QTensors not yet at rest are converted on the way in
(``runtime.generate.params_to_native``). A Whisper tree (its own layout,
``models/whisper.py``) crosses by :func:`whisper_params_from_numpy`.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtypes import QuantConfig
from ..core.qtensor import FP8_DTYPES, QTensor
from ..models.config import ModelConfig
from ..models.transformer import Transformer
from ..runtime.generate import params_to_native


def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """numpy → torch on ``device``; ``uint16`` is read as bf16 bits."""
    a = np.array(a)          # a writable, contiguous copy
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`tensor_from_numpy` (bf16 → ``uint16`` bits, fp8 →
    ``uint8`` bits)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    if t.dtype in FP8_DTYPES.values():
        return t.view(torch.uint8).numpy()
    return t.numpy()


def qtensor_from_numpy(d: Dict[str, Any], device) -> QTensor:
    opt = lambda a: None if a is None else tensor_from_numpy(a, device)
    cfg = QuantConfig(**d["cfg"])
    planes = tuple(tensor_from_numpy(p, device) for p in d["planes"])
    if cfg.kind in FP8_DTYPES:
        planes = tuple(p.view(FP8_DTYPES[cfg.kind]) for p in planes)
    return QTensor(planes, tensor_from_numpy(d["scales"], device),
                   opt(d["zeros"]), opt(d["perm"]), cfg)


def _is_qtensor(a) -> bool:
    return isinstance(a, dict) and "planes" in a


def _leaf(a, device):
    if _is_qtensor(a):
        return qtensor_from_numpy(a, device)
    if isinstance(a, dict):                     # a layer's experts
        return {k: _leaf(v, device) for k, v in a.items()}
    return tensor_from_numpy(a, device)


def _unstack(layers: Dict[str, Any]):
    """One dict of [L, ...] stacks (QTensor dicts and the experts' dict
    included) → L dicts."""
    def take(a, i):
        if _is_qtensor(a):
            return {**a, "planes": [p[i] for p in a["planes"]],
                    "scales": a["scales"][i],
                    "zeros": None if a["zeros"] is None else a["zeros"][i],
                    "perm": None if a["perm"] is None else a["perm"][i]}
        if isinstance(a, dict):
            return {k: take(v, i) for k, v in a.items()}
        return np.asarray(a[i])      # a 0-d array for a stacked flag
    first = next(v for v in layers.values()
                 if _is_qtensor(v) or not isinstance(v, dict))
    L = (first["scales"] if _is_qtensor(first) else first).shape[0]
    return [{k: take(v, i) for k, v in layers.items()} for i in range(L)]


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device=None) -> Transformer:
    """A JAX param tree as numpy (see the module docstring) → Transformer."""
    dev = resolve_device(device)
    layers = tree["layers"]
    if isinstance(layers, dict):
        layers = _unstack(layers)
    params: Dict[str, Any] = {
        "layers": [{k: _leaf(v, dev) for k, v in lp.items()}
                   for lp in layers]}
    for k, v in tree.items():
        if k != "layers":
            params[k] = _leaf(v, dev)
    return Transformer(cfg, params_to_native(params))


def whisper_params_from_numpy(tree: Dict[str, Any], device=None):
    """A JAX Whisper param tree as numpy (``models.whisper.params_from_hf``'s
    tree, ``enc_layers``/``dec_layers`` stacked along a leading L axis,
    QTensors as dicts of their fields) → the port's Whisper params:
    per-layer lists, every QTensor at rest (``params_to_native``), on
    ``device`` (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    params: Dict[str, Any] = {}
    for k, v in tree.items():
        if k in ("enc_layers", "dec_layers"):
            layers = _unstack(v) if isinstance(v, dict) else v
            params[k] = [{n: _leaf(a, dev) for n, a in lp.items()}
                         for lp in layers]
        else:
            params[k] = _leaf(v, dev)
    return params_to_native(params)
