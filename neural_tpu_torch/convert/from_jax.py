"""JAX parameter trees, carried as numpy, → the port's decoder.

The tree is the JAX package's param pytree with every array turned into
numpy, so that no JAX import is needed here:

- a bf16 array arrives as its ``uint16`` bit pattern (numpy has no bf16);
  every other dtype arrives as itself;
- a QTensor arrives as a dict ``{"planes": [...], "scales": ...,
  "zeros": ... | None, "perm": ... | None, "cfg": {QuantConfig fields}}``;
- ``layers`` is a list of per-layer dicts (the JAX at-rest tuple layout) or
  one dict of arrays stacked along a leading L axis.

QTensors not yet in the native-pack layout are converted on the way in.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtypes import QuantConfig
from ..core.qtensor import QTensor
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
    """Inverse of :func:`tensor_from_numpy` (bf16 → ``uint16`` bits)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def qtensor_from_numpy(d: Dict[str, Any], device) -> QTensor:
    opt = lambda a: None if a is None else tensor_from_numpy(a, device)
    return QTensor(tuple(tensor_from_numpy(p, device) for p in d["planes"]),
                   tensor_from_numpy(d["scales"], device), opt(d["zeros"]),
                   opt(d["perm"]), QuantConfig(**d["cfg"]))


def _leaf(a, device):
    if isinstance(a, dict):
        return qtensor_from_numpy(a, device)
    return tensor_from_numpy(a, device)


def _unstack(layers: Dict[str, Any]):
    """One dict of [L, ...] stacks (QTensor dicts included) → L dicts."""
    def take(a, i):
        if isinstance(a, dict):
            return {**a, "planes": [p[i] for p in a["planes"]],
                    "scales": a["scales"][i],
                    "zeros": None if a["zeros"] is None else a["zeros"][i],
                    "perm": None if a["perm"] is None else a["perm"][i]}
        return a[i]
    first = next(iter(layers.values()))
    L = (first["scales"] if isinstance(first, dict) else first).shape[0]
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
