"""Weight-residency estimates (port of ``neural_tpu/runtime/residency.py``).

The JAX package keeps a quantized weight either packed (bit planes,
converted to native codes inside each decode executable, which then holds a
second copy) or native at rest (converted once at load), and chooses per
decode shape: native when the packed path's estimated peak — the param
tree, the in-executable copies, the KV cache and ``TRANSIENT_BYTES`` —
exceeds the device's budget. The port stores every weight native at rest
(``runtime.generate.params_to_native``, at load), so the choice is made
already: :func:`ensure_decode_residency` has no policy to apply and passes
the params through, as the JAX one does for native params. The estimates
are pure functions, for callers that size a batch or a cache against the
card; nothing in the port acts on :func:`should_go_native`'s answer, so the
JAX package's ``NTPU_NATIVE_AT_REST`` override has no counterpart here.

``NTPU_HBM_BYTES`` sets the device budget in bytes, as in the JAX package
(else the card's total memory, ``torch.cuda.mem_get_info``). No decode
shape is refused here: the JAX package refuses none.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import torch

from ..core.qtensor import QTensor, is_native
from ..models.config import ModelConfig
from .kvcache import kv_torch_dtype

# the headroom the estimate reserves above the steady-state buffers
# (activations, logits, conversion temporaries, the allocator's slack): the
# JAX package's constant
TRANSIENT_BYTES = 3 << 30
# a packed tensor whose f32 conversion temporary would exceed this stays
# packed inside a JAX decode executable (``IN_JIT_SKIP_BYTES`` of
# ``neural_tpu/runtime/generate.py``), so it adds no copy
IN_JIT_SKIP_BYTES = 1 << 30


def _leaves(tree):
    """The QTensors and tensors of a param tree: a decoder (its
    ``param_dict()``), dicts, lists and tuples."""
    if hasattr(tree, "param_dict"):
        tree = tree.param_dict()
    if isinstance(tree, (QTensor, torch.Tensor)):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def _qleaves(params):
    return [l for l in _leaves(params) if isinstance(l, QTensor)]


def tree_device_bytes(params) -> int:
    """Steady-state bytes of the whole param tree on the device: each
    QTensor's ``nbytes()`` (planes and scales, one byte a zero-point, the
    JAX count), each tensor's elements times its element size."""
    tot = 0
    for leaf in _leaves(params):
        if isinstance(leaf, QTensor):
            tot += leaf.nbytes()
        else:
            tot += leaf.numel() * leaf.element_size()
    return tot


def _conv_copy_bytes_one(qt: QTensor) -> int:
    """The copy a JAX decode executable would hold for one packed QTensor
    (its native codes and bf16 scales, and zero-points); none for a native
    one, which every QTensor of a loaded port model is."""
    if is_native(qt) or qt.cfg.kind != "int" or qt.cfg.bits < 2:
        return 0
    elems = math.prod(qt.planes[0].shape[:-2]) * qt.K * qt.N
    if qt.K * qt.N * 4 > IN_JIT_SKIP_BYTES:
        return 0
    if qt.cfg.bits == 2:
        code = elems // 4
    elif qt.cfg.bits <= 4:
        code = elems // 2
    else:
        code = elems
    aux = qt.scales.numel() * 2
    if qt.zeros is not None:
        aux += qt.scales.numel() * 2
    return code + aux


def conv_copy_bytes(params) -> int:
    return sum(_conv_copy_bytes_one(q) for q in _qleaves(params))


def kv_cache_bytes(cfg: ModelConfig, batch: int, S: int, kv_dtype) -> int:
    """Bytes of one ``runtime.kvcache.init_cache`` allocation: K and V at the
    cache's element size (bf16 2, f32 4), int8 codes with bf16 scales."""
    dt = kv_torch_dtype(kv_dtype)
    elems = cfg.n_layers * batch * cfg.n_kv_heads * S * cfg.head_dim
    if dt == torch.int8:
        scales = cfg.n_layers * batch * cfg.n_kv_heads * S
        return elems * 2 + scales * 2 * 2
    return elems * torch.empty((), dtype=dt).element_size() * 2


def device_hbm_budget(device=None) -> int:
    """The device's memory budget in bytes: ``NTPU_HBM_BYTES``, else the
    card's total (``torch.cuda.mem_get_info``). Without a card and without
    the variable there is no budget to read, and this raises."""
    env = os.environ.get("NTPU_HBM_BYTES")
    if env:
        return int(float(env))
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device to read a memory budget from: "
                           "set NTPU_HBM_BYTES")
    return int(torch.cuda.mem_get_info(device)[1])


def decode_peak_bytes(params, cfg: ModelConfig, batch: int, S: int,
                      kv_dtype) -> int:
    """Estimated peak device bytes of the packed path at this decode
    shape."""
    return (tree_device_bytes(params) + conv_copy_bytes(params)
            + kv_cache_bytes(cfg, batch, S, kv_dtype) + TRANSIENT_BYTES)


def should_go_native(params, cfg: ModelConfig, batch: int, S: int,
                     kv_dtype) -> bool:
    """The JAX package's rule: native at rest when the packed path's
    estimated peak exceeds the device budget."""
    return decode_peak_bytes(params, cfg, batch, S, kv_dtype) \
        > device_hbm_budget()


def ensure_decode_residency(params, cfg: ModelConfig, batch: int = 1,
                            S: Optional[int] = None,
                            kv_dtype=torch.bfloat16, donate: bool = True):
    """A placeholder with no policy: the port's params are native at rest
    already, so they pass through unchanged (the JAX function's answer for
    native params; ``donate`` has nothing to free)."""
    return params
