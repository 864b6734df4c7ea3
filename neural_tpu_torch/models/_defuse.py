"""Split fused HF QKV (and gate/up) tensors into separate projections (the
port's copy of ``neural_tpu/models/_defuse.py``).

The port keeps separate ``[K, N]`` projections, as the JAX package does, so
each family's fused layout is untangled once at conversion. Inputs are
HF-layout ``[out_features, in_features]`` tensors (or 1-D biases), or
already-quantized :class:`~neural_tpu_torch.core.qtensor.QTensor`\\ s of a
GPTQ/AWQ import: a QTensor is ``[K = in, N = out]`` with its codes packed
along K only, so any split of the output features is an exact take along
N (:func:`take_n`), and each helper finds its indices by running itself on
``arange(N)``.
"""
from __future__ import annotations

import numpy as np
import torch


def _is_q(x) -> bool:
    return hasattr(x, "planes")


def asw(x):
    """A state-dict entry as a torch tensor (numpy arrays are wrapped); a
    QTensor passes through."""
    if _is_q(x) or isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.asarray(x))


def take_n(qt, idx):
    """The output columns ``idx`` of a QTensor (exact: the codes are packed
    along K; scales and zero-points are [G, N])."""
    from ..core.qtensor import QTensor
    idx = torch.as_tensor(np.asarray(idx), dtype=torch.long,
                          device=qt.planes[0].device)
    planes = tuple(p[..., idx].contiguous() for p in qt.planes)
    zeros = None if qt.zeros is None else qt.zeros[..., idx].contiguous()
    return QTensor(planes, qt.scales[..., idx].contiguous(), zeros, qt.perm,
                   qt.cfg)


def _qsplit(qt, split_fn):
    """An output-feature split helper applied to a QTensor, by running the
    same index arithmetic on arange(N)."""
    parts = split_fn(torch.arange(qt.N))
    return tuple(take_n(qt, p.reshape(-1).numpy()) for p in parts)


def split_interleaved(w, n_heads: int, head_dim: int):
    """[H*3*Dh, ...] with a per-head (q, k, v) interleave → 3x [H*Dh, ...].
    Layout used by GPT-NeoX, Bloom and ChatGLM-1."""
    if _is_q(w):
        return _qsplit(w, lambda i: split_interleaved(i, n_heads, head_dim))
    w = asw(w)
    rest = tuple(w.shape[1:])
    w4 = w.reshape(n_heads, 3, head_dim, *rest)
    return tuple(w4[:, i].reshape(n_heads * head_dim, *rest)
                 for i in range(3))


def split_concat(w, q_dim: int, kv_dim: int):
    """[q+kv+kv, ...] straight concatenation → q, k, v. Layout used by MPT,
    Phi-3 qkv_proj, GPT-BigCode c_attn, Baichuan W_pack, ChatGLM."""
    if _is_q(w):
        return _qsplit(w, lambda i: split_concat(i, q_dim, kv_dim))
    w = asw(w)
    return w[:q_dim], w[q_dim:q_dim + kv_dim], w[q_dim + kv_dim:]


def split_rows(w, n: int):
    """[A+B, ...] → [A, ...], [B, ...] (a fused gate_up: Phi-3,
    ChatGLM-2/3)."""
    if _is_q(w):
        return _qsplit(w, lambda i: split_rows(i, n))
    w = asw(w)
    return w[:n], w[n:]


def split_falcon(w, n_heads: int, n_kv: int, head_dim: int,
                 new_arch: bool, multi_query: bool):
    """Falcon's query_key_value layouts: grouped [Hkv, q_per+2, Dh, ...] for
    the new decoder architecture, [H+2, Dh, ...] for classic multi-query,
    the per-head interleave otherwise."""
    if _is_q(w):
        return _qsplit(w, lambda i: split_falcon(
            i, n_heads, n_kv, head_dim, new_arch, multi_query))
    w = asw(w)
    rest = tuple(w.shape[1:])
    if new_arch:
        q_per = n_heads // n_kv
        g = w.reshape(n_kv, q_per + 2, head_dim, *rest)
        return (g[:, :q_per].reshape(n_heads * head_dim, *rest),
                g[:, -2].reshape(n_kv * head_dim, *rest),
                g[:, -1].reshape(n_kv * head_dim, *rest))
    if multi_query:
        g = w.reshape(n_heads + 2, head_dim, *rest)
        return (g[:n_heads].reshape(n_heads * head_dim, *rest),
                g[n_heads].reshape(head_dim, *rest),
                g[n_heads + 1].reshape(head_dim, *rest))
    return split_interleaved(w, n_heads, head_dim)
