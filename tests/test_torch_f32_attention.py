"""f32 KV caches through the port's attention dispatch against the JAX
package's, on the same numpy inputs.

The JAX package's ``attend`` and ``attend_paged`` run their Pallas kernels
in interpret mode (as ``tests/test_attention.py`` runs them): each reads an
f32 cache's K and V as bf16 (``astype(bf16)`` of the block). The port's
dispatch takes K4/K3/K6's f32-cache branches, on the CPU their plain
versions, which round K and V the same way. The caches hold f32 values off
the bf16 grid, as a StreamingLLM shift leaves them (the shift rotates in
f32 and stores f32).

Tolerance: atol 2e-3 on the f32 output, ``tests/test_torch_attention.py``'s
(both sides take bf16 QK^T and PV operands with f32 statistics; P is
rounded per 512-key block against the running max in the TPU kernel, once
against the final max here; with V in [-1, 1] that moves the output by at
most 2^-9). On the port's side the f32 cache and its bf16 rounding give the
same output bit for bit, as the card's f32 branches are held to give.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_tpu.models.config import ModelConfig as JMC
from neural_tpu.ops.attention import attend as jattend
from neural_tpu.ops.paged_attention import attend_paged as jattend_paged
from neural_tpu.runtime.kvcache import KVCache as JKV
from neural_tpu.runtime.streaming import shift_cache_impl as jshift

from neural_tpu_torch.models.config import ModelConfig
from neural_tpu_torch.ops.attention import attend
from neural_tpu_torch.ops.paged_attention import attend_paged
from neural_tpu_torch.ops.rope import rope_freqs
from neural_tpu_torch.runtime.kvcache import KVCache
from neural_tpu_torch.runtime.streaming import shift_cache_impl

HQ, HKV, DH = 4, 2, 128
ATOL = 2e-3
PS = 256


def _cfgs():
    kw = dict(n_heads=HQ, n_kv_heads=HKV, head_dim=DH)
    return JMC(**kw), ModelConfig(**kw)


def _inputs(B, T, S, seed):
    """bf16-valued q, f32 K and V off the bf16 grid (V in [-1, 1])."""
    rng = np.random.default_rng(seed)
    bf = lambda a: np.array(jnp.asarray(a.astype(np.float32), jnp.bfloat16)
                             .astype(jnp.float32))
    q = bf(rng.standard_normal((B, T, HQ, DH)))
    k = rng.standard_normal((B, HKV, S, DH)).astype(np.float32)
    v = rng.uniform(-1, 1, (B, HKV, S, DH)).astype(np.float32)
    return q, k, v


def _port(q, k, v, pos, cfg):
    out = attend(torch.from_numpy(q).bfloat16(), torch.from_numpy(k),
                 torch.from_numpy(v), torch.from_numpy(pos).long(), cfg)
    rounded = attend(torch.from_numpy(q).bfloat16(),
                     torch.from_numpy(k).bfloat16(),
                     torch.from_numpy(v).bfloat16(),
                     torch.from_numpy(pos).long(), cfg)
    assert torch.equal(out, rounded)
    return out.numpy()


@pytest.mark.parametrize("T,start", [(1, 0), (1, 300), (130, 0), (130, 200)],
                         ids=["decode-fill1", "decode-fill301", "prefill",
                              "prefill-offset200"])
def test_contiguous_f32_cache_matches_jax(T, start):
    B, S = 2, 512
    q, k, v = _inputs(B, T, S, seed=T + start)
    pos = (np.arange(T)[None, :] + np.array([[start], [start + 7]])) \
        .astype(np.int32)
    jcfg, cfg = _cfgs()
    ref = jattend(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k),
                  jnp.asarray(v), None, None, jnp.asarray(pos), jcfg,
                  interpret=True)
    np.testing.assert_allclose(_port(q, k, v, pos, cfg), np.asarray(ref),
                               atol=ATOL)


def _pool(k, v, seed):
    """Contiguous [B, Hkv, S, Dh] → a shuffled pool of 256-key pages and
    its table."""
    B, H, S, D = k.shape
    maxp = S // PS
    perm = np.random.default_rng(seed).permutation(B * maxp + 1)
    table = perm[:B * maxp].reshape(B, maxp).astype(np.int32)
    pools = []
    for c in (k, v):
        pool = np.zeros((B * maxp + 1, H, PS, D), np.float32)
        for b in range(B):
            for i in range(maxp):
                pool[table[b, i]] = c[b, :, i * PS:(i + 1) * PS]
        pools.append(pool)
    return pools[0], pools[1], table


@pytest.mark.parametrize("T,start", [(1, 400), (130, 0)],
                         ids=["decode", "prefill"])
def test_paged_f32_pool_matches_jax(T, start):
    B, S = 2, 512
    q, k, v = _inputs(B, T, S, seed=7 + T)
    kp, vp, table = _pool(k, v, seed=T)
    pos = (np.arange(T)[None, :] + np.array([[start], [start + 50]])) \
        .astype(np.int32)
    jcfg, cfg = _cfgs()
    ref = jattend_paged(jnp.asarray(q, jnp.bfloat16), jnp.asarray(kp),
                        jnp.asarray(vp), None, None, jnp.asarray(table),
                        jnp.asarray(pos), jcfg, interpret=True)
    t = lambda a: torch.from_numpy(a)
    out = attend_paged(t(q).bfloat16(), t(kp), t(vp), None, None, t(table),
                       t(pos).long(), cfg)
    rounded = attend_paged(t(q).bfloat16(), t(kp).bfloat16(),
                           t(vp).bfloat16(), None, None, t(table),
                           t(pos).long(), cfg)
    assert torch.equal(out, rounded)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_shifted_streaming_slot_matches_jax():
    """A full f32 cache shifted by both packages (4 sinks, 256 dropped, the
    moved keys rotated by -256 RoPE steps in f32), then attended by the
    next query: the shifted caches agree to f32 rounding (the rotation's
    cos/sin), their values are off the bf16 grid, and the decode over them
    agrees with JAX's interpret kernel."""
    B, S, n_keep, n_discard = 1, 512, 4, 256
    jcfg, cfg = _cfgs()
    q, k, v = _inputs(B, 1, S, seed=11)
    k = k[None]                                   # one layer
    v = v[None]
    inv = rope_freqs(DH, DH, 10000.0, None)
    jc = jshift(JKV(jnp.asarray(k), jnp.asarray(v), None, None),
                jnp.asarray(inv), jcfg, n_keep, n_discard)
    pc = shift_cache_impl(KVCache(torch.from_numpy(k.copy()),
                                  torch.from_numpy(v.copy())),
                          torch.from_numpy(inv), cfg, n_keep, n_discard)
    np.testing.assert_allclose(pc.k.numpy(), np.asarray(jc.k), atol=1e-5)
    np.testing.assert_array_equal(pc.v.numpy(), np.asarray(jc.v))
    moved = pc.k[0, :, :, n_keep:S - n_discard]
    assert not torch.equal(moved, moved.bfloat16().float())
    fill = S - n_discard                          # the next write's position
    pos = np.array([[fill]], np.int32)
    ref = jattend(jnp.asarray(q, jnp.bfloat16), jc.k[0], jc.v[0], None, None,
                  jnp.asarray(pos), jcfg, interpret=True)
    out = _port(q, pc.k[0].numpy(), pc.v[0].numpy(), pos, cfg)
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL)
