"""The options of K3/K4/K6 that Gemma-2 needs — head dim 256, the tanh
softcap and the sliding window — in the plain versions and the dispatch,
against the JAX package's Pallas kernels (interpret mode) and its
``attend_xla`` on the same numpy inputs.

Inputs: q drawn with std 6, so the scaled scores reach about ±18 and a
softcap of 50 moves them by up to ~0.8; V in [-1, 1]. Every case with an
option on also checks that the option moves the output by more than ten
times the tolerance, so a plain version that ignored it would fail.

Tolerance: atol 2e-3 on the f32 output, the K3/K4 tolerance of
``test_torch_attention.py`` and ``test_torch_kv8.py``: both sides use the
same operand roundings (bf16 QK^T and PV, or the same int8 q codes and
exact int8 dot) and f32 statistics; what differs is the order of the
softmax sums and where P is rounded to bf16 (per key block against the
running max in the kernel, once against the final max here), which moves
the output by at most 2^-9 < 2e-3 with |v| <= 1. Against the f32
``attend_xla`` (bf16 caches only) the same 2e-3 holds: the reference keeps
P unrounded. K6 against ``attend_paged(force="xla")`` on int8 pools keeps
``test_torch_paged.py``'s oracle tolerance (atol 4e-2, rtol 3e-2): the
oracle does not quantize q.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_tpu.models.config import ModelConfig as JMC
from neural_tpu.ops.attention import (attend as jattend,
                                      attend_xla as jattend_xla,
                                      flash_decode as jflash_decode,
                                      flash_prefill as jflash_prefill,
                                      quantize_kv as jquantize_kv)
from neural_tpu.ops.paged_attention import (attend_paged as jattend_paged,
                                            paged_flash_decode as jpaged_fd)

from neural_tpu_torch.models.config import ModelConfig
from neural_tpu_torch.ops.attention import (
    attend, attend_xla, check_head_dim, flash_decode, flash_decode_i8,
    flash_decode_i8_plain, flash_decode_plain, flash_prefill,
    flash_prefill_i8, flash_prefill_i8_plain, flash_prefill_plain)
from neural_tpu_torch.ops.paged_attention import (
    attend_paged, paged_decode, paged_decode_i8, paged_decode_plain)

B, HQ, HKV = 1, 4, 2          # G = 2, as Gemma-2-9B
S = 512
ATOL = 2e-3
ORACLE_TOL = dict(atol=4e-2, rtol=3e-2)
SOFTCAP = 50.0


def _bf(a):
    return np.array(jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16)
                    .astype(jnp.float32))


def _t(a, dt=torch.bfloat16):
    return None if a is None else torch.from_numpy(
        np.array(np.asarray(a).astype(np.float32))).to(dt)


def _j(a, dt=jnp.bfloat16):
    return None if a is None else jnp.asarray(a, dt)


def _cache(rng, shape, int8, uniform):
    """bf16 values as f32, or JAX-quantized int8 codes and their scales."""
    x = rng.uniform(-1, 1, shape) if uniform else rng.standard_normal(shape)
    if not int8:
        return _bf(x), None
    c, s = jquantize_kv(jnp.asarray(x.astype(np.float32)))
    return np.array(c), np.array(s.astype(jnp.float32))


def _inputs(T, Dh, int8, seed, lead=(B, HKV, S)):
    rng = np.random.default_rng(seed)
    q = _bf(rng.standard_normal((B, T, HQ, Dh)) * 6)
    k, ks = _cache(rng, (*lead, Dh), int8, uniform=False)
    v, vs = _cache(rng, (*lead, Dh), int8, uniform=True)
    return q, k, ks, v, vs


def _kv_t(k, ks, v, vs, int8):
    cdt = torch.int8 if int8 else torch.bfloat16
    return _t(k, cdt), _t(v, cdt), _t(ks), _t(vs)


def _kv_j(k, ks, v, vs, int8):
    cdt = jnp.int8 if int8 else jnp.bfloat16
    return _j(k, cdt), _j(v, cdt), _j(ks), _j(vs)


def _moved(out, off):
    """An option on must move the output well past the tolerance."""
    assert (out - off).abs().max().item() > 10 * ATOL


OPTS = [(0.0, 0), (SOFTCAP, 0), (0.0, 96), (SOFTCAP, 96)]
OPT_IDS = ["plain", "softcap", "window", "softcap_window"]


@pytest.mark.parametrize("softcap,window", OPTS, ids=OPT_IDS)
@pytest.mark.parametrize("Dh", [128, 256])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_k4_options_match_pallas(int8, Dh, softcap, window):
    """K4's plain version at fill 300 (a window of 96 puts the floor at key
    204, inside the second of four 128-key blocks) against the TPU kernel,
    whose S-block clamp skips the blocks below the floor."""
    fill, scale = 300, Dh ** -0.5
    q, k, ks, v, vs = _inputs(1, Dh, int8, seed=Dh + 7 * window + int8)
    lengths = np.array([fill], np.int32)
    kt, vt, kst, vst = _kv_t(k, ks, v, vs, int8)
    kj, vj, ksj, vsj = _kv_j(k, ks, v, vs, int8)
    ref = jflash_decode(jnp.asarray(q[:, 0]), kj, vj, ksj, vsj,
                        jnp.asarray(lengths), blk_s=128, softcap=softcap,
                        scale=scale, window=window, interpret=True)
    qt, lt = _t(q[:, 0]), torch.from_numpy(lengths)
    if int8:
        plain = lambda *o: flash_decode_i8_plain(qt, kt, vt, kst, vst, lt,
                                                 scale, *o)
        wrapped = flash_decode_i8(qt, kt, vt, kst, vst, lt, scale, softcap,
                                  window)
    else:
        plain = lambda *o: flash_decode_plain(qt, kt, vt, lt, scale, *o)
        wrapped = flash_decode(qt, kt, vt, lt, scale, softcap, window)
    out = plain(softcap, window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    assert torch.equal(wrapped, out)       # the wrapper's CPU route
    if softcap or window:
        _moved(out, plain())


@pytest.mark.parametrize("softcap,window", OPTS, ids=OPT_IDS)
@pytest.mark.parametrize("Dh", [128, 256])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_k3_options_match_pallas(int8, Dh, softcap, window):
    """K3's plain version on a 130-token chunk at offset 200 (rows at
    positions 200..329; a window of 96 hides keys below 105..234) against
    the TPU kernel with 128-key S blocks, whose clamp skips the blocks
    below each query tile's floor."""
    T, start, scale = 130, 200, Dh ** -0.5
    q, k, ks, v, vs = _inputs(T, Dh, int8, seed=3 * Dh + window + int8)
    starts = np.array([start], np.int32)
    qp = np.pad(q, ((0, 0), (0, 256 - T), (0, 0), (0, 0)))
    kj, vj, ksj, vsj = _kv_j(k, ks, v, vs, int8)
    ref = np.asarray(jflash_prefill(
        jnp.asarray(qp, jnp.bfloat16), kj, vj, ksj, vsj,
        starts=jnp.asarray(starts), blk_t=128, blk_s=128, softcap=softcap,
        scale=scale, window=window, interpret=True))[:, :T]
    kt, vt, kst, vst = _kv_t(k, ks, v, vs, int8)
    qt, st = _t(q), torch.from_numpy(starts)
    if int8:
        plain = lambda *o: flash_prefill_i8_plain(qt, kt, vt, kst, vst, st,
                                                  scale, *o)
        wrapped = flash_prefill_i8(qt, kt, vt, kst, vst, st, scale, softcap,
                                   window)
    else:
        plain = lambda *o: flash_prefill_plain(qt, kt, vt, st, scale, *o)
        wrapped = flash_prefill(qt, kt, vt, st, scale, softcap, window)
    out = plain(softcap, window)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)
    assert torch.equal(wrapped, out)
    if softcap or window:
        _moved(out, plain())


def _cfgs(Dh, window, softcap=SOFTCAP, attn_scale=None):
    kw = dict(n_heads=HQ, n_kv_heads=HKV, head_dim=Dh, attn_softcap=softcap,
              sliding_window=window, attn_scale=attn_scale)
    return JMC(**kw), ModelConfig(**kw)


@pytest.mark.parametrize("sliding", [True, False])
@pytest.mark.parametrize("T,fill", [(1, 300), (130, 330)],
                         ids=["decode", "prefill"])
def test_attend_layer_window_matches_attend_xla(T, fill, sliding):
    """The dispatch and the port's ``attend_xla`` with a per-layer window
    (the config's window on a sliding layer, 0 on a global one) against JAX
    ``attend_xla`` with the layer's ``sliding`` flag; Gemma-2's head dim
    and attention scale (``query_pre_attn_scalar`` 256 → 1/16)."""
    Dh, W = 256, 96
    q, k, _, v, _ = _inputs(T, Dh, False, seed=T + sliding)
    jcfg, cfg = _cfgs(Dh, W, attn_scale=1 / 16)
    pos = (fill - T + np.arange(T, dtype=np.int32))[None]
    ref = jattend_xla(jnp.asarray(q), _j(k), _j(v), None, None,
                      jnp.asarray(pos), jcfg, sliding=jnp.asarray(sliding))
    args = (_t(q), _t(k), _t(v), torch.from_numpy(pos).long(), cfg)
    window = W if sliding else 0
    for out in (attend(*args, window=window),
                attend_xla(*args, window=window)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("sliding", [True, False])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_attend_decode_traced_window_matches_pallas(int8, sliding):
    """A window passed per layer: JAX ``attend`` takes the layer's flag as a
    traced value (its layer scan) into the Pallas decode kernel; the port
    takes the Python int the block read at construction."""
    Dh, W, fill = 128, 96, 300
    q, k, ks, v, vs = _inputs(1, Dh, int8, seed=11 + int8 + 2 * sliding)
    jcfg, cfg = _cfgs(Dh, W)
    pos = np.array([[fill - 1]], np.int32)
    kj, vj, ksj, vsj = _kv_j(k, ks, v, vs, int8)
    ref = jattend(jnp.asarray(q, jnp.bfloat16), kj, vj, ksj, vsj,
                  jnp.asarray(pos), jcfg, sliding=jnp.asarray(sliding),
                  interpret=True)
    kt, vt, kst, vst = _kv_t(k, ks, v, vs, int8)
    out = attend(_t(q), kt, vt, torch.from_numpy(pos).long(), cfg, kst, vst,
                 window=W if sliding else 0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


def _pool(seed, Dh, int8, ps, maxp):
    rng = np.random.default_rng(seed)
    P = B * 2 * maxp + 1
    q = _bf(rng.standard_normal((2, HQ, Dh)) * 6)
    k, ks = _cache(rng, (P, HKV, ps, Dh), int8, uniform=False)
    v, vs = _cache(rng, (P, HKV, ps, Dh), int8, uniform=True)
    table = rng.permutation(P - 1)[:2 * maxp].reshape(2, maxp) \
        .astype(np.int32)
    return q, k, ks, v, vs, table


@pytest.mark.parametrize("softcap,window", OPTS, ids=OPT_IDS)
@pytest.mark.parametrize("Dh", [128, 256])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_k6_options_match_pallas_and_xla(int8, Dh, softcap, window):
    """K6's plain version over a shuffled table (page 32, 5 pages a row;
    fills 149 and 7: a window of 96 puts the first row's floor at 53,
    inside its second page, and leaves the second row whole) against the
    TPU paged kernel, whose page map clamps the pages below the floor, and
    against ``attend_paged(force="xla")`` with the sliding flag."""
    ps, maxp, scale = 32, 5, Dh ** -0.5
    q, k, ks, v, vs, table = _pool(Dh + window + int8, Dh, int8, ps, maxp)
    lens = np.array([ps * maxp - 11, 7], np.int32)
    kj, vj, ksj, vsj = _kv_j(k, ks, v, vs, int8)
    ref = jpaged_fd(jnp.asarray(q, jnp.bfloat16), kj, vj, ksj, vsj,
                    jnp.asarray(table), jnp.asarray(lens), softcap=softcap,
                    scale=scale, window=window, interpret=True)
    jcfg, cfg = _cfgs(Dh, window, softcap)
    xla = jattend_paged(jnp.asarray(q, jnp.bfloat16)[:, None], kj, vj, ksj,
                        vsj, jnp.asarray(table),
                        jnp.asarray(lens - 1)[:, None], jcfg,
                        sliding=jnp.asarray(True), force="xla")
    kt, vt, kst, vst = _kv_t(k, ks, v, vs, int8)
    qt, tt, lt = _t(q), torch.from_numpy(table), torch.from_numpy(lens)
    plain = lambda *o: paged_decode_plain(qt, kt, vt, kst, vst, tt, lt,
                                          scale, *o)
    out = plain(softcap, window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    tol = ORACLE_TOL if int8 else dict(atol=ATOL, rtol=0)
    np.testing.assert_allclose(out.reshape(2, 1, -1).numpy(),
                               np.asarray(xla), **tol)
    wrapped = paged_decode_i8(qt, kt, vt, kst, vst, tt, lt, scale, softcap,
                              window) if int8 else \
        paged_decode(qt, kt, vt, tt, lt, scale, softcap, window)
    assert torch.equal(wrapped, out)
    disp = attend_paged(qt[:, None], kt, vt, kst, vst, tt,
                        torch.from_numpy(lens - 1).long()[:, None], cfg,
                        window)
    assert torch.equal(disp, out.reshape(2, 1, -1))
    if softcap or window:
        _moved(out, plain())


@pytest.mark.parametrize("sliding", [True, False])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_attend_paged_prefill_window_matches_jax(int8, sliding):
    """``attend_paged``'s T > 1 route (gather + K3's plain version) with the
    softcap and a per-layer window, a chunk starting mid-cache, against the
    JAX package's own route (gather + ``flash_prefill`` in interpret mode,
    the layer's flag traced)."""
    Dh, ps, maxp, T, W = 256, 64, 4, 48, 40
    q, k, ks, v, vs, table = _pool(5 + int8 + 2 * sliding, Dh, int8, ps,
                                   maxp)
    q = _bf(np.random.default_rng(9).standard_normal((2, T, HQ, Dh)) * 6)
    starts = np.asarray([64, 0], np.int32)
    pos = starts[:, None] + np.arange(T, dtype=np.int32)[None, :]
    jcfg, cfg = _cfgs(Dh, W)
    kj, vj, ksj, vsj = _kv_j(k, ks, v, vs, int8)
    ref = jattend_paged(jnp.asarray(q, jnp.bfloat16), kj, vj, ksj, vsj,
                        jnp.asarray(table), jnp.asarray(pos), jcfg,
                        sliding=jnp.asarray(sliding), interpret=True)
    kt, vt, kst, vst = _kv_t(k, ks, v, vs, int8)
    got = attend_paged(_t(q), kt, vt, kst, vst, torch.from_numpy(table),
                       torch.from_numpy(pos).long(), cfg,
                       W if sliding else 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


def test_head_dims_outside_the_kernels_raise():
    """The wrappers take head dims 128 and 256 on the card; the plain
    versions take any. The dispatch sends head dim 64 to ``attend_xla``, as
    the JAX package does, on the CPU and the card alike. An ALiBi config
    without its slopes is refused."""
    q, k, _, v, _ = _inputs(1, 64, False, seed=1)
    jcfg, cfg = _cfgs(64, 0, softcap=0.0)
    out = attend(_t(q), _t(k), _t(v), torch.tensor([[9]]), cfg)
    assert out.shape == (B, 1, HQ * 64)
    ref = jattend_xla(jnp.asarray(q), _j(k), _j(v), None, None,
                      jnp.asarray([[9]]), jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    check_head_dim(256)
    with pytest.raises(ValueError, match="head_dim"):
        check_head_dim(64)
    with pytest.raises(ValueError, match="slopes"):
        attend(_t(q), _t(k), _t(v), torch.tensor([[9]]),
               dataclasses.replace(cfg, use_alibi=True))
