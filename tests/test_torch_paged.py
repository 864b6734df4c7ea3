"""Paged KV cache: the allocator, the paged forward against the contiguous
one, ``paged_update_kv`` against the JAX package's, and K6's plain version
against the JAX Pallas paged kernel (interpret mode) and its XLA oracle.

Tolerances:
- the paged forward equals the contiguous forward exactly: the gathered
  view holds the same keys, and keys past the fill score -1e30 and weigh
  exactly 0 on both sides;
- ``paged_update_kv``: codes, scales and pool bytes equal;
- K6 (plain) against JAX ``paged_flash_decode(interpret=True)``: atol
  2e-3, K3/K4's tolerance in ``test_torch_kv8.py`` (the same arithmetic,
  int8 q quantized per row the same way; the sums run in another order,
  and v lies in [-1, 1]);
- K6 (plain) against ``attend_paged(force="xla")``: atol 4e-2, rtol 3e-2,
  the tolerance ``tests/test_paged.py`` gives its kernel against the same
  oracle (the int8 variants quantize q per row, the oracle does not);
- paged prefill (gather + K3's plain version) against JAX's own paged
  prefill route (gather + ``flash_prefill``, interpret mode): atol 2e-3,
  K3's tolerance in ``test_torch_attention.py`` (V in [-1, 1]).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_tpu.models.config import ModelConfig as JMC
from neural_tpu.ops.attention import quantize_kv as jquantize_kv
from neural_tpu.ops.paged_attention import (attend_paged as jattend_paged,
                                            paged_flash_decode as jpaged_fd,
                                            paged_update_kv as jpaged_update)

from neural_tpu_torch.models.config import ModelConfig
from neural_tpu_torch.ops.paged_attention import (
    attend_paged, gather_pages, gather_scales, paged_decode,
    paged_decode_i8, paged_decode_plain, paged_update_kv)
from neural_tpu_torch.runtime.kvcache import init_cache
from neural_tpu_torch.runtime.paged import (PageAllocator, init_paged_cache,
                                            pages_needed)
from test_torch_bridge import to_np
from test_torch_serving import bridged

KERNEL_TOL = dict(atol=2e-3, rtol=0)
ORACLE_TOL = dict(atol=4e-2, rtol=3e-2)
B, HQ, HKV, DH = 2, 8, 2, 128


def test_allocator():
    a = PageAllocator(8)
    p1 = a.alloc(3)
    p2 = a.alloc(5)
    assert len(p1) == 3 and len(p2) == 5 and a.n_free == 0
    assert set(p1) | set(p2) == set(range(8))
    assert a.alloc(1) is None
    a.release(p1)
    assert a.n_free == 3
    with pytest.raises(RuntimeError):
        a.release(list(range(6)))
    assert pages_needed(1, 256) == 1 and pages_needed(257, 256) == 2


@pytest.fixture(scope="module")
def model():
    _, _, params, cfg = bridged(n_kv_heads=2, max_seq_len=512)
    return params, cfg


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.int8],
                         ids=["bf16", "int8"])
def test_paged_forward_matches_contiguous(model, kv_dtype):
    """Prefill + 3 decode steps through a SHUFFLED page table equal the
    contiguous cache bit for bit."""
    params, cfg = model
    rng = np.random.default_rng(0)
    Bn, T, S, ps = 2, 17, 256, 64
    toks = torch.from_numpy(rng.integers(1, 128, (Bn, T)))
    start = torch.zeros(Bn, dtype=torch.long)
    cache = init_cache(cfg, Bn, S, kv_dtype, device="cpu")
    pool = init_paged_cache(cfg, Bn, S, page_size=ps, dtype=kv_dtype,
                            device="cpu")
    maxp = S // ps
    perm = rng.permutation(Bn * maxp).reshape(Bn, maxp).astype(np.int32)
    pool.table.copy_(torch.from_numpy(perm))
    with torch.inference_mode():
        ref = params(toks, start, cache)
        got = params(toks, start, pool)
        assert torch.equal(got, ref)
        tok = torch.argmax(ref[:, -1], -1)[:, None]
        for i in range(3):
            p = torch.full((Bn,), T + i, dtype=torch.long)
            ref = params(tok, p, cache)
            got = params(tok, p, pool)
            assert torch.equal(got, ref)
            tok = torch.argmax(ref[:, -1], -1)[:, None]
    # the pool rows behind the table hold the contiguous cache's bytes
    fill = T + 3
    for c, pl in ((cache.k, pool.k), (cache.v, pool.v),
                  (cache.k_scale, pool.k_scale)):
        if c is None:
            continue
        view = torch.stack([gather_scales(pl[l], pool.table) if c.ndim == 4
                            else gather_pages(pl[l], pool.table)
                            for l in range(cfg.n_layers)])
        assert torch.equal(view[:, :, :, :fill], c[:, :, :, :fill])


@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("T,start", [(1, 37), (1, 48), (20, 16), (32, 0)],
                         ids=["decode", "decode_page_edge", "prefill_tail",
                              "prefill_whole_pages"])
def test_paged_update_kv_equals_jax(kv_int8, T, start):
    rng = np.random.default_rng(T + start)
    P, H, ps, Dh, maxp = 9, 2, 16, 32, 4
    Bn = 2
    table = rng.permutation(P).reshape(1, -1)[:, :Bn * maxp] \
        .reshape(Bn, maxp).astype(np.int32)
    k_new = (rng.standard_normal((Bn, H, T, Dh)) * 2).astype(np.float32)
    v_new = rng.standard_normal((Bn, H, T, Dh)).astype(np.float32)
    k_new = np.array(jnp.asarray(k_new, jnp.bfloat16).astype(jnp.float32))
    v_new = np.array(jnp.asarray(v_new, jnp.bfloat16).astype(jnp.float32))
    dt = jnp.int8 if kv_int8 else jnp.bfloat16
    shape = (1, P, H, ps, Dh)
    jk = jnp.asarray(rng.integers(-5, 5, shape), dt)
    jv = jnp.asarray(rng.integers(-5, 5, shape), dt)
    jks = jnp.ones(shape[:-1], jnp.bfloat16) if kv_int8 else None
    jvs = jnp.ones(shape[:-1], jnp.bfloat16) if kv_int8 else None
    starts = np.array([start, start], np.int32)
    outs = jpaged_update(jk, jv, jks, jvs,
                         jnp.asarray(k_new, jnp.bfloat16),
                         jnp.asarray(v_new, jnp.bfloat16),
                         jnp.asarray(table), jnp.asarray(starts), 0)
    tdt = torch.int8 if kv_int8 else torch.bfloat16
    pools = [torch.from_numpy(np.array(a[0]).astype(np.float32)).to(tdt)
             if i < 2 else torch.ones(shape[1:-1], dtype=torch.bfloat16)
             for i, a in enumerate((jk, jv, jks, jvs)) if a is not None]
    if not kv_int8:
        pools += [None, None]
    paged_update_kv(*pools, torch.from_numpy(k_new).bfloat16(),
                    torch.from_numpy(v_new).bfloat16(),
                    torch.from_numpy(table), torch.from_numpy(starts))
    for got, want in zip(pools, outs):
        if got is None:
            assert want is None
            continue
        want = np.asarray(want[0])
        got = to_np(got)
        np.testing.assert_array_equal(got, want.view(np.uint16)
                                      if want.dtype == jnp.bfloat16 else want)


def _pool_inputs(rng, P, ps, kv_int8):
    if kv_int8:
        out = []
        for lo, hi in ((-3, 3), (-1, 1)):
            x = rng.uniform(lo, hi, (P, HKV, ps, DH)).astype(np.float32)
            c, s = jquantize_kv(jnp.asarray(x))
            out += [np.array(c), np.array(s.astype(jnp.float32))]
        return out[0], out[2], out[1], out[3]
    k = np.array(jnp.asarray(rng.standard_normal((P, HKV, ps, DH)),
                             jnp.bfloat16).astype(jnp.float32))
    v = np.array(jnp.asarray(rng.uniform(-1, 1, (P, HKV, ps, DH)),
                             jnp.bfloat16).astype(jnp.float32))
    return k, v, None, None


def _tt(a, dt):
    return None if a is None else torch.from_numpy(a).to(dt)


def _jj(a, dt):
    return None if a is None else jnp.asarray(a, dt)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("ps,maxp", [(16, 12), (32, 5)])
def test_k6_plain_matches_pallas_and_xla(kv_int8, ps, maxp):
    rng = np.random.default_rng(ps + kv_int8)
    P = B * maxp + 1
    q = np.array(jnp.asarray(rng.standard_normal((B, HQ, DH)), jnp.bfloat16)
                 .astype(jnp.float32))
    k, v, ks, vs = _pool_inputs(rng, P, ps, kv_int8)
    table = rng.permutation(P - 1)[:B * maxp].reshape(B, maxp) \
        .astype(np.int32)
    lens = np.array([ps * maxp - 11, 7], np.int32)
    cdt = jnp.int8 if kv_int8 else jnp.bfloat16
    ref = jpaged_fd(jnp.asarray(q), _jj(k, cdt), _jj(v, cdt),
                    _jj(ks, jnp.bfloat16), _jj(vs, jnp.bfloat16),
                    jnp.asarray(table), jnp.asarray(lens), interpret=True)
    jcfg = JMC(n_heads=HQ, n_kv_heads=HKV, head_dim=DH)
    xla = jattend_paged(jnp.asarray(q)[:, None], _jj(k, cdt), _jj(v, cdt),
                        _jj(ks, jnp.bfloat16), _jj(vs, jnp.bfloat16),
                        jnp.asarray(table), jnp.asarray(lens - 1)[:, None],
                        jcfg, force="xla").reshape(B, HQ, DH)
    tdt = torch.int8 if kv_int8 else torch.bfloat16
    args = [torch.from_numpy(q).bfloat16(), _tt(k, tdt), _tt(v, tdt),
            _tt(ks, torch.bfloat16), _tt(vs, torch.bfloat16),
            torch.from_numpy(table), torch.from_numpy(lens)]
    out = paged_decode_plain(*args, DH ** -0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **KERNEL_TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(xla), **ORACLE_TOL)
    # the wrappers and the dispatch take the plain version on the CPU
    wrapped = paged_decode_i8(*args, DH ** -0.5) if kv_int8 else \
        paged_decode(args[0], args[1], args[2], args[5], args[6],
                     DH ** -0.5)
    assert torch.equal(wrapped, out)
    cfg = ModelConfig(n_heads=HQ, n_kv_heads=HKV, head_dim=DH)
    disp = attend_paged(args[0][:, None], *args[1:6],
                        torch.from_numpy(lens - 1).long()[:, None], cfg)
    assert torch.equal(disp, out.reshape(B, 1, -1))


@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16", "int8"])
def test_paged_prefill_matches_jax_route(kv_int8):
    """attend_paged's T > 1 route (gather + K3's plain version) against the
    JAX package's (gather + flash_prefill, interpret mode), chunked-prefill
    shape: the chunk starts mid-cache."""
    rng = np.random.default_rng(3 + kv_int8)
    ps, maxp, T = 256, 2, 48
    P = B * maxp + 1
    q = np.array(jnp.asarray(rng.standard_normal((B, T, HQ, DH)),
                             jnp.bfloat16).astype(jnp.float32))
    k, v, ks, vs = _pool_inputs(rng, P, ps, kv_int8)
    table = rng.permutation(P - 1)[:B * maxp].reshape(B, maxp) \
        .astype(np.int32)
    starts = np.asarray([64, 0], np.int32)
    pos = starts[:, None] + np.arange(T, dtype=np.int32)[None, :]
    cdt = jnp.int8 if kv_int8 else jnp.bfloat16
    jcfg = JMC(n_heads=HQ, n_kv_heads=HKV, head_dim=DH)
    ref = jattend_paged(jnp.asarray(q), _jj(k, cdt), _jj(v, cdt),
                        _jj(ks, jnp.bfloat16), _jj(vs, jnp.bfloat16),
                        jnp.asarray(table), jnp.asarray(pos), jcfg,
                        interpret=True)
    tdt = torch.int8 if kv_int8 else torch.bfloat16
    cfg = ModelConfig(n_heads=HQ, n_kv_heads=HKV, head_dim=DH)
    got = attend_paged(torch.from_numpy(q).bfloat16(), _tt(k, tdt),
                       _tt(v, tdt), _tt(ks, torch.bfloat16),
                       _tt(vs, torch.bfloat16), torch.from_numpy(table),
                       torch.from_numpy(pos).long(), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-3)
