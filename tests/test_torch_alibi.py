"""The ALiBi and GLM prefix-LM options of K3/K4/K6 and the ops around them,
held against the JAX package on the same numpy inputs: ``alibi_slopes``
value for value; ``layer_norm`` and ChatGLM-1's 2-D RoPE; the plain K3, K4
and K6 with ALiBi slopes, and K3 with the prefix mask, against the Pallas
kernels in interpret mode at kernel-legal shapes (the shapes of
``tests/test_chatglm1.py``'s prefix-kernel test), bf16 and int8 KV, with 8
query heads and with 6 (not a power of two: the slopes' extension), two KV
heads so that a KV head's query heads take different slopes; the dispatch
and the port's ``attend_xla`` against JAX ``attend_xla``.

Inputs: q drawn with std 6 (scaled scores reach about ±18), K normal, V in
[-1, 1]. Every case with an option on also checks that the option moves
the output by more than ten times the tolerance, so a plain version that
ignored it would fail.

Tolerance: atol 2e-3 on the f32 output, the tolerance of
``test_torch_attention_opts.py`` and for the same reason: both sides use
the same operand roundings (bf16 QK^T and PV, or the same int8 q codes and
exact int8 dot), the same f32 ALiBi term (a product, then a sum) and f32
statistics; what differs is the order of the softmax sums and where P is
rounded to bf16, which moves the output by at most 2^-9 < 2e-3 with
|v| <= 1. The port's ``attend_xla`` against JAX's: 1e-5 (both f32, sums in
another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_tpu.models.config import ModelConfig as JMC
from neural_tpu.ops.attention import (attend_xla as jattend_xla,
                                      flash_decode as jflash_decode,
                                      flash_prefill as jflash_prefill,
                                      quantize_kv as jquantize_kv)
from neural_tpu.ops.norms import layer_norm as jlayer_norm
from neural_tpu.ops.paged_attention import paged_flash_decode as jpaged_fd
from neural_tpu.ops.rope import (alibi_slopes as jalibi_slopes,
                                 apply_rope_glm1 as japply_rope_glm1,
                                 rope_freqs as jrope_freqs)

from neural_tpu_torch.models.config import ModelConfig
from neural_tpu_torch.ops.attention import (
    attend, attend_xla, flash_decode, flash_decode_i8, flash_decode_i8_plain,
    flash_decode_plain, flash_prefill, flash_prefill_i8,
    flash_prefill_i8_plain, flash_prefill_plain)
from neural_tpu_torch.ops.norms import layer_norm
from neural_tpu_torch.ops.paged_attention import (
    attend_paged, gather_pages, paged_decode, paged_decode_i8,
    paged_decode_plain)
from neural_tpu_torch.ops.rope import alibi_slopes, apply_rope_glm1

HKV, DH, S = 2, 128, 512
ATOL = 2e-3
XLA_ATOL = 1e-5
SCALE = DH ** -0.5


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


def _kv(rng, lead, int8):
    """(port k, v, k_scale, v_scale), (JAX k, v, k_scale, v_scale)."""
    k, ks = _cache(rng, (*lead, DH), int8, uniform=False)
    v, vs = _cache(rng, (*lead, DH), int8, uniform=True)
    cdt, jdt = (torch.int8, jnp.int8) if int8 else \
        (torch.bfloat16, jnp.bfloat16)
    return (_t(k, cdt), _t(v, cdt), _t(ks), _t(vs)), \
        (_j(k, jdt), _j(v, jdt), _j(ks), _j(vs))


def _moved(out, off):
    """An option on must move the output well past the tolerance."""
    assert (out - off).abs().max().item() > 10 * ATOL


@pytest.mark.parametrize("n", [1, 2, 6, 8, 12, 30, 32, 40, 64, 71])
def test_alibi_slopes_equal_jax(n):
    ours, ref = alibi_slopes(n), jalibi_slopes(n)
    assert ours.dtype == np.float32 and ours.shape == (n,)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_layer_norm_matches_jax(bias):
    """bf16 input, f32 statistics, a cast back: equal up to one bf16
    rounding of the output (2^-8 relative), where the two libraries order
    the f32 mean's sum differently."""
    rng = np.random.default_rng(int(bias))
    x = _bf(rng.standard_normal((3, 5, 64)) * 3 + 1)
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32) if bias else None
    ref = np.asarray(jlayer_norm(_j(x), jnp.asarray(w),
                                 None if b is None else jnp.asarray(b),
                                 1e-5).astype(jnp.float32))
    out = layer_norm(_t(x), torch.from_numpy(w),
                     None if b is None else torch.from_numpy(b), 1e-5)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2 ** -8,
                               atol=1e-6)


def test_glm1_rope_matches_jax():
    """ChatGLM-1's 2-D RoPE on f32 inputs at positions around the prompt
    boundary (prompt lengths 5 and 9): within f32 rounding."""
    Dh = 32
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, 4, Dh)).astype(np.float32)
    pos = np.stack([np.arange(12), np.arange(12) + 3]).astype(np.int32)
    plen = np.array([5, 9], np.int32)
    inv = jrope_freqs(Dh, Dh // 2, 10000.0)
    ref = japply_rope_glm1(jnp.asarray(x), jnp.asarray(pos),
                           jnp.asarray(plen), jnp.asarray(inv))
    out = apply_rope_glm1(torch.from_numpy(x), torch.from_numpy(pos).long(),
                          torch.from_numpy(plen), torch.from_numpy(inv))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


HEADS = [8, 6]


@pytest.mark.parametrize("Hq", HEADS)
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_k4_alibi_matches_pallas(int8, Hq):
    """K4's plain version at fill 300 with ALiBi slopes against the TPU
    kernel (128-key blocks)."""
    fill = 300
    rng = np.random.default_rng(Hq + int8)
    q = _bf(rng.standard_normal((1, Hq, DH)) * 6)
    (kt, vt, kst, vst), (kj, vj, ksj, vsj) = _kv(rng, (1, HKV, S), int8)
    sl = alibi_slopes(Hq)
    lengths = np.array([fill], np.int32)
    ref = jflash_decode(_j(q), kj, vj, ksj, vsj, jnp.asarray(lengths),
                        slopes=jnp.asarray(sl), blk_s=128, scale=SCALE,
                        interpret=True)
    qt, lt, st = _t(q), torch.from_numpy(lengths), torch.from_numpy(sl)
    if int8:
        plain = lambda s=None: flash_decode_i8_plain(
            qt, kt, vt, kst, vst, lt, SCALE, slopes=s)
        wrapped = flash_decode_i8(qt, kt, vt, kst, vst, lt, SCALE, slopes=st)
    else:
        plain = lambda s=None: flash_decode_plain(qt, kt, vt, lt, SCALE,
                                                  slopes=s)
        wrapped = flash_decode(qt, kt, vt, lt, SCALE, slopes=st)
    out = plain(st)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    assert torch.equal(wrapped, out)       # the wrapper's CPU route
    _moved(out, plain())


@pytest.mark.parametrize("Hq", HEADS)
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_k3_alibi_matches_pallas(int8, Hq):
    """K3's plain version on a 128-token chunk at offset 100 with ALiBi
    slopes against the TPU kernel (128-row query tiles, 256-key blocks)."""
    T, start = 128, 100
    rng = np.random.default_rng(10 + Hq + int8)
    q = _bf(rng.standard_normal((1, T, Hq, DH)) * 6)
    (kt, vt, kst, vst), (kj, vj, ksj, vsj) = _kv(rng, (1, HKV, S), int8)
    sl = alibi_slopes(Hq)
    starts = np.array([start], np.int32)
    ref = np.asarray(jflash_prefill(
        _j(q), kj, vj, ksj, vsj, starts=jnp.asarray(starts),
        slopes=jnp.asarray(sl), blk_t=128, blk_s=256, scale=SCALE,
        interpret=True))
    qt, s0, st = _t(q), torch.from_numpy(starts), torch.from_numpy(sl)
    if int8:
        plain = lambda s=None: flash_prefill_i8_plain(
            qt, kt, vt, kst, vst, s0, SCALE, slopes=s)
        wrapped = flash_prefill_i8(qt, kt, vt, kst, vst, s0, SCALE, slopes=st)
    else:
        plain = lambda s=None: flash_prefill_plain(qt, kt, vt, s0, SCALE,
                                                   slopes=s)
        wrapped = flash_prefill(qt, kt, vt, s0, SCALE, slopes=st)
    out = plain(st)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)
    assert torch.equal(wrapped, out)
    _moved(out, plain())


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_k3_prefix_matches_pallas(int8):
    """K3's plain version with the GLM prefix mask at ChatGLM-1's kernel
    test shapes (8 heads, T = 128 from position 0, prefix 96: keys 0..94
    visible to every row) against the TPU kernel, whose S-block clamp
    extends to the prefix."""
    Hq, T, P = 8, 128, 96
    rng = np.random.default_rng(20 + int8)
    q = _bf(rng.standard_normal((1, T, Hq, DH)) * 6)
    (kt, vt, kst, vst), (kj, vj, ksj, vsj) = _kv(rng, (1, Hq, S), int8)
    starts, plen = np.zeros(1, np.int32), np.array([P], np.int32)
    ref = np.asarray(jflash_prefill(
        _j(q), kj, vj, ksj, vsj, starts=jnp.asarray(starts), blk_t=128,
        blk_s=256, scale=SCALE, prefix_len=jnp.asarray(plen),
        interpret=True))
    qt, s0, pt = _t(q), torch.from_numpy(starts), torch.from_numpy(plen)
    if int8:
        plain = lambda p=None: flash_prefill_i8_plain(
            qt, kt, vt, kst, vst, s0, SCALE, prefix_len=p)
        wrapped = flash_prefill_i8(qt, kt, vt, kst, vst, s0, SCALE,
                                   prefix_len=pt)
    else:
        plain = lambda p=None: flash_prefill_plain(qt, kt, vt, s0, SCALE,
                                                   prefix_len=p)
        wrapped = flash_prefill(qt, kt, vt, s0, SCALE, prefix_len=pt)
    out = plain(pt)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)
    assert torch.equal(wrapped, out)
    _moved(out, plain())
    # rows at or past P - 2 see what causal rows see; a 0 turns it off
    assert torch.equal(out[:, P - 2:], plain()[:, P - 2:])
    assert torch.equal(plain(torch.zeros(1, dtype=torch.int32)), plain())


@pytest.mark.parametrize("Hq", HEADS)
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_k6_alibi_matches_pallas(int8, Hq):
    """K6's plain version over a shuffled table (page 32, 5 pages a row;
    fills 149 and 7) with ALiBi slopes against the TPU paged kernel."""
    ps, maxp = 32, 5
    P = 2 * maxp + 1
    rng = np.random.default_rng(30 + Hq + int8)
    q = _bf(rng.standard_normal((2, Hq, DH)) * 6)
    (kt, vt, kst, vst), (kj, vj, ksj, vsj) = _kv(rng, (P, HKV, ps), int8)
    table = rng.permutation(P - 1)[:2 * maxp].reshape(2, maxp) \
        .astype(np.int32)
    lens = np.array([ps * maxp - 11, 7], np.int32)
    sl = alibi_slopes(Hq)
    ref = jpaged_fd(_j(q), kj, vj, ksj, vsj, jnp.asarray(table),
                    jnp.asarray(lens), slopes=jnp.asarray(sl), scale=SCALE,
                    interpret=True)
    qt, tt, lt = _t(q), torch.from_numpy(table), torch.from_numpy(lens)
    st = torch.from_numpy(sl)
    plain = lambda s=None: paged_decode_plain(qt, kt, vt, kst, vst, tt, lt,
                                              SCALE, slopes=s)
    out = plain(st)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    wrapped = paged_decode_i8(qt, kt, vt, kst, vst, tt, lt, SCALE,
                              slopes=st) if int8 else \
        paged_decode(qt, kt, vt, tt, lt, SCALE, slopes=st)
    assert torch.equal(wrapped, out)
    _moved(out, plain())


def _cfgs(Hq, **kw):
    kw = dict(n_heads=Hq, n_kv_heads=HKV, head_dim=DH, **kw)
    return JMC(**kw), ModelConfig(**kw)


@pytest.mark.parametrize("T,fill", [(1, 300), (130, 330)],
                         ids=["decode", "prefill"])
def test_attend_alibi_matches_attend_xla(T, fill):
    """The dispatch (K4 or K3's plain version) and the port's
    ``attend_xla`` with the model's slopes against JAX ``attend_xla``, 6
    heads."""
    Hq = 6
    rng = np.random.default_rng(T)
    q = _bf(rng.standard_normal((1, T, Hq, DH)) * 6)
    (kt, vt, _, _), (kj, vj, _, _) = _kv(rng, (1, HKV, S), False)
    jcfg, cfg = _cfgs(Hq, use_alibi=True)
    sl = alibi_slopes(Hq)
    pos = (fill - T + np.arange(T, dtype=np.int32))[None]
    ref = np.asarray(jattend_xla(_j(q), kj, vj, None, None, jnp.asarray(pos),
                                 jcfg, slopes=jnp.asarray(sl)))
    args = (_t(q), kt, vt, torch.from_numpy(pos).long(), cfg)
    st = torch.from_numpy(sl)
    np.testing.assert_allclose(attend(*args, slopes=st).numpy(), ref,
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(attend_xla(*args, slopes=st).numpy(), ref,
                               rtol=0, atol=XLA_ATOL)
    with pytest.raises(ValueError, match="slopes"):
        attend(*args)


def test_attend_prefix_matches_attend_xla():
    """A prefix-LM prefill (prompt of 40 from position 0, prefix 40)
    through the dispatch and the port's ``attend_xla`` against JAX
    ``attend_xla``; the paged dispatch over the same keys in a shuffled
    page pool gives the contiguous dispatch's output (the prefix mask
    reaches K3 in paged prefill too); decode (T = 1) ignores the prefix."""
    Hq, T, ps = 8, 40, 16
    rng = np.random.default_rng(5)
    q = _bf(rng.standard_normal((1, T, Hq, DH)) * 6)
    P = 6
    (kt, vt, _, _), (kj, vj, _, _) = _kv(rng, (P, HKV, ps), False)
    table = np.array([[4, 1, 3, 0]], np.int32)
    jcfg, cfg = _cfgs(Hq, prefix_lm=True)
    pos = np.arange(T, dtype=np.int32)[None]
    plen = np.array([T], np.int32)
    kc, vc = gather_pages(kt, torch.from_numpy(table)), \
        gather_pages(vt, torch.from_numpy(table))
    ref = np.asarray(jattend_xla(
        _j(q), jnp.asarray(kc.float().numpy(), jnp.bfloat16),
        jnp.asarray(vc.float().numpy(), jnp.bfloat16), None, None,
        jnp.asarray(pos), jcfg, prefix_len=jnp.asarray(plen)))
    pt, post = torch.from_numpy(plen), torch.from_numpy(pos).long()
    out = attend(_t(q), kc, vc, post, cfg, prefix_len=pt)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        attend_xla(_t(q), kc, vc, post, cfg, prefix_len=pt).numpy(), ref,
        rtol=0, atol=XLA_ATOL)
    paged = attend_paged(_t(q), kt, vt, None, None, torch.from_numpy(table),
                         post, cfg, prefix_len=pt)
    assert torch.equal(paged, out)
    _moved(out, attend(_t(q), kc, vc, post, cfg))
    one = attend(_t(q)[:, -1:], kc, vc, post[:, -1:], cfg, prefix_len=pt)
    assert torch.equal(one, attend(_t(q)[:, -1:], kc, vc, post[:, -1:], cfg))
