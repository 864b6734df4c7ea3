"""int8 KV cache: ``quantize_kv``, the int8 variants of K3/K4 (plain
versions) and ``Model.generate(kv_dtype="int8")``, each against the JAX
package on the same numpy inputs.

- ``quantize_kv``: codes and bf16 scales equal.
- K4-int8 / K3-int8 plain versions against the JAX ``flash_decode`` /
  ``flash_prefill`` Pallas kernels with int8 scales (interpret mode), and
  against ``attend_xla`` over the dequantized cache. Both sides quantize q
  per row and take the same exact int8 dot; what differs is the order of
  the f32 softmax sums (per 256/512-key block in the kernel, once here),
  and for prefill where P is rounded to bf16 (against the running max in
  the kernel, against the final max here). V is drawn in [-1, 1], so the
  output moves by at most 2^-9 from P's rounding: ATOL 2e-3, as in
  ``test_torch_attention.py``. ``attend_xla`` keeps q unquantized; q's
  int8 rounding moves scores by ~0.4%, and its tolerance is the one
  ``tests/test_paged.py`` gives the same comparison (atol 4e-2, rtol 3e-2).
- ``Model.generate(kv_dtype="int8")``: greedy ids equal over the prefix
  where JAX's penalized top-2 margin stays above the logit tolerance of
  ``test_torch_model.py``.
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
from neural_tpu.runtime.generate import model_step as jmodel_step
from neural_tpu.runtime.generate import prefill_step as jprefill_step
from neural_tpu.runtime.kvcache import init_cache as jinit_cache
from neural_tpu.runtime.sampling import (SamplingParams as JSP,
                                         apply_penalties as japply_penalties,
                                         token_counts as jtoken_counts)

from neural_tpu_torch.models.config import ModelConfig
from neural_tpu_torch.ops.attention import (
    attend, attend_xla, flash_decode_i8, flash_decode_i8_plain,
    flash_prefill_i8, flash_prefill_i8_plain, quantize_kv)
from neural_tpu_torch.runtime.kvcache import init_cache
from neural_tpu_torch.runtime.generate import model_step, prefill_step
from test_torch_bridge import to_np
from test_torch_model import REL_TOL, VOCAB, pair  # noqa: F401 (fixture)

B, HQ, HKV, DH = 1, 4, 2, 128
ATOL = 2e-3
XLA_TOL = dict(atol=4e-2, rtol=3e-2)
SCALE = DH ** -0.5


def _bf(a):
    return np.array(jnp.asarray(a.astype(np.float32), jnp.bfloat16))


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a).astype(np.float32)))


def _i8_cache(rng, S, uniform):
    """JAX-quantized int8 codes [B, Hkv, S, Dh] and bf16 scales, as numpy
    (scales as f32 values)."""
    x = rng.uniform(-1, 1, (B, HKV, S, DH)) if uniform else \
        rng.standard_normal((B, HKV, S, DH))
    q, s = jquantize_kv(jnp.asarray(x.astype(np.float32)))
    return np.array(q), np.array(s.astype(jnp.float32))


def _inputs(T, S, seed):
    rng = np.random.default_rng(seed)
    q = _bf(rng.standard_normal((B, T, HQ, DH)))
    k, ks = _i8_cache(rng, S, uniform=False)
    v, vs = _i8_cache(rng, S, uniform=True)
    return q, k, ks, v, vs


def _jbf(a):
    return jnp.asarray(a, jnp.bfloat16)


def _cfg():
    return JMC(n_heads=HQ, n_kv_heads=HKV, head_dim=DH), \
        ModelConfig(n_heads=HQ, n_kv_heads=HKV, head_dim=DH)


@pytest.mark.parametrize("shape", [(3, 5, 128), (2, 7, 64), (1, 1, 16)])
def test_quantize_kv_equals_jax(shape):
    rng = np.random.default_rng(sum(shape))
    x = _bf(rng.standard_normal(shape) * 3)
    x[0, 0] = 0.0                     # an all-zero row: scale 1e-9 in bf16
    jq, js = jquantize_kv(jnp.asarray(x))
    q, s = quantize_kv(_t(x).bfloat16())
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(to_np(s), np.asarray(js).view(np.uint16))


@pytest.mark.parametrize("fill", [1, 200, 512])
def test_k4_i8_plain_matches_pallas_and_xla(fill):
    S = 512
    q, k, ks, v, vs = _inputs(1, S, seed=fill)
    lengths = np.array([fill], np.int32)
    ref = jflash_decode(jnp.asarray(q[:, 0]), jnp.asarray(k), jnp.asarray(v),
                        _jbf(ks), _jbf(vs), jnp.asarray(lengths), blk_s=256,
                        interpret=True)
    args = (_t(q[:, 0]).bfloat16(), torch.from_numpy(k), torch.from_numpy(v),
            _t(ks).bfloat16(), _t(vs).bfloat16(), torch.from_numpy(lengths))
    out = flash_decode_i8_plain(*args, SCALE)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    assert torch.equal(flash_decode_i8(*args, SCALE), out)
    jcfg, cfg = _cfg()
    pos = np.array([[fill - 1]], np.int32)
    xla = jattend_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      _jbf(ks), _jbf(vs), jnp.asarray(pos), jcfg)
    np.testing.assert_allclose(out.reshape(B, 1, -1).numpy(),
                               np.asarray(xla), **XLA_TOL)
    # the dispatch takes K4's int8 variant for an int8 cache
    disp = attend(_t(q).bfloat16(), args[1], args[2],
                  torch.from_numpy(pos).long(), cfg, args[3], args[4])
    assert torch.equal(disp, out.reshape(B, 1, -1))


@pytest.mark.parametrize("start,T", [(0, 512), (0, 130), (200, 130)],
                         ids=["full", "fill130", "offset200"])
def test_k3_i8_plain_matches_pallas_and_xla(start, T):
    S = 512
    q, k, ks, v, vs = _inputs(T, S, seed=T + start)
    starts = np.array([start], np.int32)
    Tp = -(-T // 128) * 128
    qp = np.pad(q, ((0, 0), (0, Tp - T), (0, 0), (0, 0)))
    ref = np.asarray(jflash_prefill(
        jnp.asarray(qp), jnp.asarray(k), jnp.asarray(v), _jbf(ks), _jbf(vs),
        starts=jnp.asarray(starts), blk_t=128, blk_s=512,
        interpret=True))[:, :T]
    args = (_t(q).bfloat16(), torch.from_numpy(k), torch.from_numpy(v),
            _t(ks).bfloat16(), _t(vs).bfloat16(), torch.from_numpy(starts))
    out = flash_prefill_i8_plain(*args, SCALE)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)
    assert torch.equal(flash_prefill_i8(*args, SCALE), out)
    jcfg, cfg = _cfg()
    pos = start + np.arange(T, dtype=np.int32)[None]
    xla = jattend_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      _jbf(ks), _jbf(vs), jnp.asarray(pos), jcfg)
    np.testing.assert_allclose(out.reshape(B, T, -1).numpy(),
                               np.asarray(xla), **XLA_TOL)
    port_xla = attend_xla(args[0], args[1], args[2],
                          torch.from_numpy(pos).long(), cfg, args[3], args[4])
    np.testing.assert_allclose(port_xla.numpy(), np.asarray(xla), atol=1e-5)


def test_int8_cache_forward_logits(pair):  # noqa: F811
    """Prefill and 6 decode steps over int8 caches in both packages, fed the
    same tokens: the model-level tolerance of test_torch_model.py."""
    _, jm, pm, _ = pair
    ids = np.random.default_rng(4).integers(3, VOCAB, 40).tolist()
    S = 48
    jc = jinit_cache(jm.cfg, 1, S, "int8")
    pc = init_cache(pm.cfg, 1, S, torch.int8, device="cpu")
    assert pc.k.dtype == torch.int8 and pc.k_scale.shape == (2, 1, 1, S)
    jl, jc = jprefill_step(jm.params, jnp.asarray([ids], jnp.int32),
                           jnp.zeros((1,), jnp.int32), jc, jm.cfg)
    pl = prefill_step(pm.params, torch.tensor([ids]),
                      torch.zeros(1, dtype=torch.long), pc)

    def close(out, ref):
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(np.asarray(out, np.float32), ref, rtol=0,
                                   atol=REL_TOL * np.abs(ref).max())
    close(pl.numpy(), jl)
    tok = int(np.argmax(np.asarray(jl)[0, -1]))
    for s in range(6):
        jl, jc = jmodel_step(jm.params, jnp.asarray([[tok]], jnp.int32),
                             jnp.asarray([40 + s], jnp.int32), jc, jm.cfg)
        pl = model_step(pm.params, torch.tensor([[tok]]),
                        torch.tensor([40 + s]), pc)
        close(pl.numpy(), jl)
        tok = int(np.argmax(np.asarray(jl)[0, -1]))


def _jax_margins_i8(jm, ids, new):
    """JAX's penalized top-1/top-2 margin at each generated step over an
    int8 cache, replaying ``runtime.generate.generate``'s penalties."""
    sp = JSP(greedy=True)
    T = len(ids)
    jc = jinit_cache(jm.cfg, 1, T + len(new), "int8")
    logits, jc = jprefill_step(jm.params, jnp.asarray([ids], jnp.int32),
                               jnp.zeros((1,), jnp.int32), jc, jm.cfg)
    out, margins = list(ids), []
    for i, tok in enumerate(new):
        hist = jnp.asarray([out[-sp.repeat_last_n:]], jnp.int32)
        counts = jtoken_counts(hist, jnp.ones(hist.shape, bool), VOCAB)
        pen = np.sort(np.asarray(japply_penalties(
            logits[:, -1].astype(jnp.float32), counts, sp))[0])
        margins.append((pen[-1] - pen[-2], np.abs(pen).max()))
        out.append(tok)
        logits, jc = jmodel_step(jm.params, jnp.asarray([[tok]], jnp.int32),
                                 jnp.asarray([T + i], jnp.int32), jc, jm.cfg)
    return margins


@pytest.mark.parametrize("T", [12, 300])
def test_generate_int8_kv_ids_match_jax(pair, T):  # noqa: F811
    _, jm, pm, _ = pair
    ids = np.random.default_rng({12: 12007, 300: 300005}[T]).integers(
        3, VOCAB, T).tolist()
    n_new = 10
    jout = jm.generate(ids, max_new_tokens=n_new, do_sample=False,
                       stop_at_eos=False, kv_dtype="int8")[0]
    pout = pm.generate(ids, max_new_tokens=n_new, do_sample=False,
                       stop_at_eos=False, kv_dtype="int8")[0]
    assert pout[:T] == ids and len(pout) == T + n_new
    jnew, pnew = jout[T:], pout[T:]
    margins = _jax_margins_i8(jm, ids, jnew)
    safe = next((i for i, (m, scale) in enumerate(margins)
                 if m < REL_TOL * scale), len(margins))
    assert safe >= 3, margins
    assert pnew[:safe] == jnew[:safe], (pnew, jnew, margins)
