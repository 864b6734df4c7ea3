"""RoPE scalings, head dims that are not a multiple of 128, and decode at
more than 8 query heads per KV head, in the port against the JAX package:

- ``rope_freqs`` for every scaling kind, value for value in f32; a tiny
  Llama at head dim 64 with linear scaling (factor 4, as long-context
  Llama-2 fine-tunes ship it) through both ``Model.generate``;
- ``attend`` and ``attend_paged`` at head dims 64, 80 and 96, which both
  packages send to ``attend_xla`` (the port counts the route), against JAX
  ``attend_xla``;
- the plain versions of K4 and K6 at G = 16 (ChatGLM-2's 32 heads over 2)
  and G = 48 (StarCoder's multi-query 48 over 1), bf16 and int8 KV, against
  the Pallas kernels in interpret mode.

Tolerances: the frequency tables exactly (both compute in float64 and
round once to float32); attention atol 2e-3 on the f32 output
(``test_torch_attention_opts.py``'s, for the same reasons: bf16 P against
unrounded P, |v| <= 1; against ``attend_xla`` over int8 caches the two
f32 references differ only in the order of sums); the model
``test_torch_mixed.py``'s rule.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from neural_tpu.api import Model as JModel
from neural_tpu.models.config import ModelConfig as JMC
from neural_tpu.ops.attention import (attend_xla as jattend_xla,
                                      flash_decode as jflash_decode,
                                      quantize_kv as jquantize_kv)
from neural_tpu.ops.paged_attention import (gather_pages as jgather_pages,
                                            gather_scales as jgather_scales,
                                            paged_flash_decode as jpaged_fd)
from neural_tpu.ops.rope import rope_freqs as jrope_freqs
from neural_tpu.runtime.generate import params_to_native as jparams_to_native

from neural_tpu_torch.api import Model
from neural_tpu_torch.models.config import ModelConfig
from neural_tpu_torch.ops import _cuda
from neural_tpu_torch.ops.attention import (
    attend, check_head_dim, flash_decode, flash_decode_i8,
    flash_decode_i8_plain, flash_decode_plain)
from neural_tpu_torch.ops.paged_attention import (attend_paged,
                                                  paged_decode,
                                                  paged_decode_i8,
                                                  paged_decode_plain)
from neural_tpu_torch.ops.rope import rope_freqs
from test_torch_model import VOCAB
from test_torch_mixed import check_against_jax

ATOL = 2e-3

SCALINGS = {
    "none": (None, None),
    "linear": ({"type": "linear", "factor": 4.0}, None),
    "rope_type_linear": ({"rope_type": "linear", "factor": 2.5}, None),
    # the long/short factors have one entry per rotated pair: LONG below
    "longrope": ({"type": "longrope", "long_factor": "LONG",
                  "short_factor": "ONES"}, None),
    "su": ({"type": "su", "long_factor": "LONG", "short_factor": "ONES"},
           None),
    "yarn": ({"type": "yarn", "factor": 4.0,
              "original_max_position_embeddings": 4096}, None),
    "yarn_betas": ({"rope_type": "yarn", "factor": 8.0, "beta_fast": 16,
                    "beta_slow": 2}, None),
    "llama3": ({"rope_type": "llama3", "factor": 8.0,
                "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                "original_max_position_embeddings": 8192}, None),
    "dynamic_within": ({"type": "dynamic", "factor": 2.0,
                        "max_position_embeddings": 4096}, 4096),
    "dynamic_beyond": ({"type": "dynamic", "factor": 2.0,
                        "original_max_position_embeddings": 2048}, 16384),
    "dynamic_no_window": ({"type": "dynamic", "factor": 3.0}, None),
}


@pytest.mark.parametrize("rope_dim", [None, 32])
@pytest.mark.parametrize("kind", list(SCALINGS))
def test_rope_freqs_equal_jax(kind, rope_dim):
    scaling, max_seq_len = SCALINGS[kind]
    half = (rope_dim or 96) // 2
    fill = {"LONG": list(np.linspace(1.0, 8.0, half)), "ONES": [1.0] * half}
    scaling = scaling and {k: fill.get(v, v) if isinstance(v, str) else v
                           for k, v in scaling.items()}
    args = (96, rope_dim, 500000.0 if kind == "llama3" else 10000.0,
            scaling)
    got = rope_freqs(*args, max_seq_len=max_seq_len)
    want = jrope_freqs(*args, max_seq_len=max_seq_len)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, np.asarray(want))
    if kind == "dynamic_beyond":       # the table did move
        assert not np.array_equal(got, rope_freqs(96, rope_dim, 10000.0))


def test_unknown_scaling_raises():
    with pytest.raises(ValueError, match="rope scaling"):
        rope_freqs(64, None, 10000.0, {"type": "ntk-by-parts"})


def test_linear_scaled_llama_head_dim_64_matches_jax():
    """A tiny Llama at head dim 64 (hidden 256 over 4 heads, as TinyLlama's
    and Llama-3.2-1B's head dim) with ``rope_scaling={"type": "linear",
    "factor": 4.0}`` through both ``Model.generate``: the port builds it,
    its attention takes ``attend_xla``, and its ids and logits are JAX's."""
    hc = transformers.LlamaConfig(
        vocab_size=VOCAB, hidden_size=256, intermediate_size=1000,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=512, rms_norm_eps=1e-5, rope_theta=10000.0,
        rope_scaling={"type": "linear", "factor": 4.0})
    torch.manual_seed(1)
    hf = transformers.LlamaForCausalLM(hc).eval()
    jm = JModel().init_from_hf_model(hf, "q4_j")
    jm.params = jparams_to_native(jm.params, force=True, min_elems=0)
    pm = Model().init_from_hf_model(hf, "q4_j", device="cpu")
    assert pm.cfg.head_dim == 64
    np.testing.assert_array_equal(pm.params.rope_inv_freqs.numpy(),
                                  np.asarray(jm.params["rope_inv_freqs"]))
    _cuda.reset_launches()
    check_against_jax(jm, pm, np.random.default_rng(0).integers(
        3, VOCAB, 40).tolist(), n_new=6, min_proven=3)
    assert _cuda.launch_counts()["attend_xla"] > 0


# ---------------------------------------------------------------------------
# head dims 64, 80, 96 through the dispatch
# ---------------------------------------------------------------------------

HQ, HKV, S = 4, 2, 64


def _cfgs(Dh):
    kw = dict(arch="llama", vocab_size=64, hidden_size=HQ * Dh, n_layers=1,
              n_heads=HQ, n_kv_heads=HKV, head_dim=Dh, intermediate_size=64,
              max_seq_len=S)
    return JMC(**kw), ModelConfig(**kw)


def _kv(rng, shape, int8):
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.uniform(-1, 1, shape).astype(np.float32)
    if not int8:
        bf = lambda a: np.array(jnp.asarray(a, jnp.bfloat16)
                                .astype(jnp.float32))
        return bf(k), None, bf(v), None
    (kc, ks), (vc, vs) = jquantize_kv(jnp.asarray(k)), \
        jquantize_kv(jnp.asarray(v))
    return (np.array(kc), np.array(ks.astype(jnp.float32)), np.array(vc),
            np.array(vs.astype(jnp.float32)))


def _t(a, dt):
    return None if a is None else torch.from_numpy(a).to(dt)


def _j(a, dt):
    return None if a is None else jnp.asarray(a, dt)


@pytest.mark.parametrize("T", [1, 9])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("Dh", [64, 80, 96])
def test_attend_odd_head_dims_match_attend_xla(Dh, int8, T):
    """``attend`` (contiguous cache) and ``attend_paged`` (shuffled table,
    page 16) at a decode step (T = 1) and a 9-token chunk at offset 30,
    each counting its route once, against JAX ``attend_xla`` on the same
    keys (gathered for the paged case)."""
    rng = np.random.default_rng(Dh + 2 * int8 + T)
    jcfg, cfg = _cfgs(Dh)
    cdt = (torch.int8, jnp.int8) if int8 else (torch.bfloat16, jnp.bfloat16)
    q = np.array(jnp.asarray(rng.standard_normal((2, T, HQ, Dh)) * 3,
                             jnp.bfloat16).astype(jnp.float32))
    pos = (np.array([30, 41])[:, None] + np.arange(T)[None]).astype(np.int32)
    k, ks, v, vs = _kv(rng, (2, HKV, S, Dh), int8)
    ref = jattend_xla(jnp.asarray(q, jnp.bfloat16), _j(k, cdt[1]),
                      _j(v, cdt[1]), _j(ks, jnp.bfloat16),
                      _j(vs, jnp.bfloat16), jnp.asarray(pos), jcfg)
    _cuda.reset_launches()
    out = attend(_t(q, torch.bfloat16), _t(k, cdt[0]), _t(v, cdt[0]),
                 torch.from_numpy(pos).long(), cfg, _t(ks, torch.bfloat16),
                 _t(vs, torch.bfloat16))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    # the same keys in a shuffled page pool
    ps, P = 16, 2 * (S // 16) + 1
    table = rng.permutation(P - 1)[:2 * (S // ps)].reshape(2, S // ps) \
        .astype(np.int32)

    def pool(c):
        if c is None:
            return None
        p = np.zeros((P, *c.shape[1:2], ps, *c.shape[3:]), c.dtype)
        for b in range(2):
            for j in range(S // ps):
                p[table[b, j]] = c[b, :, j * ps:(j + 1) * ps]
        return p

    kp, ksp, vp, vsp = map(pool, (k, ks, v, vs))
    jt = jnp.asarray(table)
    assert np.array_equal(np.asarray(jgather_pages(_j(kp, cdt[1]), jt)),
                          np.asarray(_j(k, cdt[1])))
    if int8:
        assert np.array_equal(np.asarray(jgather_scales(
            _j(ksp, jnp.bfloat16), jt)), np.asarray(_j(ks, jnp.bfloat16)))
    paged = attend_paged(_t(q, torch.bfloat16), _t(kp, cdt[0]),
                         _t(vp, cdt[0]), _t(ksp, torch.bfloat16),
                         _t(vsp, torch.bfloat16), torch.from_numpy(table),
                         torch.from_numpy(pos).long(), cfg)
    np.testing.assert_allclose(paged.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    counts = _cuda.launch_counts()
    assert counts["attend_xla"] == 1 and counts["attend_xla_paged"] == 1
    with pytest.raises(ValueError, match="head_dim"):
        check_head_dim(Dh)        # the kernels' wrappers keep refusing it


# ---------------------------------------------------------------------------
# K4 / K6 at G = 16 and 48
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("hq,hkv", [(32, 2), (48, 1)], ids=["G16", "G48"])
def test_k4_many_heads_per_kv_head_match_pallas(hq, hkv, int8):
    """K4's plain version at fill 300 of 384, head dim 128, against the TPU
    kernel (which pads G up to a multiple of 8), and the wrapper's CPU
    route."""
    Dh, S4, fill, scale = 128, 384, 300, 128 ** -0.5
    rng = np.random.default_rng(hq + int8)
    q = np.array(jnp.asarray(rng.standard_normal((1, hq, Dh)) * 6,
                             jnp.bfloat16).astype(jnp.float32))
    k, ks, v, vs = _kv(rng, (1, hkv, S4, Dh), int8)
    cdt = (torch.int8, jnp.int8) if int8 else (torch.bfloat16, jnp.bfloat16)
    lengths = np.array([fill], np.int32)
    ref = jflash_decode(jnp.asarray(q, jnp.bfloat16), _j(k, cdt[1]),
                        _j(v, cdt[1]), _j(ks, jnp.bfloat16),
                        _j(vs, jnp.bfloat16), jnp.asarray(lengths),
                        blk_s=128, scale=scale, interpret=True)
    qt, lt = _t(q, torch.bfloat16), torch.from_numpy(lengths)
    kt, vt = _t(k, cdt[0]), _t(v, cdt[0])
    kst, vst = _t(ks, torch.bfloat16), _t(vs, torch.bfloat16)
    if int8:
        out = flash_decode_i8_plain(qt, kt, vt, kst, vst, lt, scale)
        wrapped = flash_decode_i8(qt, kt, vt, kst, vst, lt, scale)
    else:
        out = flash_decode_plain(qt, kt, vt, lt, scale)
        wrapped = flash_decode(qt, kt, vt, lt, scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    assert torch.equal(wrapped, out)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("hq,hkv", [(32, 2), (48, 1)], ids=["G16", "G48"])
def test_k6_many_heads_per_kv_head_match_pallas(hq, hkv, int8):
    """K6's plain version over a shuffled table (page 32, 4 pages a row;
    fills 117 and 9) against the TPU paged kernel and the wrapper's CPU
    route."""
    Dh, ps, maxp, scale = 128, 32, 4, 128 ** -0.5
    rng = np.random.default_rng(7 * hq + int8)
    P = 2 * maxp + 1
    q = np.array(jnp.asarray(rng.standard_normal((2, hq, Dh)) * 6,
                             jnp.bfloat16).astype(jnp.float32))
    k, ks, v, vs = _kv(rng, (P, hkv, ps, Dh), int8)
    table = rng.permutation(P - 1)[:2 * maxp].reshape(2, maxp) \
        .astype(np.int32)
    lens = np.array([ps * maxp - 11, 9], np.int32)
    cdt = (torch.int8, jnp.int8) if int8 else (torch.bfloat16, jnp.bfloat16)
    ref = jpaged_fd(jnp.asarray(q, jnp.bfloat16), _j(k, cdt[1]),
                    _j(v, cdt[1]), _j(ks, jnp.bfloat16),
                    _j(vs, jnp.bfloat16), jnp.asarray(table),
                    jnp.asarray(lens), scale=scale, interpret=True)
    qt, tt, lt = _t(q, torch.bfloat16), torch.from_numpy(table), \
        torch.from_numpy(lens)
    kt, vt = _t(k, cdt[0]), _t(v, cdt[0])
    kst, vst = _t(ks, torch.bfloat16), _t(vs, torch.bfloat16)
    out = paged_decode_plain(qt, kt, vt, kst, vst, tt, lt, scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    wrapped = paged_decode_i8(qt, kt, vt, kst, vst, tt, lt, scale) if int8 \
        else paged_decode(qt, kt, vt, tt, lt, scale)
    assert torch.equal(wrapped, out)
