"""The three faults of the port repaired before its sampling slice, each
against the JAX package on the same inputs.

- C7: the shapes neither K1 nor K5 takes (N not a multiple of 16, as an
  untied vocab of 32001; K not a multiple of 32) route to the plain
  dequantize-and-``torch.mm`` route, the JAX package's own fallback; a
  group of 8 stays with K5. Outputs against the JAX ``qmatmul``'s CPU
  fallback within 1e-2·max|ref| (the port rounds the weight to bf16 after
  an f32 product, ``qmatmul_native`` rounds code and scale apart).
- C6: GPTQ checkpoints of the families with a fused QKV (a tiny Bloom, the
  per-head interleave with biases, and a tiny MPT, the straight concat)
  through both packages' ``params_from_gptq_state_dict``: every split
  QTensor's fields equal, prefill logits within 3e-2·max|logit| (the model
  tolerance of ``tests/test_torch_model.py``).
- C5: on the CPU the port's ``rms_norm`` is the torch chain it was, bit for
  bit, and within one bf16 step of the JAX ``rms_norm``; on the card it
  takes the row-norm kernel, which ``chip_smoke.py`` holds against it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from neural_tpu.convert import gptq as J
from neural_tpu.core.dtypes import PRESETS as JPRESETS
from neural_tpu.core.dtypes import QuantConfig as JQC
from neural_tpu.core.qtensor import quantize as jquantize
from neural_tpu.core.qtensor import to_native_packed as jto_native_packed
from neural_tpu.models import bloom as jbloom
from neural_tpu.models import mpt as jmpt
from neural_tpu.ops.norms import rms_norm as jrms_norm
from neural_tpu.ops.qmatmul import qmatmul as jqmatmul
from neural_tpu.runtime.generate import params_to_native as jparams_to_native
from neural_tpu.runtime.generate import prefill_step as jprefill_step
from neural_tpu.runtime.kvcache import init_cache as jinit_cache

from neural_tpu_torch.convert import gptq as P
from neural_tpu_torch.models import bloom, mpt
from neural_tpu_torch.ops import _cuda
from neural_tpu_torch.ops.norms import rms_norm, rms_norm_plain
from neural_tpu_torch.ops.qmatmul import k1_takes, k5_takes, qmatmul, route
from neural_tpu_torch.runtime.generate import prefill_step
from neural_tpu_torch.runtime.kvcache import init_cache
from test_gptq import pack_nibbles
from test_torch_gptq import _fields_equal, _layer, _tq

QMM_TOL = 1e-2
REL_TOL = 3e-2


# (what, K, N, config, the port's route at M = 1 and at M = 40)
PLAIN_CASES = [
    ("vocab_32001", 128, 32001, JPRESETS["q4_j"], ("plain", "plain")),
    ("k_104", 104, 64, JQC(bits=4, group_size=8), ("plain", "plain")),
    ("group_8", 256, 128, JQC(bits=4, group_size=8), ("K5", "K5")),
]


@pytest.mark.parametrize("what,K,N,jcfg,routes", PLAIN_CASES,
                         ids=[c[0] for c in PLAIN_CASES])
def test_declined_shapes_take_the_plain_route(what, K, N, jcfg, routes):
    rng = np.random.default_rng(K + N)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    jqt = jto_native_packed(jquantize(jnp.asarray(w), jcfg))
    qt = _tq(jqt)
    g = qt.group_size
    assert not k1_takes(1, K, N, g)
    assert k5_takes(K, N, g) == (routes[0] == "K5")
    for M, want in zip((1, 40), routes):
        assert route(M, K, N, qt) == want
        x = (rng.standard_normal((M, K))).astype(np.float32)
        ref = np.asarray(jqmatmul(jnp.asarray(x, jnp.bfloat16), jqt,
                                  out_dtype=jnp.float32))
        before = _cuda.launch_counts()["qmm_plain"]
        out = qmatmul(torch.from_numpy(x).bfloat16(), qt, torch.float32)
        # the route is counted beside the kernels' launches
        assert _cuda.launch_counts()["qmm_plain"] == \
            before + (want == "plain")
        np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                                   atol=QMM_TOL * np.abs(ref).max())


G, NL, D, VOCAB = 32, 1, 128, 256


def _quartet(rng, sd, base, K, N):
    codes = rng.integers(0, 16, (K, N)).astype(np.uint8)
    zeros = rng.integers(6, 10, (K // G, N)).astype(np.uint8)
    sd[base + ".qweight"] = pack_nibbles(codes, axis=0)
    sd[base + ".qzeros"] = pack_nibbles(zeros - 1, axis=1)
    sd[base + ".scales"] = (rng.random((K // G, N)) * 0.01 + 0.01) \
        .astype(np.float16)


def _vec(rng, n, base=0.0, scale=0.1):
    return (base + scale * rng.standard_normal(n)).astype(np.float16)


def _bloom_sd(rng):
    sd = {}
    for i in range(NL):
        p = f"transformer.h.{i}."
        for name, K, N in (("self_attention.query_key_value", D, 3 * D),
                           ("self_attention.dense", D, D),
                           ("mlp.dense_h_to_4h", D, 4 * D),
                           ("mlp.dense_4h_to_h", 4 * D, D)):
            _quartet(rng, sd, p + name, K, N)
            sd[p + name + ".bias"] = _vec(rng, N, scale=0.02)
        for n in ("input_layernorm", "post_attention_layernorm"):
            sd[p + n + ".weight"] = _vec(rng, D, 1.0)
            sd[p + n + ".bias"] = _vec(rng, D, scale=0.02)
    sd["transformer.word_embeddings.weight"] = \
        (rng.standard_normal((VOCAB, D)) * 0.5).astype(np.float16)
    for n in ("word_embeddings_layernorm", "ln_f"):
        sd[f"transformer.{n}.weight"] = _vec(rng, D, 1.0)
        sd[f"transformer.{n}.bias"] = _vec(rng, D, scale=0.02)
    return sd


def _mpt_sd(rng):
    sd = {}
    for i in range(NL):
        p = f"transformer.blocks.{i}."
        for name, K, N in (("attn.Wqkv", D, 3 * D), ("attn.out_proj", D, D),
                           ("ffn.up_proj", D, 4 * D),
                           ("ffn.down_proj", 4 * D, D)):
            _quartet(rng, sd, p + name, K, N)
        for n in ("norm_1", "norm_2"):
            sd[p + n + ".weight"] = _vec(rng, D, 1.0)
    sd["transformer.wte.weight"] = \
        (rng.standard_normal((VOCAB, D)) * 0.5).astype(np.float16)
    sd["transformer.norm_f.weight"] = _vec(rng, D, 1.0)
    return sd


FAMILIES = {
    "bloom": (lambda: transformers.BloomConfig(
        vocab_size=VOCAB, hidden_size=D, n_layer=NL, n_head=2),
        bloom, jbloom, _bloom_sd),
    "mpt": (lambda: transformers.MptConfig(
        vocab_size=VOCAB, d_model=D, n_layers=NL, n_heads=2, max_seq_len=256,
        attn_config={"alibi": True}), mpt, jmpt, _mpt_sd),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_gptq_fused_qkv_family_equals_jax(family):
    hf_cfg, mod, jmod, make_sd = FAMILIES[family]
    hc = hf_cfg()
    cfg, jcfg = mod.config_from_hf(hc), jmod.config_from_hf(hc)
    sd = {k: np.ascontiguousarray(v)
          for k, v in make_sd(np.random.default_rng(5)).items()}
    jp = J.params_from_gptq_state_dict(dict(sd), jcfg, "gptq", 4,
                                       group_size=G)
    jp = jparams_to_native(jp, force=True, min_elems=0)
    model = P.params_from_gptq_state_dict(dict(sd), cfg, "gptq", 4,
                                          group_size=G, device="cpu")
    for i, blk in enumerate(model.layers):
        jlp = _layer(jp["layers"], i)
        for n in ("wq", "wk", "wv", "wo", "w_up", "w_down"):
            _fields_equal(jlp[n], getattr(blk, n).qt)
        if family == "bloom":
            for n in ("bq", "bk", "bv"):
                np.testing.assert_array_equal(
                    getattr(blk, n).to(torch.float32).numpy(),
                    np.asarray(jlp[n], np.float32))
    ids = np.random.default_rng(6).integers(3, VOCAB, 12).tolist()
    ref, _ = jprefill_step(jp, jnp.asarray([ids], jnp.int32),
                           jnp.zeros((1,), jnp.int32),
                           jinit_cache(jcfg, 1, 16), jcfg)
    out = prefill_step(model, torch.tensor([ids]),
                       torch.zeros(1, dtype=torch.long),
                       init_cache(cfg, 1, 16, device="cpu"))
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=REL_TOL * np.abs(ref).max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm_on_the_cpu_is_the_torch_chain(dtype, offset):
    rng = np.random.default_rng(int(offset) + 3)
    x = (rng.standard_normal((5, 256)) * 3).astype(np.float32)
    w = (1 + 0.3 * rng.standard_normal(256)).astype(np.float32)
    xt, wt = torch.from_numpy(x).to(dtype), torch.from_numpy(w).bfloat16()
    out = rms_norm(xt, wt, 1e-5, offset)
    assert torch.equal(out, rms_norm_plain(xt, wt, 1e-5, offset))
    xf = xt.to(torch.float32)
    chain = (xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True)
                              + 1e-5) * (wt.to(torch.float32) + offset))
    assert torch.equal(out, chain.to(dtype))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = np.asarray(jrms_norm(jnp.asarray(x, jdt),
                               jnp.asarray(w, jnp.bfloat16), 1e-5, offset),
                     np.float32)
    np.testing.assert_allclose(out.to(torch.float32).numpy(), ref,
                               rtol=2 ** -7, atol=1e-6)
