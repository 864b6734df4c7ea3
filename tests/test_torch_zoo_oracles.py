"""The remote-code families in the port: Baichuan 7B (``W_pack``, NeoX RoPE)
and 13B (ALiBi, here at 5 heads: slopes of a head count that is not a power
of two, as 13B's 40), Qwen v1 (``c_attn`` with its bias, the w1/w2 swap)
and ChatGLM-2/3 (GQA through the concatenated QKV with its bias, the packed
SwiGLU, GPT-J RoPE on half the head; ChatGLM-3-32k's ``rope_ratio`` 50).

Each tiny checkpoint is hand-built in the family's native HF layout with
the state-dict helpers of ``tests/test_zoo_oracles.py`` (``rsd``,
``_baichuan_sd``) at head dim 128, so that the port's CPU run goes through
the attention kernels' plain versions, and imported by both packages
(``convert.hf.build_params``, f32 weights, bf16 activations). The port is
held against the numpy oracles composed from that file's primitives (in
f64), within that file's 2e-2 taken relative to max|oracle|: at head dim
128 the logits reach 2.6-4.2 where that file's reach about 1, and the JAX
package itself then stands 0.75-1.15e-2·max|oracle| from the oracles, the
port 0.65-1.1e-2. And against the JAX ``build_params`` + ``model_step`` on
the same state dict: params equal leaf for leaf, logits within
3e-2·max|ref| (``test_torch_bloom_mpt.py``'s tolerance).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_tpu.convert.hf import ARCH_MODULES as JARCH
from neural_tpu.convert.hf import build_params as jbuild_params
from neural_tpu.runtime import init_cache as jinit_cache
from neural_tpu.runtime import model_step as jmodel_step

from neural_tpu_torch.convert.from_jax import params_from_numpy
from neural_tpu_torch.convert.hf import build_params, family
from neural_tpu_torch.ops.rope import alibi_slopes
from neural_tpu_torch.runtime.generate import model_step
from neural_tpu_torch.runtime.kvcache import init_cache
from test_torch_bridge import jax_tree_to_numpy
from test_zoo_oracles import (RTOL, Obj, _baichuan_oracle,
                              _baichuan_sd, attn, rmsnorm, rope_gptj_half,
                              rope_neox, rsd, silu)

REL_TOL = 3e-2
TOKS = [3, 9, 1, 55, 20, 7, 61, 14]


def _both(sd, hf_cfg):
    """(port logits [T, V], JAX logits [T, V], port cfg) of one prefill of
    TOKS, after the params of the two packages are held leaf for leaf."""
    mod = family(hf_cfg.model_type)
    cfg = mod.config_from_hf(hf_cfg)
    jmod = JARCH[hf_cfg.model_type]
    jcfg = jmod.config_from_hf(hf_cfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    port = build_params(dict(sd), cfg, mod, quant=None, dtype=torch.float32,
                        device="cpu")
    jp = jbuild_params(dict(sd), jcfg, jmod, quant=None, dtype=jnp.float32)
    bridged = params_from_numpy(jax_tree_to_numpy(jp), cfg, "cpu")
    a, b = port.state_dict(), bridged.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    jl, _ = jmodel_step(jp, jnp.asarray([TOKS], jnp.int32),
                        jnp.zeros((1,), jnp.int32),
                        jinit_cache(jcfg, 1, 32), jcfg)
    pl = model_step(port, torch.tensor([TOKS]),
                    torch.zeros(1, dtype=torch.long),
                    init_cache(cfg, 1, 32, device="cpu"))
    return pl[0].numpy(), np.asarray(jl[0], np.float32), cfg


def _hold(got, jax_ref, oracle):
    np.testing.assert_allclose(got, oracle, rtol=0,
                               atol=RTOL * np.abs(oracle).max())
    np.testing.assert_allclose(got, jax_ref, rtol=0,
                               atol=REL_TOL * np.abs(jax_ref).max())


@pytest.mark.parametrize("alibi", [False, True], ids=["7b_rope", "13b_alibi"])
def test_baichuan_wpack(alibi):
    H = 5 if alibi else 2
    L, D, V, I = 2, 128 * H, 96, 256
    sd = _baichuan_sd(L, D, H, V, I)
    hf_cfg = Obj(model_type="baichuan", vocab_size=V, hidden_size=D,
                 num_hidden_layers=L, num_attention_heads=H,
                 intermediate_size=I, rms_norm_eps=1e-6,
                 position_embedding="alibi" if alibi else "rope",
                 model_max_length=4096, bos_token_id=1, eos_token_id=2)
    got, jref, cfg = _both(sd, hf_cfg)
    assert cfg.use_alibi == alibi and cfg.head_dim == 128
    if alibi:
        # the oracle reads the JAX slopes; the port's own are the same
        from neural_tpu.ops.rope import alibi_slopes as jslopes
        np.testing.assert_array_equal(alibi_slopes(H), jslopes(H))
    _hold(got, jref, _baichuan_oracle(sd, L, D, H, V, TOKS, alibi))


def _qwen1_sd(L, D, V, I):
    shapes = {"transformer.wte.weight": (V, D),
              "transformer.ln_f.weight": [(D,)], "lm_head.weight": (V, D)}
    for i in range(L):
        p = f"transformer.h.{i}."
        shapes.update({
            p + "attn.c_attn.weight": (3 * D, D),
            p + "attn.c_attn.bias": (3 * D,),
            p + "attn.c_proj.weight": (D, D),
            p + "mlp.w1.weight": (I, D),      # up
            p + "mlp.w2.weight": (I, D),      # gate
            p + "mlp.c_proj.weight": (D, I),
            p + "ln_1.weight": [(D,)], p + "ln_2.weight": [(D,)],
        })
    return rsd(shapes, 7)


def test_qwen_v1():
    L, D, H, V, I = 2, 256, 2, 96, 192
    Dh = D // H
    sd = _qwen1_sd(L, D, V, I)
    hf_cfg = Obj(model_type="qwen", vocab_size=V, hidden_size=D,
                 num_hidden_layers=L, num_attention_heads=H,
                 intermediate_size=2 * I, layer_norm_epsilon=1e-6,
                 rotary_emb_base=10000.0, max_position_embeddings=2048,
                 eos_token_id=2, bos_token_id=1)
    got, jref, cfg = _both(sd, hf_cfg)
    assert cfg.intermediate_size == I and cfg.qkv_bias

    g = lambda k: np.asarray(sd[k], np.float64)
    T = len(TOKS)
    x = g("transformer.wte.weight")[TOKS]
    pos = np.arange(T)
    for i in range(L):
        p = f"transformer.h.{i}."
        h = rmsnorm(x, g(p + "ln_1.weight"))
        w, b = g(p + "attn.c_attn.weight"), g(p + "attn.c_attn.bias")
        q, k, v = ((h @ w[j * D:(j + 1) * D].T + b[j * D:(j + 1) * D])
                   .reshape(T, H, Dh) for j in range(3))
        ctx = attn(rope_neox(q, pos), rope_neox(k, pos), v, H, Dh ** -0.5)
        x = x + ctx @ g(p + "attn.c_proj.weight").T
        h2 = rmsnorm(x, g(p + "ln_2.weight"))
        m = silu(h2 @ g(p + "mlp.w2.weight").T) * (
            h2 @ g(p + "mlp.w1.weight").T)
        x = x + m @ g(p + "mlp.c_proj.weight").T
    oracle = rmsnorm(x, g("transformer.ln_f.weight")) @ g("lm_head.weight").T
    _hold(got, jref, oracle)


def _chatglm2_sd(L, D, qd, kvd, V, I):
    shapes = {"transformer.embedding.word_embeddings.weight": (V, D),
              "transformer.encoder.final_layernorm.weight": [(D,)],
              "transformer.output_layer.weight": (V, D)}
    for i in range(L):
        p = f"transformer.encoder.layers.{i}."
        shapes.update({
            p + "self_attention.query_key_value.weight": (qd + 2 * kvd, D),
            p + "self_attention.query_key_value.bias": (qd + 2 * kvd,),
            p + "self_attention.dense.weight": (D, qd),
            p + "mlp.dense_h_to_4h.weight": (2 * I, D),   # [gate; up]
            p + "mlp.dense_4h_to_h.weight": (D, I),
            p + "input_layernorm.weight": [(D,)],
            p + "post_attention_layernorm.weight": [(D,)],
        })
    return rsd(shapes, 11)


@pytest.mark.parametrize("rope_ratio", [1.0, 50.0], ids=["v2", "v3_32k"])
def test_chatglm2_3(rope_ratio):
    L, D, H, Hkv, V, I = 2, 512, 4, 2, 96, 160
    Dh = D // H
    qd, kvd = H * Dh, Hkv * Dh
    sd = _chatglm2_sd(L, D, qd, kvd, V, I)
    hf_cfg = Obj(model_type="chatglm", padded_vocab_size=V, hidden_size=D,
                 num_layers=L, num_attention_heads=H,
                 multi_query_attention=True, multi_query_group_num=Hkv,
                 ffn_hidden_size=I, layernorm_epsilon=1e-6,
                 add_qkv_bias=True, seq_length=2048, rope_ratio=rope_ratio)
    got, jref, cfg = _both(sd, hf_cfg)
    assert cfg.arch == "chatglm" and cfg.n_kv_heads == Hkv
    assert cfg.rope_style == "gptj" and cfg.rope_dim == Dh // 2

    g = lambda k: np.asarray(sd[k], np.float64)
    theta = 10000.0 * rope_ratio
    T = len(TOKS)
    x = g("transformer.embedding.word_embeddings.weight")[TOKS]
    pos = np.arange(T)
    for i in range(L):
        p = f"transformer.encoder.layers.{i}."
        h = rmsnorm(x, g(p + "input_layernorm.weight"))
        w = g(p + "self_attention.query_key_value.weight")
        b = g(p + "self_attention.query_key_value.bias")
        q = (h @ w[:qd].T + b[:qd]).reshape(T, H, Dh)
        k = (h @ w[qd:qd + kvd].T + b[qd:qd + kvd]).reshape(T, Hkv, Dh)
        v = (h @ w[qd + kvd:].T + b[qd + kvd:]).reshape(T, Hkv, Dh)
        q, k = rope_gptj_half(q, pos, theta), rope_gptj_half(k, pos, theta)
        ctx = attn(q, k, v, Hkv, Dh ** -0.5)
        x = x + ctx @ g(p + "self_attention.dense.weight").T
        h2 = rmsnorm(x, g(p + "post_attention_layernorm.weight"))
        gu = h2 @ g(p + "mlp.dense_h_to_4h.weight").T
        x = x + (silu(gu[:, :I]) * gu[:, I:]) @ \
            g(p + "mlp.dense_4h_to_h.weight").T
    oracle = rmsnorm(x, g("transformer.encoder.final_layernorm.weight")) @ \
        g("transformer.output_layer.weight").T
    _hold(got, jref, oracle)
