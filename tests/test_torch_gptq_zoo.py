"""GPTQ import of the fused-QKV and bias families in the port, the twins of
``tests/test_gptq_zoo.py``'s Qwen2, Phi-3 (fused qkv_proj and
gate_up_proj), Falcon (the new architecture's grouped query_key_value and
ln_attn/ln_mlp), Baichuan (W_pack), GPT-J (biased MLP and lm_head) and
Qwen2 act-order cases: the same synthetic checkpoints, written by that
file's ``_linear`` / ``_vec`` / ``_embed`` and ``tests/test_gptq.py``'s
packers, through the port's ``params_from_gptq_state_dict`` (the QTensor
splits of ``models/_defuse.py``: ``take_n``, ``_qsplit``, ``split_falcon``)
and the JAX package's.

Each family is widened to its full-size head dim (Qwen2 and Baichuan 128,
GPT-J 256, as ``test_torch_zoo.py`` widens them, and Phi-3-mini's 96 and
Falcon's 64, which ``attend_xla`` takes in both packages). Held: every param of the port equal to the JAX import's, bridged,
leaf for leaf; the logits of the quantized import against the port's fp
import of the dequantized twin, and against the JAX import's, each within
3e-2·max|ref| (that file's 3e-2 taken relative to the logits' scale, which
reaches 1.0-1.5 here: the quantized products' plain kernels dequantize to
f32, the fp import rounds its f32 weights to bf16 at the product as the
JAX ``linear`` does, and the two part by up to 2.6e-2·max|ref|). Mixtral's case waits for the
MoE slice.
"""
import numpy as np
import pytest
import torch

from neural_tpu.convert.gptq import \
    params_from_gptq_state_dict as jparams_from_gptq  # noqa: E402
from neural_tpu.models.config import ModelConfig as JMC
from neural_tpu.runtime.generate import batch_logits as jbatch_logits

from neural_tpu_torch.convert.from_jax import params_from_numpy
from neural_tpu_torch.convert.gptq import params_from_gptq_state_dict
from neural_tpu_torch.convert.hf import ARCH_MODULES, build_params
from neural_tpu_torch.models.config import ModelConfig
from neural_tpu_torch.runtime.generate import batch_logits
from test_gptq_zoo import _embed, _linear, _vec
from test_torch_bridge import jax_tree_to_numpy

V, L = 128, 2
REL_TOL = 3e-2
IDS = [[3, 7, 11, 2, 9]]


def _cfg(arch, D, NH, NKV, I, **kw):
    return dict(arch=arch, vocab_size=V, hidden_size=D, n_layers=L,
                n_heads=NH, n_kv_heads=NKV, head_dim=D // NH,
                intermediate_size=I, max_seq_len=64, eos_token_id=999, **kw)


CASES = {
    # (config, seed of the vectors, first seed of the linears)
    "qwen2": (_cfg("qwen2", 256, 2, 1, 96, qkv_bias=True), 0, 0),
    "phi3": (_cfg("phi3", 384, 4, 2, 96), 1, 100),
    "falcon": (_cfg("falcon", 256, 4, 2, 96, norm_type="layernorm",
                    act="gelu", mlp_gated=False, parallel_residual=True,
                    tie_word_embeddings=True), 2, 200),
    "baichuan": (_cfg("baichuan", 256, 2, 2, 96), 3, 300),
    "gptj": (_cfg("gptj", 512, 2, 2, 96, norm_type="layernorm",
                  act="gelu_tanh", mlp_gated=False, mlp_bias=True,
                  rope_style="gptj", rope_dim=64, parallel_residual=True),
             4, 400),
}


def _synth(arch, kw, vseed, s):
    """The GPTQ state dict of ``test_gptq_zoo.py``'s case for ``arch`` at the
    widths of ``kw``, and its fp twin."""
    D, I, q, kv = kw["hidden_size"], kw["intermediate_size"], \
        kw["n_heads"] * kw["head_dim"], kw["n_kv_heads"] * kw["head_dim"]
    rng = np.random.default_rng(vseed)
    sd, fp = {}, {}
    lin = {
        "qwen2": [("self_attn.q_proj", D, q), ("self_attn.k_proj", D, kv),
                  ("self_attn.v_proj", D, kv), ("self_attn.o_proj", q, D),
                  ("mlp.gate_proj", D, I), ("mlp.up_proj", D, I),
                  ("mlp.down_proj", I, D)],
        "phi3": [("self_attn.qkv_proj", D, q + 2 * kv),
                 ("self_attn.o_proj", q, D), ("mlp.gate_up_proj", D, 2 * I),
                 ("mlp.down_proj", I, D)],
        "falcon": [("self_attention.query_key_value", D,
                    kw["n_kv_heads"] * (kw["n_heads"] // kw["n_kv_heads"] + 2)
                    * kw["head_dim"]),
                   ("self_attention.dense", q, D),
                   ("mlp.dense_h_to_4h", D, I), ("mlp.dense_4h_to_h", I, D)],
        "baichuan": [("self_attn.W_pack", D, 3 * D), ("self_attn.o_proj", D, D),
                     ("mlp.gate_proj", D, I), ("mlp.up_proj", D, I),
                     ("mlp.down_proj", I, D)],
        "gptj": [("attn.q_proj", D, D), ("attn.k_proj", D, D),
                 ("attn.v_proj", D, D), ("attn.out_proj", D, D),
                 ("mlp.fc_in", D, I), ("mlp.fc_out", I, D)],
    }[arch]
    pre = "transformer.h." if arch in ("falcon", "gptj") else "model.layers."
    for i in range(L):
        p = f"{pre}{i}."
        for nm, K, N in lin:
            s += 1
            _linear(sd, fp, p + nm, K, N, seed=s)
        if arch == "qwen2":
            for bn, n in [("self_attn.q_proj.bias", q),
                          ("self_attn.k_proj.bias", kv),
                          ("self_attn.v_proj.bias", kv)]:
                _vec(sd, fp, p + bn, n, rng, kind="randn")
        if arch == "falcon":
            for nm in ("ln_attn", "ln_mlp"):
                _vec(sd, fp, p + nm + ".weight", D, rng)
                _vec(sd, fp, p + nm + ".bias", D, rng, kind="randn")
        elif arch == "gptj":
            _vec(sd, fp, p + "ln_1.weight", D, rng)
            _vec(sd, fp, p + "ln_1.bias", D, rng, kind="randn")
            _vec(sd, fp, p + "mlp.fc_in.bias", I, rng, kind="randn")
            _vec(sd, fp, p + "mlp.fc_out.bias", D, rng, kind="randn")
        else:
            _vec(sd, fp, p + "input_layernorm.weight", D, rng)
            _vec(sd, fp, p + "post_attention_layernorm.weight", D, rng)
    if arch in ("falcon", "gptj"):
        emb = "transformer.wte.weight" if arch == "gptj" else \
            "transformer.word_embeddings.weight"
        _embed(sd, fp, emb, rng, rows=V, cols=D)
        _vec(sd, fp, "transformer.ln_f.weight", D, rng)
        _vec(sd, fp, "transformer.ln_f.bias", D, rng, kind="randn")
    else:
        _embed(sd, fp, "model.embed_tokens.weight", rng, rows=V, cols=D)
        _vec(sd, fp, "model.norm.weight", D, rng)
    if arch != "falcon":
        _embed(sd, fp, "lm_head.weight", rng, rows=V, cols=D)
    if arch == "gptj":
        _vec(sd, fp, "lm_head.bias", V, rng, kind="randn")
    return sd, fp


def _compare(sd, fp, kw):
    """Hold the port's import of ``sd`` to the JAX import and to the port's
    fp import of ``fp``; returns the port's decoder."""
    cfg, jcfg = ModelConfig(**kw), JMC(**kw)
    port = params_from_gptq_state_dict(dict(sd), cfg, dtype=torch.float32,
                                       device="cpu")
    jp = jparams_from_gptq(dict(sd), jcfg, dtype=np.float32)
    bridged = params_from_numpy(jax_tree_to_numpy(jp), cfg, "cpu")
    a, b = port.state_dict(), bridged.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    lq = batch_logits(port, cfg, IDS).numpy()
    assert np.isfinite(lq).all()
    fp_model = build_params(fp, cfg, ARCH_MODULES[cfg.arch], quant=None,
                            dtype=torch.float32, device="cpu")
    lf = batch_logits(fp_model, cfg, IDS).numpy()
    np.testing.assert_allclose(lq, lf, rtol=0,
                               atol=REL_TOL * np.abs(lf).max())
    jl = np.asarray(jbatch_logits(jp, jcfg, np.asarray(IDS, np.int32)),
                    np.float32)
    np.testing.assert_allclose(lq, jl, rtol=0,
                               atol=REL_TOL * np.abs(jl).max())
    return port


@pytest.mark.parametrize("arch", sorted(CASES))
def test_gptq_family(arch):
    kw, vseed, s = CASES[arch]
    sd, fp = _synth(arch, kw, vseed, s)
    port = _compare(sd, fp, kw)
    if arch == "gptj":
        assert port.lm_head_b is not None
    if arch == "falcon":
        assert port.layers[0].ffn_norm_w is not None     # ln_mlp kept


def test_gptq_qwen2_act_order_folds_and_fuses():
    """Act-order: one g_idx shared by q/k/v and one by w_down's rows; w_down's
    perm folds into gate/up's columns and q/k/v fuse with one gather."""
    kw = dict(CASES["qwen2"][0], n_layers=1)
    D, I = kw["hidden_size"], kw["intermediate_size"]
    q = kw["n_heads"] * kw["head_dim"]
    kv = kw["n_kv_heads"] * kw["head_dim"]
    rng = np.random.default_rng(6)
    gD = np.empty(D, np.int32)
    gD[rng.permutation(D)] = np.arange(D) // 32
    gI = np.empty(I, np.int32)
    gI[rng.permutation(I)] = np.arange(I) // 32
    sd, fp = {}, {}
    s = 600
    p = "model.layers.0."
    for nm, K, N, gi in [("self_attn.q_proj", D, q, gD),
                         ("self_attn.k_proj", D, kv, gD),
                         ("self_attn.v_proj", D, kv, gD),
                         ("self_attn.o_proj", q, D, None),
                         ("mlp.gate_proj", D, I, None),
                         ("mlp.up_proj", D, I, None),
                         ("mlp.down_proj", I, D, gI)]:
        s += 1
        _linear(sd, fp, p + nm, K, N, seed=s, act_order=gi is not None,
                g_idx=gi)
    for bn, n in [("self_attn.q_proj.bias", q), ("self_attn.k_proj.bias", kv),
                  ("self_attn.v_proj.bias", kv)]:
        _vec(sd, fp, p + bn, n, rng, kind="randn")
    _vec(sd, fp, p + "input_layernorm.weight", D, rng)
    _vec(sd, fp, p + "post_attention_layernorm.weight", D, rng)
    _embed(sd, fp, "model.embed_tokens.weight", rng, rows=V, cols=D)
    _vec(sd, fp, "model.norm.weight", D, rng)
    _embed(sd, fp, "lm_head.weight", rng, rows=V, cols=D)
    port = _compare(sd, fp, kw)
    blk = port.layers[0]
    assert blk.fused_qkv and blk.wqkv.perm is not None   # one shared gather
    assert blk.w_down.perm is None                      # folded into gate/up
