"""GPTQ / AWQ checkpoint import in the port against the JAX package, on the
same synthetic checkpoints (packed per the published conventions by
``tests/test_gptq.py``'s packers): the word unpacks, the imported QTensor
fields (codes, scales, zero-points, perm) equal to JAX's exactly, the
act-order fold, ``concat_n`` and ``fuse_layer_weights`` with a shared perm,
the act-order product through each kernel's route, and a tiny Mistral
written as a GPTQ (and an AWQ) directory loaded by both ``Model.init(dir,
use_gptq=True)``.

Tolerances: dequantized weights against the numpy GPTQ formula 1e-6 (one
f32 product each); products through the port's plain kernels against
JAX's CPU routes 1e-2·max|ref| where a bf16 rounding of the weight or of x
differs between them, 1e-5 where both take the same integer codes and f32
arithmetic; model logits 3e-2·max|logit| and greedy ids where JAX's margin
proves them (``test_torch_formats.py``'s rule and reasons).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
stn = pytest.importorskip("safetensors.numpy")

from neural_tpu.api import Model as JModel
from neural_tpu.convert import gptq as J
from neural_tpu.core.dtypes import PRESETS as JPRESETS
from neural_tpu.core.qtensor import (QTensor as JQT, concat_n as jconcat_n,
                                     quantize as jquantize,
                                     to_native_packed as jto_native_packed)
from neural_tpu.models import llama as jllama
from neural_tpu.models.config import ModelConfig as JMC
from neural_tpu.ops.qmatmul import qmatmul as jqmatmul
from neural_tpu.runtime.generate import (model_step as jmodel_step,
                                         params_to_native as jparams_to_native,
                                         prefill_step as jprefill_step)
from neural_tpu.runtime.kvcache import init_cache as jinit_cache

from neural_tpu_torch.api import Model
from neural_tpu_torch.convert import gptq as P
from neural_tpu_torch.convert.files import read_config, read_safetensors_dir
from neural_tpu_torch.convert.from_jax import qtensor_from_numpy
from neural_tpu_torch.convert.hf import build_param_dict
from neural_tpu_torch.core.qtensor import (QTensor, concat_n, dequantize,
                                           to_native)
from neural_tpu_torch.models import llama
from neural_tpu_torch.models.config import ModelConfig
from neural_tpu_torch.models.transformer import Transformer
from neural_tpu_torch.ops import _cuda
from neural_tpu_torch.ops.qmatmul import qmatmul, route
from neural_tpu_torch.runtime.generate import (fuse_layer_weights,
                                               model_step, params_to_native,
                                               prefill_step)
from neural_tpu_torch.runtime.kvcache import init_cache
from test_gptq import pack_fields, pack_nibbles, synth
from test_torch_bridge import jax_qtensor_to_numpy
from test_torch_model import REL_TOL, VOCAB, _jax_margins


def _fields_equal(jqt, qt):
    """Codes, scales, zero-points and perm of a JAX QTensor (carried over by
    the bridge) and a port QTensor equal exactly, dtypes and configs
    too."""
    b = _tq(jqt)
    assert b.cfg == qt.cfg
    assert len(b.planes) == len(qt.planes)
    for name, x, y in [("plane", p, q) for p, q in zip(b.planes, qt.planes)] \
            + [(n, getattr(b, n), getattr(qt, n))
               for n in ("scales", "zeros", "perm")]:
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype, name
            assert torch.equal(x, y.cpu()), name


def _tq(jqt):
    return qtensor_from_numpy(jax_qtensor_to_numpy(jqt), "cpu")


def _layer(jlayers, i):
    """Layer i of a JAX layer tree, stacked or per layer."""
    if isinstance(jlayers, (tuple, list)):
        return jlayers[i]
    return jax.tree.map(lambda a: a[i], jlayers)


@pytest.mark.parametrize("axis", [0, 1])
def test_nibble_roundtrip(axis):
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 16, (64, 32)).astype(np.uint8)
    w = pack_nibbles(codes, axis=axis)
    out = P.unpack_int32_nibbles(w, axis=axis)
    np.testing.assert_array_equal(out.numpy(), codes)
    np.testing.assert_array_equal(out.numpy(),
                                  J.unpack_int32_nibbles(w, axis=axis))


def test_awq_order_roundtrip():
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 16, (16, 64)).astype(np.uint8)
    w = pack_nibbles(codes, axis=1, order=J.AWQ_ORDER)
    out = P.unpack_int32_nibbles(w, axis=1, order=P.AWQ_ORDER)
    np.testing.assert_array_equal(out.numpy(), codes)


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("axis", [0, 1])
def test_field_roundtrip(bits, axis):
    rng = np.random.default_rng(bits * 10 + axis)
    shape = (96, 64) if axis == 0 else (64, 96)
    codes = rng.integers(0, 1 << bits, shape).astype(np.uint8)
    w = pack_fields(codes, bits, axis=axis)
    out = P.unpack_int32_fields(w, bits, axis=axis)
    np.testing.assert_array_equal(out.numpy(), codes)
    np.testing.assert_array_equal(out.numpy(),
                                  J.unpack_int32_fields(w, bits, axis=axis))


@pytest.mark.parametrize("fmt,act_order", [("gptq", False), ("gptq", True),
                                           ("awq", False)])
def test_import_equals_jax_and_oracle(fmt, act_order):
    qw, qz, sc, gi = synth(fmt=fmt, act_order=act_order)
    kw = dict(fmt=fmt, zero_plus_one=fmt == "gptq")
    jqt = J.gptq_layer_to_qtensor(qw, qz, sc, gi, **kw)
    qt = P.gptq_layer_to_qtensor(qw, qz, sc, gi, **kw)
    _fields_equal(jqt, qt)
    assert (qt.perm is not None) == act_order
    ref = P.gptq_reference_dequant(qw, qz, sc, gi, **kw)
    np.testing.assert_array_equal(
        ref, J.gptq_reference_dequant(qw, qz, sc, gi, **kw))
    np.testing.assert_allclose(dequantize(qt).numpy(), ref, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("bits", [2, 3, 8])
@pytest.mark.parametrize("act_order", [False, True])
def test_import_odd_bits_equals_jax(bits, act_order):
    """2/3/8-bit GPTQ layers: fields equal to JAX's, the dequantized weight
    the GPTQ formula's, and the product (at rest, through the port's plain
    kernels) JAX's XLA product within one bf16 rounding of the weight."""
    rng = np.random.default_rng(bits)
    K, N, g = 96, 64, 32
    codes = rng.integers(0, 1 << bits, (K, N)).astype(np.uint8)
    scales = (rng.random((K // g, N)).astype(np.float32) * 0.05 + 0.01)
    zeros = rng.integers(1, (1 << bits) - 1 or 1, (K // g, N)) \
        .astype(np.uint8)
    gi = None
    if act_order:
        gi = np.empty(K, np.int32)
        gi[rng.permutation(K)] = np.arange(K) // g
    qw = pack_fields(codes, bits, axis=0)
    qz = pack_fields((zeros.astype(np.int32) - 1).astype(np.uint8), bits,
                     axis=1)
    jqt = J.gptq_layer_to_qtensor(qw, qz, scales, gi, bits=bits)
    qt = P.gptq_layer_to_qtensor(qw, qz, scales, gi, bits=bits)
    _fields_equal(jqt, qt)
    ref = P.gptq_reference_dequant(qw, qz, scales, gi, bits=bits)
    np.testing.assert_allclose(dequantize(qt).numpy(), ref, atol=1e-5)
    x = rng.standard_normal((4, K)).astype(np.float32)
    jout = np.asarray(jqmatmul(jnp.asarray(x), jqt, out_dtype=jnp.float32))
    out = qmatmul(torch.from_numpy(x), to_native(qt), torch.float32).numpy()
    np.testing.assert_allclose(out, jout, rtol=0,
                               atol=1e-2 * np.abs(jout).max())


def test_import_3bit_tenper_layout():
    """The ten-per-word 3-bit layout is sniffed from the qzeros width, and K
    comes from the group size."""
    rng = np.random.default_rng(33)
    K, N, g = 96, 64, 32
    codes = rng.integers(0, 8, (K, N)).astype(np.uint8)
    scales = (rng.random((K // g, N)).astype(np.float32) * 0.05 + 0.01)
    zeros = rng.integers(1, 7, (K // g, N)).astype(np.uint8)

    def pack_tenper(vals, axis):
        v = np.moveaxis(vals.astype(np.uint32), axis, 0)
        words = -(-v.shape[0] // 10)
        v = np.concatenate([v, np.zeros((words * 10 - v.shape[0],
                                         *v.shape[1:]), np.uint32)])
        v = v.reshape(words, 10, *v.shape[1:])
        w = np.zeros((words, *v.shape[2:]), np.uint32)
        for j in range(10):
            w |= v[:, j] << (3 * j)
        return np.moveaxis(w, 0, axis).view(np.int32)

    qw = pack_tenper(codes, axis=0)
    qz = pack_tenper((zeros.astype(np.int32) - 1).astype(np.uint8), axis=1)
    got = P.unpack_int32_fields(qw, 3, axis=0, fmt3="tenper", out_len=K)
    np.testing.assert_array_equal(got.numpy(), codes)
    assert P._sniff_fmt3(qz, N) == J._sniff_fmt3(qz, N) == "tenper"
    qt = P.gptq_layer_to_qtensor(qw, qz, scales, None, bits=3, group_size=g)
    _fields_equal(J.gptq_layer_to_qtensor(qw, qz, scales, None, bits=3,
                                          group_size=g), qt)
    exp = (codes.astype(np.float32)
           - np.repeat(zeros, g, axis=0).astype(np.float32)) \
        * np.repeat(scales, g, axis=0)
    np.testing.assert_allclose(dequantize(qt).numpy(), exp, atol=1e-5)
    with pytest.raises(ValueError, match="group_size"):
        P.gptq_layer_to_qtensor(qw, qz, scales, None, bits=3)


def test_fold_act_order_equals_jax_and_is_exact():
    """w_down's perm folded into gate/up columns: the same fields as JAX's
    fold, and the MLP's function unchanged."""
    rng = np.random.default_rng(0)
    D, I = 64, 128
    cfgq = JPRESETS["q4_1"]
    wg, wu = (rng.standard_normal((D, I)).astype(np.float32) * .1
              for _ in range(2))
    wd = rng.standard_normal((I, D)).astype(np.float32) * .1
    perm = rng.permutation(I).astype(np.int32)
    q = lambda w: jquantize(jnp.asarray(w), cfgq)
    qd = q(wd[perm])
    qd = JQT(qd.planes, qd.scales, qd.zeros, jnp.asarray(perm), qd.cfg)
    jcfg = JMC(arch="llama", hidden_size=D, intermediate_size=I, n_layers=1)
    cfg = ModelConfig(arch="llama", hidden_size=D, intermediate_size=I,
                      n_layers=1)
    m = llama.hf_layer_map(0, cfg)
    jsd = {m["w_gate"][0]: q(wg), m["w_up"][0]: q(wu), m["w_down"][0]: qd}
    sd = {k: _tq(v) for k, v in jsd.items()}
    x = torch.from_numpy(rng.standard_normal((4, D)).astype(np.float32))

    def mlp(sd):
        f = lambda n, h: h @ dequantize(sd[m[n][0]])
        return f("w_down", torch.nn.functional.silu(f("w_gate", x))
                 * f("w_up", x))

    ref = mlp(sd)
    J._fold_act_order_sd(jsd, jcfg, jllama)
    P._fold_act_order_sd(sd, cfg, llama)
    assert sd[m["w_down"][0]].perm is None
    for k in sd:
        _fields_equal(jsd[k], sd[k])
    np.testing.assert_allclose(mlp(sd).numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)


def _perm_qts(rng, K, n, fmt="q4_0", perm=None):
    perm = rng.permutation(K).astype(np.int32) if perm is None else perm
    out = []
    for _ in range(n):
        w = rng.standard_normal((K, 128)).astype(np.float32)
        jqt = jquantize(jnp.asarray(w)[perm], JPRESETS[fmt])
        out.append(JQT(jqt.planes, jqt.scales, jqt.zeros, jnp.asarray(perm),
                       jqt.cfg))
    return out


def test_concat_n_shared_perm_equals_jax():
    rng = np.random.default_rng(11)
    jqts = _perm_qts(rng, 256, 3)
    qts = [_tq(j) for j in jqts]
    fused = concat_n(qts)
    assert fused.perm is not None and fused.N == 3 * 128
    _fields_equal(jconcat_n(jqts), fused)
    x = torch.from_numpy(rng.standard_normal((4, 256)).astype(np.float32))
    want = torch.cat([x @ dequantize(q) for q in qts], dim=-1)
    torch.testing.assert_close(x @ dequantize(fused), want)
    other = _tq(_perm_qts(rng, 256, 1)[0])       # another perm
    with pytest.raises(ValueError, match="perms"):
        concat_n([qts[0], other])


@pytest.mark.parametrize("M", [4, 40, 300])
def test_act_order_qmatmul_matches_jax(M):
    """An act-order q4_j_i8_g128 weight at rest through each route: K1
    (M = 4, x gathered then the native codes), K5 (M = 40) and K2 (M =
    300, x gathered before its int8 quantization), against JAX's CPU
    routes (``qmatmul_native`` on the gathered x, ``qmatmul_xla`` on the
    un-permuted weight, ``matmul_a8_ref`` on the gathered x); each call
    gathers x once."""
    rng = np.random.default_rng(M)
    K = 256
    jqt = _perm_qts(rng, K, 1, "q4_j_i8_g128")[0]
    jnat = jto_native_packed(jqt)
    qt = to_native(_tq(jqt))
    _fields_equal(jnat, qt)
    x = rng.standard_normal((M, K)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    assert route(M, K, 128, qt) == {4: "K1", 40: "K5", 300: "K2"}[M]
    ref = np.asarray(jqmatmul(xb, jnat, out_dtype=jnp.float32))
    _cuda.reset_launches()
    out = qmatmul(xt, qt, torch.float32).numpy()
    assert _cuda.launch_counts()["act_order_gather"] == 1
    rel = 1e-5 if M == 300 else 1e-2
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=rel * np.abs(ref).max())


# ---------------------------------------------------------------------------
# a tiny Mistral as a GPTQ / AWQ directory, through both Model.init
# ---------------------------------------------------------------------------

D, HQ, HKV, DH, I_, NL, G = 128, 4, 2, 32, 192, 2, 32
PROJ = {"self_attn.q_proj": (D, HQ * DH), "self_attn.k_proj": (D, HKV * DH),
        "self_attn.v_proj": (D, HKV * DH), "self_attn.o_proj": (HQ * DH, D),
        "mlp.gate_proj": (D, I_), "mlp.up_proj": (D, I_),
        "mlp.down_proj": (I_, D)}
# GPTQ's same-Hessian rule: q/k/v share one act-order g_idx, gate/up another
SHARED = {"self_attn.q_proj": "qkv", "self_attn.k_proj": "qkv",
          "self_attn.v_proj": "qkv", "mlp.gate_proj": "gu",
          "mlp.up_proj": "gu"}
N_NEW, MIN_PROVEN = 6, 3


def gptq_state_dict(fmt, seed=0, act_order=True):
    """A GPTQ (act-order g_idx, group 32) or AWQ state dict of the tiny
    Mistral, numpy as safetensors holds it: int32 words, f16 scales."""
    rng = np.random.default_rng(seed)
    sd = {}
    for i in range(NL):
        p = f"model.layers.{i}."
        gidx = {}
        for name, (K, N) in PROJ.items():
            codes = rng.integers(0, 16, (K, N)).astype(np.uint8)
            zeros = rng.integers(6, 10, (K // G, N)).astype(np.uint8)
            scales = (rng.random((K // G, N)) * 0.01 + 0.01) \
                .astype(np.float16)
            base = p + name
            if fmt == "gptq":
                sd[base + ".qweight"] = pack_nibbles(codes, axis=0)
                sd[base + ".qzeros"] = pack_nibbles(zeros - 1, axis=1)
                if act_order:
                    key = SHARED.get(name, name)
                    if key not in gidx:
                        g = np.empty(K, np.int32)
                        g[rng.permutation(K)] = np.arange(K) // G
                        gidx[key] = g
                    sd[base + ".g_idx"] = gidx[key]
            else:
                sd[base + ".qweight"] = pack_nibbles(codes, 1, J.AWQ_ORDER)
                sd[base + ".qzeros"] = pack_nibbles(zeros, 1, J.AWQ_ORDER)
            sd[base + ".scales"] = scales
        for n in ("input_layernorm", "post_attention_layernorm"):
            sd[p + n + ".weight"] = (1 + 0.1 * rng.standard_normal(D)) \
                .astype(np.float16)
    sd["model.embed_tokens.weight"] = (rng.standard_normal((VOCAB, D))
                                       * 0.5).astype(np.float16)
    sd["model.norm.weight"] = np.ones(D, np.float16)
    sd["lm_head.weight"] = (rng.standard_normal((VOCAB, D)) * 0.1) \
        .astype(np.float16)
    # the packers return strided views along N; safetensors writes C order
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


HF_KW = dict(vocab_size=VOCAB, hidden_size=D, intermediate_size=I_,
             num_hidden_layers=NL, num_attention_heads=HQ,
             num_key_value_heads=HKV, max_position_embeddings=512)


def write_checkpoint(path, fmt, minimal=False, seed=0):
    """config.json (``MistralConfig.save_pretrained``'s, or a hand-written
    minimal one that leaves every default out), the quantize config
    (``quantize_config.json`` for GPTQ, ``quantization_config`` in the
    config for AWQ) and model.safetensors."""
    os.makedirs(path, exist_ok=True)
    if minimal:
        with open(os.path.join(path, "config.json"), "w") as fh:
            json.dump({"model_type": "mistral", **HF_KW}, fh)
    else:
        transformers.MistralConfig(**HF_KW).save_pretrained(path)
    qc = {"bits": 4, "group_size": G, "desc_act": fmt == "gptq",
          "sym": False}
    if fmt == "gptq":
        with open(os.path.join(path, "quantize_config.json"), "w") as fh:
            json.dump(qc, fh)
    else:
        with open(os.path.join(path, "config.json")) as fh:
            c = json.load(fh)
        c["quantization_config"] = {**qc, "quant_method": "awq"}
        with open(os.path.join(path, "config.json"), "w") as fh:
            json.dump(c, fh)
    stn.save_file(gptq_state_dict(fmt, seed),
                  os.path.join(path, "model.safetensors"))


@pytest.fixture(scope="module", params=[("gptq", False), ("gptq", True),
                                        ("awq", False)],
                ids=["gptq", "gptq_minimal_config", "awq"])
def loaded(request, tmp_path_factory):
    fmt, minimal = request.param
    path = str(tmp_path_factory.mktemp(fmt))
    write_checkpoint(path, fmt, minimal)
    kw = dict(use_gptq=fmt == "gptq", use_awq=fmt == "awq")
    jm = JModel().init(path, **kw)
    jm.params = jparams_to_native(jm.params, force=True, min_elems=0)
    pm = Model().init(path, device="cpu", **kw)
    return fmt, jm, pm


def test_config_and_fields_equal_jax(loaded):
    """The directory's config maps to the JAX package's ModelConfig (its
    AutoConfig filling the defaults a minimal config.json leaves out), and
    every projection the port built equals JAX's, fused q|k|v and gate|up
    with one perm each where the checkpoint is act-order."""
    fmt, jm, pm = loaded
    for f in ("vocab_size", "hidden_size", "n_layers", "n_heads",
              "n_kv_heads", "head_dim", "intermediate_size", "norm_eps",
              "rope_theta", "max_seq_len", "tie_word_embeddings",
              "bos_token_id", "eos_token_ids"):
        assert getattr(pm.cfg, f) == getattr(jm.cfg, f), f
    names = ["wqkv", "wo", "w_gateup", "w_down"] if fmt == "gptq" else \
        ["wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"]
    for i, blk in enumerate(pm.params.layers):
        jlp = _layer(jm.params["layers"], i)
        for n in names:
            _fields_equal(jlp[n], getattr(blk, n).qt)
        if fmt == "gptq":
            assert blk.wqkv.qt.perm is not None
            assert blk.w_gateup.qt.perm is not None
            assert blk.wo.qt.perm is not None
            assert blk.w_down.qt.perm is None          # folded


def test_logits_and_greedy_ids_match_jax(loaded):
    """Prefill logits and decode steps fed JAX's ids within 3e-2·max|logit|,
    ``Model.generate``'s ids equal to JAX's where the margin proves them;
    an act-order decode step gathers x three times a layer."""
    fmt, jm, pm = loaded
    ids = np.random.default_rng(5).integers(3, VOCAB, 40).tolist()
    jout = jm.generate(ids, max_new_tokens=N_NEW, do_sample=False,
                       stop_at_eos=False)[0]
    pout = pm.generate(ids, max_new_tokens=N_NEW, do_sample=False,
                       stop_at_eos=False)[0]
    T = len(ids)
    jnew, pnew = jout[T:], pout[T:]
    jc = jinit_cache(jm.cfg, 1, T + N_NEW)
    jlg, jc = jprefill_step(jm.params, jnp.asarray([ids], jnp.int32),
                            jnp.zeros((1,), jnp.int32), jc, jm.cfg)
    pc = init_cache(pm.cfg, 1, T + N_NEW, device="cpu")
    plg = prefill_step(pm.params, torch.tensor([ids]),
                       torch.zeros(1, dtype=torch.long), pc)

    def close(a, b):
        b = np.asarray(b, np.float32)[0, -1]
        a = np.asarray(a, np.float32)[0, -1]
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=REL_TOL * np.abs(b).max())
        return float(np.abs(a - b).max())

    errs = [close(plg.numpy(), jlg)]
    for s, tok in enumerate(jnew[:-1]):
        jlg, jc = jmodel_step(jm.params, jnp.asarray([[tok]], jnp.int32),
                              jnp.asarray([T + s], jnp.int32), jc, jm.cfg)
        _cuda.reset_launches()
        plg = model_step(pm.params, torch.tensor([[tok]]),
                         torch.tensor([T + s]), pc)
        gathers = _cuda.launch_counts()["act_order_gather"]
        assert gathers == (3 * NL if fmt == "gptq" else 0)
        errs.append(close(plg.numpy(), jlg))
    proven = 0
    for i, ((m, _), e) in enumerate(zip(_jax_margins(jm, ids, jnew), errs)):
        if m > 2 * 1.1 * e:
            assert pnew[i] == jnew[i], (i, pnew, jnew, errs)
            proven += 1
        if pnew[i] != jnew[i]:
            break
    assert proven >= MIN_PROVEN, (pnew, jnew, errs)


def test_fuse_layer_weights_fuses_what_jax_fuses():
    """On an act-order state dict built into param dicts by both packages:
    the port fuses the layers JAX fuses, with equal fields, and the fused
    decoder gives the unfused one's logits; mismatched perms, mixed
    configs or biases present on one side only stay unfused."""
    cfg = llama.config_from_hf(transformers.MistralConfig(**HF_KW))
    qsd = P.qtensor_state_dict(gptq_state_dict("gptq", seed=3),
                               device="cpu")
    P._fold_act_order_sd(qsd, cfg, llama)
    params = build_param_dict(qsd, cfg, llama, quant=None, device="cpu")
    fused = fuse_layer_weights(params, cfg)
    jparams = J.params_from_gptq_state_dict(
        gptq_state_dict("gptq", seed=3),
        jllama.config_from_hf(transformers.MistralConfig(**HF_KW)))
    for i, lp in enumerate(fused["layers"]):
        assert set(lp) >= {"wqkv", "w_gateup"} and "wq" not in lp
        for n in ("wqkv", "w_gateup"):
            _fields_equal(_layer(jparams["layers"], i)[n], lp[n])
    toks, start = torch.tensor([[3, 1, 4, 1, 5, 9, 2, 6]]), torch.zeros(
        1, dtype=torch.long)
    logits = [prefill_step(Transformer(cfg, params_to_native(p)), toks, start,
                           init_cache(cfg, 1, 16, device="cpu"))
              for p in (params, fused)]
    torch.testing.assert_close(logits[1], logits[0], rtol=0,
                               atol=1e-2 * logits[0].abs().max().item())
    lp = dict(params["layers"][0])
    lp["wk"] = dataclasses_replace_perm(lp["wk"], lp["wq"].perm.flip(0))
    assert "wqkv" not in fuse_layer_weights(dict(params, layers=[lp]),
                                            cfg)["layers"][0]
    lp = dict(params["layers"][0], b_gate=torch.zeros(I_))
    assert "w_gateup" not in fuse_layer_weights(dict(params, layers=[lp]),
                                                cfg)["layers"][0]


def dataclasses_replace_perm(qt, perm):
    return QTensor(qt.planes, qt.scales, qt.zeros, perm, qt.cfg)


def test_model_init_reads_the_directory(tmp_path):
    """``Model.init`` on a GPTQ directory: the safetensors reader gives the
    arrays that were written, the bits and group come from the quantize
    config, and the fp branch raises, naming what is not ported."""
    write_checkpoint(str(tmp_path), "gptq")
    sd = read_safetensors_dir(str(tmp_path))
    want = gptq_state_dict("gptq")
    assert sd.keys() == want.keys()
    for k in want:
        assert sd[k].dtype == want[k].dtype
        np.testing.assert_array_equal(sd[k], want[k])
    cfg = read_config(str(tmp_path))
    assert cfg.model_type == "mistral" and cfg.num_key_value_heads == HKV
    with pytest.raises(NotImplementedError, match="stream"):
        Model().init(str(tmp_path), device="cpu")
