"""GGUF in the port against the JAX package, on files both write: the
writer/reader round trip and files crossing between the packages both
ways; every ggml type's unpack (the port's numpy reader and its torch
``unpack_blocks``) bit-equal to JAX's; the port's ``load_gguf`` (block
bytes unpacked on the device straight into the at-rest layout) equal,
tensor for tensor, to the JAX ``load_gguf`` followed by the port's
``params_to_native``, with a constant group (``d == 0``, ``m != 0``) in
every quantized tensor; ``export_gguf`` byte-equal to JAX's; and tiny-Llama
greedy ids from ``init_from_bin`` against JAX's ``Model.init_from_bin``.

Two tiny models cover the ten types between them (a model's projection of
one name shares a type across layers, since JAX stacks them): MIX_A and
MIX_B below. Logits tolerance and the greedy-id rule are
``test_torch_model.py``'s (3e-2·max|ref|; ids compared up to the first
step whose JAX margin falls below it).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_tpu.api import Model as JModel
from neural_tpu.convert import gguf as JG
from neural_tpu.convert.gguf_models import load_gguf as jload_gguf

from neural_tpu_torch.api import Model
from neural_tpu_torch.convert import gguf as PG
from neural_tpu_torch.convert.from_jax import params_from_numpy
from neural_tpu_torch.convert.gguf_models import (load_gguf, unpack_blocks,
                                                  random_block_bytes)
from test_torch_bridge import jax_tree_to_numpy
from test_torch_model import REL_TOL, _jax_margins

D, FFN, VOCAB, H, HKV = 256, 512, 256, 4, 2
DH = D // H
TYPES = {"Q4_0": JG.GGML_Q4_0, "Q4_1": JG.GGML_Q4_1, "Q5_0": JG.GGML_Q5_0,
         "Q5_1": JG.GGML_Q5_1, "Q8_0": JG.GGML_Q8_0, "Q2_K": JG.GGML_Q2_K,
         "Q3_K": JG.GGML_Q3_K, "Q4_K": JG.GGML_Q4_K, "Q5_K": JG.GGML_Q5_K,
         "Q6_K": JG.GGML_Q6_K}
# the byte offset of each type's fp16 scale d in its block
D_AT = {"Q2_K": 80, "Q3_K": 108, "Q6_K": 208}
SHAPES = {"attn_q": (D, D), "attn_k": (HKV * DH, D), "attn_v": (HKV * DH, D),
          "attn_output": (D, D), "ffn_gate": (FFN, D), "ffn_up": (FFN, D),
          "ffn_down": (D, FFN)}
MIX_A = {"attn_q": "Q4_0", "attn_k": "Q4_1", "attn_v": "Q5_0",
         "attn_output": "Q5_1", "ffn_gate": "Q8_0", "ffn_up": "Q2_K",
         "ffn_down": "Q3_K", "output": "Q6_K", "token_embd": "Q4_0"}
MIX_B = {"attn_q": "Q4_K", "attn_k": "Q5_K", "attn_v": "Q6_K",
         "attn_output": "Q2_K", "ffn_gate": "Q3_K", "ffn_up": "Q4_1",
         "ffn_down": "Q5_1", "output": "Q8_0", "token_embd": "Q4_K"}


def packed(arr, type_name, const_group=True):
    """``arr`` quantized by the JAX package's packer for the type, with the
    first block's d set to 0 (a constant group where the type has mins)."""
    tmp = JG.GGUFWriter("")
    tmp.add_tensor("x", arr, TYPES[type_name])
    data = bytearray(tmp.tensors[0][3])
    if const_group:
        at = D_AT.get(type_name, 0)
        data[at:at + 2] = b"\0\0"
    return bytes(data)


def write_model(path, types, seed=0, n_layers=2, writer=JG.GGUFWriter,
                tokens=None, tie=False):
    """A tiny llama GGUF file: each projection of the type ``types`` gives
    it ("F32" or a ggml type name), norms F32."""
    rng = np.random.default_rng(seed)
    w = writer(path)
    if tokens is not None:
        w.add_kv("tokenizer.ggml.model", "llama")
        w.add_kv("tokenizer.ggml.tokens", tokens)
        w.add_kv("tokenizer.ggml.scores",
                 -np.arange(len(tokens), dtype=np.float32))
    for k, v in (("general.architecture", "llama"),
                 ("llama.embedding_length", D), ("llama.block_count",
                                                  n_layers),
                 ("llama.attention.head_count", H),
                 ("llama.attention.head_count_kv", HKV),
                 ("llama.feed_forward_length", FFN),
                 ("llama.context_length", 256),
                 ("llama.rope.freq_base", 10000.0),
                 ("llama.attention.layer_norm_rms_epsilon", 1e-5),
                 ("tokenizer.ggml.bos_token_id", 1),
                 ("tokenizer.ggml.eos_token_id", 2)):
        w.add_kv(k, v)

    def tensor(name, shape, type_name, scale):
        arr = (rng.standard_normal(shape) * scale).astype(np.float32)
        if type_name == "F32":
            w.add_tensor(name, arr, JG.GGML_F32)
        else:
            w.add_tensor_raw(name, shape, TYPES[type_name],
                             packed(arr, type_name))

    def norm(name):
        w.add_tensor(name, (1 + 0.1 * rng.standard_normal(D))
                     .astype(np.float32), JG.GGML_F32)

    tensor("token_embd.weight", (VOCAB, D), types["token_embd"], 1.0)
    norm("output_norm.weight")
    if not tie:
        tensor("output.weight", (VOCAB, D), types["output"], 0.05)
    for i in range(n_layers):
        norm(f"blk.{i}.attn_norm.weight")
        norm(f"blk.{i}.ffn_norm.weight")
        for name, shape in SHAPES.items():
            tensor(f"blk.{i}.{name}.weight", shape, types[name], 0.05)
    w.write()


def test_writer_reader_roundtrip_both_ways(tmp_path):
    """Each package's writer gives the same bytes, and each reader reads
    the other's file: kvs, F32/F16/BF16 and a quantized tensor."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((8, 64)).astype(np.float32)
    b = rng.standard_normal((4, 32)).astype(np.float32)
    files = {}
    for tag, mod in (("jax", JG), ("port", PG)):
        p = str(tmp_path / f"{tag}.gguf")
        w = mod.GGUFWriter(p)
        w.add_kv("general.architecture", "llama")
        w.add_kv("llama.block_count", 2)
        w.add_kv("f", 1.5)
        w.add_kv("tokens", ["a", "bb", "ccc"])
        w.add_kv("arr", np.asarray([1, 2, 3], np.int32))
        w.add_tensor("a", a, mod.GGML_F32)
        w.add_tensor("h", b, mod.GGML_F16)
        w.add_tensor("bf", b, mod.GGML_BF16)
        w.add_tensor("aq", a, mod.GGML_Q4_0)
        w.write()
        files[tag] = p
    with open(files["jax"], "rb") as f1, open(files["port"], "rb") as f2:
        assert f1.read() == f2.read()
    for reader in (JG.GGUFReader, PG.GGUFReader):
        r = reader(files["jax" if reader is PG.GGUFReader else "port"])
        assert r.kv["general.architecture"] == "llama"
        assert r.kv["llama.block_count"] == 2 and r.kv["f"] == 1.5
        assert r.kv["tokens"] == ["a", "bb", "ccc"]
        np.testing.assert_array_equal(r.kv["arr"], [1, 2, 3])
        np.testing.assert_array_equal(r.dequantize("a"), a)
        np.testing.assert_allclose(r.dequantize("h"), b, atol=1e-3)
        np.testing.assert_allclose(r.dequantize("bf"), b, rtol=1e-2)
        r.close()
    jr, pr = JG.GGUFReader(files["port"]), PG.GGUFReader(files["port"])
    for name in ("bf", "aq"):
        np.testing.assert_array_equal(pr.dequantize(name),
                                      jr.dequantize(name))
    jr.close()
    pr.close()


def test_bf16_bits_round_to_nearest_even():
    """The writer's bf16 rounding (no ml_dtypes in the port) equals
    ml_dtypes', NaN and ±inf included."""
    ml_dtypes = pytest.importorskip("ml_dtypes")
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.standard_normal(4096).astype(np.float32) * 300,
                        np.array([0.0, -0.0, np.inf, -np.inf, np.nan,
                                  1 + 2 ** -8, 1 + 3 * 2 ** -8],
                                 np.float32)])
    want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    got = PG.bf16_bits(x)
    nan = np.isnan(x)
    np.testing.assert_array_equal(got[~nan], want[~nan])
    assert np.isnan((got[nan].astype(np.uint32) << 16).view(np.float32)).all()


@pytest.mark.parametrize("type_name", list(TYPES))
def test_unpack_equals_jax(tmp_path, type_name):
    """Codes, scales and mins of every type, from the port's numpy reader
    and from its torch ``unpack_blocks``, bit-equal to the JAX reader's
    (the K-quants' scales in f64, as numpy promotes them)."""
    p = str(tmp_path / "t.gguf")
    rng = np.random.default_rng(3)
    arr = (rng.standard_normal((8, 512)) * 0.1).astype(np.float32)
    w = JG.GGUFWriter(p)
    w.add_tensor_raw("w", arr.shape, TYPES[type_name],
                     packed(arr, type_name))
    w.write()
    jr, pr = JG.GGUFReader(p), PG.GGUFReader(p)
    want = jr.unpack_quantized("w")
    got = pr.unpack_quantized("w")
    blk = torch.from_numpy(np.frombuffer(
        bytes(pr.tensor_bytes(pr.tensors["w"])), np.uint8).copy()
    ).reshape(-1, JG._BLOCK_BYTES[TYPES[type_name]])
    dev = unpack_blocks(blk, TYPES[type_name])
    for i, (x, y, z) in enumerate(zip(want, got, dev)):
        if x is None:
            assert y is None and z is None
            continue
        if i == 3:
            assert x == y == z
            continue
        np.testing.assert_array_equal(y, x)
        z = z.numpy()
        assert z.dtype == np.asarray(x).dtype or i == 0, (i, z.dtype)
        np.testing.assert_array_equal(z, x)
    jr.close()
    pr.close()


def _state(model):
    return {k: v for k, v in model.state_dict().items()}


def _assert_same_model(a, b):
    sa, sb = _state(a), _state(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype, k
        assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("type_name", list(TYPES))
def test_load_gguf_equals_jax_at_rest(tmp_path, type_name):
    """A one-layer model whose every quantized tensor (the embedding and
    the lm_head too) is of one type, with a constant group in each: the
    port's ``load_gguf`` equals JAX's ``load_gguf`` then the port's
    ``params_to_native``, field for field (codes, bf16 scales, shifted
    bf16 zero-points, configs), and its FFN stays unpadded."""
    p = str(tmp_path / "m.gguf")
    types = dict.fromkeys(list(SHAPES) + ["output", "token_embd"], type_name)
    write_model(p, types, seed=5, n_layers=1)
    jparams, jcfg = jload_gguf(p)
    bridged = params_from_numpy(jax_tree_to_numpy(jparams), jcfg, "cpu")
    model, cfg = load_gguf(p, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    _assert_same_model(model, bridged)
    assert model.layers[0].w_down.qt.shape == (FFN, D)
    zeros = model.layers[0].wk.qt.zeros
    if zeros is not None:       # the constant group's stand-in zero-point
        assert zeros.float().abs().max() > 1e6


@pytest.fixture(scope="module", params=["MIX_A", "MIX_B"])
def mixed(request, tmp_path_factory):
    types = {"MIX_A": MIX_A, "MIX_B": MIX_B}[request.param]
    p = str(tmp_path_factory.mktemp("gguf") / f"{request.param}.gguf")
    write_model(p, types, seed=7)
    jm = JModel().init_from_bin(p)
    pm = Model().init_from_bin(p, device="cpu")
    return p, jm, pm


def test_mixed_models_load_equal(mixed):
    """Both tiny models, through ``Model.init_from_bin`` on each side."""
    p, jm, pm = mixed
    _assert_same_model(pm.params, params_from_numpy(
        jax_tree_to_numpy(jm.params), jm.cfg, "cpu"))
    assert {lp.wq.cfg.bits for lp in pm.params.layers} == \
        {jm.params["layers"]["wq"].cfg.bits}


PROMPT = [1, 37, 201, 9, 144, 77, 3, 250, 18, 91, 66, 120]
N_NEW = 8


def _rows(step, ids, new):
    """Logits rows [V] f32 of the prompt's last token and of each of
    ``new`` fed back, through ``step(tokens, start)``."""
    rows = [step(list(ids), 0)]
    for i, tok in enumerate(new[:-1]):
        rows.append(step([tok], len(ids) + i))
    return rows


def _jax_step(jm, S):
    from neural_tpu.runtime.generate import model_step as jmodel_step
    from neural_tpu.runtime.kvcache import init_cache as jinit_cache
    box = [jinit_cache(jm.cfg, 1, S)]

    def step(toks, start):
        logits, box[0] = jmodel_step(
            jm.params, jnp.asarray([toks], jnp.int32),
            jnp.asarray([start], jnp.int32), box[0], jm.cfg)
        return np.asarray(logits[0, -1], np.float32)
    return step


def _port_step(pm, S):
    from neural_tpu_torch.runtime.generate import model_step
    from neural_tpu_torch.runtime.kvcache import init_cache
    cache = init_cache(pm.cfg, 1, S, device="cpu")

    def step(toks, start):
        return model_step(pm.params, torch.tensor([toks]),
                          torch.tensor([start]), cache)[0, -1].numpy()
    return step


def test_greedy_ids_from_file_equal_jax(mixed):
    """``init_from_bin(...).generate`` greedy ids on each side. Each step's
    logits, fed JAX's ids, lie within 3e-2·max|logit| of JAX's; the ids
    are equal up to the first step where they part, which must be a step
    whose JAX penalized top-2 margin is under 2.2 times that step's
    largest difference (the repetition penalty scales a logit by at most
    1.1): there a rounding may rightly pick the other token. At least four
    equal steps must be proven by their margins."""
    _, jm, pm = mixed
    T = len(PROMPT)
    jout = jm.generate(PROMPT, max_new_tokens=N_NEW, stop_at_eos=False)[0]
    pout = pm.generate(PROMPT, max_new_tokens=N_NEW, stop_at_eos=False)[0]
    jnew, pnew = jout[T:], pout[T:]
    jrows = _rows(_jax_step(jm, T + N_NEW), PROMPT, jnew)
    prows = _rows(_port_step(pm, T + N_NEW), PROMPT, jnew)
    margins = _jax_margins(jm, PROMPT, jnew, jrows)
    proven = 0
    for i, (a, b, (m, _)) in enumerate(zip(prows, jrows, margins)):
        err = np.abs(a - b).max()
        assert err <= REL_TOL * np.abs(b).max(), (i, err, np.abs(b).max())
        if pnew[i] != jnew[i]:
            assert m <= 2.2 * err, (i, pnew, jnew, margins)
            break
        proven += m > 2.2 * err
    assert proven >= 4, (margins, pnew, jnew)


def test_port_written_file_loads_in_jax(tmp_path):
    """A file written by the port's writer from the port's random block
    bytes loads in JAX and in the port to the same model."""
    p = str(tmp_path / "r.gguf")
    gen = torch.Generator().manual_seed(0)
    w = PG.GGUFWriter(p)
    for k, v in (("general.architecture", "llama"),
                 ("llama.embedding_length", D), ("llama.block_count", 1),
                 ("llama.attention.head_count", H),
                 ("llama.attention.head_count_kv", HKV),
                 ("llama.feed_forward_length", FFN)):
        w.add_kv(k, v)
    shapes = {"token_embd.weight": ((VOCAB, D), PG.GGML_Q4_0),
              "output.weight": ((VOCAB, D), PG.GGML_Q6_K)}
    shapes.update({f"blk.0.{n}.weight": (s, PG.GGML_Q4_1)
                   for n, s in SHAPES.items()})
    for name, (shape, tt) in shapes.items():
        blk = random_block_bytes(tt, shape[0] * shape[1], gen)
        w.add_tensor_raw(name, shape, tt, blk.numpy().tobytes())
    for name in ("output_norm.weight", "blk.0.attn_norm.weight",
                 "blk.0.ffn_norm.weight"):
        w.add_tensor(name, np.ones(D, np.float32), PG.GGML_F32)
    w.write()
    jparams, jcfg = jload_gguf(p)
    model, cfg = load_gguf(p, device="cpu")
    _assert_same_model(model, params_from_numpy(jax_tree_to_numpy(jparams),
                                                jcfg, "cpu"))
    w_q = model.layers[0].wq.qt
    assert w_q.cfg.bits == 4 and not w_q.cfg.sym and w_q.cfg.native_pack


@pytest.mark.parametrize("ggml_type", ["Q4_0", "Q6_K"])
def test_export_gguf_byte_equal_to_jax(tmp_path, ggml_type):
    """``export_gguf`` of a tiny HF Llama: the port's file is JAX's, byte
    for byte."""
    transformers = pytest.importorskip("transformers")
    from neural_tpu.convert.gguf_models import export_gguf as jexport
    from neural_tpu_torch.convert.gguf_models import export_gguf
    hc = transformers.LlamaConfig(
        vocab_size=VOCAB, hidden_size=D, intermediate_size=FFN,
        num_hidden_layers=1, num_attention_heads=H, num_key_value_heads=HKV,
        max_position_embeddings=256)
    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(hc).eval()
    a, b = str(tmp_path / "j.gguf"), str(tmp_path / "p.gguf")
    jexport(hf, a, TYPES[ggml_type])
    export_gguf(hf, b, TYPES[ggml_type])
    with open(a, "rb") as f1, open(b, "rb") as f2:
        assert f1.read() == f2.read()
