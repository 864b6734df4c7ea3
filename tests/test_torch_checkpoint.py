"""The native checkpoint (NTPU) and session files in the port against the
JAX package: files cross both ways with every leaf kind (native-pack
nibbles, int8 code planes, JAX ``int4`` planes, bit-plane packed codes, fp8,
bf16, f32, bool and integer leaves) bit for bit; a model saved by either
package loads in the other (the port's load equal to the bridged JAX tree
exactly, JAX's logits on the port's file within ``test_torch_model.py``'s
3e-2·max|logit|); session files cross both ways (cache, positions, logits
and prompt exactly; each package ignores the other's random state, and a
greedy resume from the other's file starts from that file's logits); and
the twins of ``tests/test_api.py``'s session tests on the port.
"""
import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from neural_tpu.api import Model as JModel
from neural_tpu.convert import checkpoint as JC
from neural_tpu.core.dtypes import PRESETS as JPRESETS
from neural_tpu.core.qtensor import QTensor as JQT
from neural_tpu.core.qtensor import quantize as jquantize
from neural_tpu.core.qtensor import to_native as jto_native
from neural_tpu.runtime.kvcache import KVCache as JKV

from neural_tpu_torch.api import Model
from neural_tpu_torch.convert import checkpoint as PC
from neural_tpu_torch.convert.from_jax import (params_from_numpy,
                                               qtensor_from_numpy,
                                               tensor_to_numpy)
from neural_tpu_torch.convert.hf import init_random
from neural_tpu_torch.core.dtypes import PRESETS
from neural_tpu_torch.core.qtensor import QTensor, quantize, to_native
from neural_tpu_torch.models.config import ModelConfig
from neural_tpu_torch.runtime.kvcache import KVCache, init_cache
from test_torch_bridge import jax_qtensor_to_numpy, jax_tree_to_numpy
from test_torch_model import REL_TOL


def _w(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 0.05


def port_tree():
    """Every leaf kind the port writes."""
    w = torch.from_numpy(_w((128, 64), 0))
    return {
        "nibbles": to_native(quantize(w, PRESETS["q4_j"])),
        "int2": to_native(quantize(w, PRESETS["int2"])),
        "int8_codes": to_native(quantize(w, PRESETS["int5"])),
        "fp8": quantize(w, PRESETS["fp8"]),
        "fp8_e5m2": quantize(w, PRESETS["fp8_e5m2"]),
        "bf16": w.to(torch.bfloat16),
        "layers": [{"f32": w[0], "flag": torch.tensor(True)},
                   {"f32": w[1], "flag": torch.tensor(False)}],
        "ids": torch.arange(5, dtype=torch.int64),
    }


def _np(x):
    """A JAX-side leaf as numpy (bf16 → uint16 bits, fp8 → uint8 bits,
    int4 → int8)."""
    a = np.asarray(x)
    if a.dtype == ml_dtypes.bfloat16:
        return a.view(np.uint16)
    if a.dtype in (ml_dtypes.float8_e4m3fn, ml_dtypes.float8_e5m2):
        return a.view(np.uint8)
    if a.dtype == ml_dtypes.int4:
        return a.astype(np.int8)
    return a


def _leaves_equal(port, jax_leaf):
    if isinstance(port, QTensor):
        assert isinstance(jax_leaf, JQT)
        assert dataclasses.asdict(port.cfg) == \
            dataclasses.asdict(jax_leaf.cfg)
        for name in ("scales", "zeros", "perm"):
            a, b = getattr(port, name), getattr(jax_leaf, name)
            assert (a is None) == (b is None), name
            if a is not None:
                _leaves_equal(a, b)
        assert len(port.planes) == len(jax_leaf.planes)
        for a, b in zip(port.planes, jax_leaf.planes):
            _leaves_equal(a, b)
    elif isinstance(port, dict):
        assert port.keys() == jax_leaf.keys()
        for k in port:
            _leaves_equal(port[k], jax_leaf[k])
    elif isinstance(port, (list, tuple)):
        assert len(port) == len(jax_leaf)
        for a, b in zip(port, jax_leaf):
            _leaves_equal(a, b)
    else:
        a, b = tensor_to_numpy(port), _np(jax_leaf)
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_port_file_reads_in_jax(tmp_path):
    p = str(tmp_path / "p.ntpu")
    tree = port_tree()
    PC.save_checkpoint(p, tree)
    got, cfg, _ = JC.load_checkpoint(p, to_jnp=False)
    assert cfg is None
    _leaves_equal(tree, got)
    back, _, _ = PC.load_checkpoint(p, "cpu")
    _leaves_equal(back, got)
    assert back["bf16"].dtype == torch.bfloat16
    assert back["fp8"].planes[0].dtype == torch.float8_e4m3fn


def test_jax_file_reads_in_port(tmp_path):
    """A JAX file with bit-plane packed codes, ``int4`` code planes, fp8,
    bf16 and stacked layers; the int4 planes become native-pack nibbles of
    the same codes."""
    p = str(tmp_path / "j.ntpu")
    w = jnp.asarray(_w((128, 64), 1))
    q4 = jquantize(w, JPRESETS["q4_j"])
    tree = {"packed": q4, "int4": jto_native(q4),
            "int6": jto_native(jquantize(w, JPRESETS["int5"])),
            "fp8": jquantize(w, JPRESETS["fp8"]),
            "bf16": w.astype(jnp.bfloat16),
            "layers": {"norm": jnp.ones((2, 64), jnp.float32),
                       "use_sliding": jnp.asarray([True, False])}}
    assert tree["int4"].planes[0].dtype == jnp.int4
    JC.save_checkpoint(p, tree)
    got, _, _ = PC.load_checkpoint(p, "cpu")
    for k in ("packed", "int6", "fp8", "bf16"):
        _leaves_equal(got[k], tree[k])
    assert got["int4"].planes[0].dtype == torch.int8
    norm = PC.param_tree(got)
    assert [lp["use_sliding"].item() for lp in norm["layers"]] == \
        [True, False]
    nib = norm["int4"]
    packed = to_native(qtensor_from_numpy(jax_qtensor_to_numpy(q4), "cpu"))
    assert nib.cfg == packed.cfg
    assert torch.equal(nib.planes[0], packed.planes[0])
    assert torch.equal(nib.scales, packed.scales)


def tiny_hf():
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=256, hidden_size=128, intermediate_size=352,
        num_hidden_layers=2, num_attention_heads=8,
        num_key_value_heads=4)).eval()


def test_jax_model_file_loads_in_port(tmp_path):
    """``Model.save`` of a JAX q4_0 model → the port's ``init_from_bin``:
    every tensor equals the bridged JAX tree's."""
    p = str(tmp_path / "j.ntpu")
    jm = JModel().init_from_hf_model(tiny_hf(), "q4_0")
    jm.save(p)
    pm = Model().init_from_bin(p, device="cpu")
    want = params_from_numpy(jax_tree_to_numpy(jm.params), jm.cfg, "cpu")
    a, b = pm.params.state_dict(), want.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    assert dataclasses.asdict(pm.cfg) == dataclasses.asdict(jm.cfg)


def test_port_model_file_loads_in_jax(tmp_path):
    """The port's at-rest model (native-pack, int8 codes and an fp8
    lm_head, from a registry) saved and loaded by JAX: its logits within
    3e-2·max|logit| of the port's, and loaded back by the port equal."""
    from neural_tpu_torch.convert.quant_registry import QuantRegistry
    reg = QuantRegistry([("w_down", "int5"), ("lm_head", "fp8")],
                        default="q4_0")
    pm = Model().init_from_hf_model(tiny_hf(), reg, device="cpu")
    p = str(tmp_path / "p.ntpu")
    pm.save(p)
    jm = JModel().init_from_bin(p)
    rows = [[3, 17, 91, 5, 6], [9, 1, 2]]
    want = pm(rows)
    got = np.asarray(jm(rows))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL_TOL * np.abs(want).max())
    back = Model().init_from_bin(p, device="cpu")
    a, b = back.params.state_dict(), pm.params.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------

CFG = ModelConfig(arch="llama", vocab_size=96, hidden_size=64, n_layers=2,
                  n_heads=4, n_kv_heads=4, head_dim=16, intermediate_size=128,
                  max_seq_len=64, eos_token_id=999)


@pytest.fixture(scope="module")
def small():
    return Model().init_params(init_random(CFG, seed=3, quant="q4_0",
                                           device="cpu"), CFG)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_session_files_cross_both_ways(tmp_path, small, kv):
    """The port's session file read by JAX and a JAX file read by the port:
    KV (bf16, or int8 codes with bf16 scales), positions, logits, prompt
    and mu exactly; JAX's ``rng_key`` is not read by the port, and the
    port's generator state is not read by JAX."""
    prompt = [3, 14, 15, 9, 2]
    p = str(tmp_path / "p.ntpus")
    small.generate(prompt, max_new_tokens=2, max_len=32, kv_dtype=kv,
                   session_file=p)
    pc, plens, pextra = PC.load_session(p, "cpu")
    jc, jlens, jextra = JC.load_session(p)
    assert "rng_key" not in jextra
    assert list(jlens) == list(plens) == [len(prompt)]
    assert jextra["prompt_ids"] == pextra["prompt_ids"] == prompt
    for a, b in ((pc.k, jc.k), (pc.v, jc.v), (pc.k_scale, jc.k_scale),
                 (pc.v_scale, jc.v_scale), (pextra["logits"],
                                            jextra["logits"]),
                 (pextra["sampler_mu"], jextra["sampler_mu"])):
        assert (a is None) == (b is None)
        if a is not None:
            _leaves_equal(a, b)
    assert pextra["torch_generator"].dtype == torch.uint8

    q = str(tmp_path / "j.ntpus")
    cache = JKV(jc.k, jc.v, jc.k_scale, jc.v_scale)
    JC.save_session(q, cache, [len(prompt)], {"prompt_ids": prompt},
                    logits=jextra["logits"], rng_key=jnp.asarray([0, 7],
                                                                 jnp.uint32),
                    sampler_mu=jextra["sampler_mu"])
    qc, qlens, qextra = PC.load_session(q, "cpu")
    assert "rng_key" not in qextra and "torch_generator" not in qextra
    assert list(qlens) == [len(prompt)]
    for a, b in ((qc.k, pc.k), (qc.v, pc.v), (qc.k_scale, pc.k_scale),
                 (qextra["logits"], pextra["logits"])):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


def test_greedy_resume_from_the_other_packages_file(tmp_path):
    """A full-match greedy resume starts from the file's logits: the port
    resuming from JAX's file draws JAX's first id, and JAX resuming from
    the port's file draws the port's (same weights on both sides)."""
    hf = tiny_hf()
    jm = JModel().init_from_hf_model(hf, "q4_0")
    pm = Model().init_from_bin(_saved(jm, tmp_path), device="cpu")
    prompt = [3, 17, 91, 5]
    kw = dict(max_new_tokens=4, stop_at_eos=False, max_len=32)
    j_file, p_file = str(tmp_path / "j.s"), str(tmp_path / "p.s")
    jfirst = jm.generate(prompt, session_file=j_file, **kw)[0]
    pfirst = pm.generate(prompt, session_file=p_file, **kw)[0]
    p_from_j = pm.generate(prompt, session_file=j_file, **kw)[0]
    j_from_p = jm.generate(prompt, session_file=p_file, **kw)[0]
    assert len(p_from_j) == len(j_from_p) == len(prompt) + 4
    assert p_from_j[len(prompt)] == jfirst[len(prompt)]
    assert j_from_p[len(prompt)] == pfirst[len(prompt)]


def _saved(jm, tmp_path):
    p = str(tmp_path / "m.ntpu")
    jm.save(p)
    return p


def test_session_file_prefix_reuse(tmp_path, small):
    """Twin of ``tests/test_api.py``'s: a rerun with the same prompt, an
    extended prompt (the rest evaluated at the saved offset) and a
    divergent one all equal fresh runs."""
    import os
    m = small
    kw = dict(max_new_tokens=6, max_len=64, repetition_penalty=1.0)
    prompt = [3, 14, 15, 9, 2]
    sess = str(tmp_path / "s.ntpus")
    fresh = m.generate(prompt, **kw)[0]
    assert m.generate(prompt, session_file=sess, **kw)[0] == fresh
    assert os.path.exists(sess)
    assert m.generate(prompt, session_file=sess, **kw)[0] == fresh
    longer = prompt + [7, 7, 1]
    assert m.generate(longer, session_file=sess, **kw)[0] == \
        m.generate(longer, **kw)[0]
    other = [9, 9, 9]
    assert m.generate(other, session_file=sess, **kw)[0] == \
        m.generate(other, **kw)[0]


def test_full_state_session_resume_equals_continuous(tmp_path, small):
    """Twin of ``tests/test_api.py``'s: a resumed sampled generation equals
    the uninterrupted run, bit for bit: the snapshot carries the logits,
    the generator state and mirostat's mu."""
    prompt = [3, 17, 91, 5]
    kw = dict(max_new_tokens=8, do_sample=True, temperature=0.9, seed=7,
              stop_at_eos=False, max_len=32)
    p1 = str(tmp_path / "a.ntpu")
    cont = small.generate([prompt], session_file=p1, **kw)[0]
    assert small.generate([prompt], session_file=p1, **kw)[0] == cont
    # another seed: the restored generator state, not the seed, draws
    assert small.generate([prompt], session_file=p1,
                          **dict(kw, seed=8))[0] == cont
    _, _, extra = PC.load_session(p1, "cpu")
    assert {"logits", "torch_generator", "sampler_mu"} <= set(extra)


def test_session_copies_into_the_callers_cache(tmp_path, small):
    """The resumed KV lands in the cache the generation runs on, in place
    (a captured decode step holds that storage): the hooked path's cache
    keeps its tensors and holds the file's rows."""
    prompt = [5, 6, 7, 8]
    sess = str(tmp_path / "c.s")
    small.generate(prompt, max_new_tokens=2, max_len=32, session_file=sess)
    cache = init_cache(CFG, 1, 32, device="cpu")
    k0 = cache.k.data_ptr()
    pos, resumed = small._session_prefill(sess, prompt, None, 0, cache, 2)
    assert pos == len(prompt) and "logits" in resumed
    assert cache.k.data_ptr() == k0
    saved, _, _ = PC.load_session(sess, "cpu")
    assert torch.equal(cache.k, saved.k) and torch.equal(cache.v, saved.v)
    assert isinstance(saved, KVCache)
