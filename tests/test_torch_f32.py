"""f32 parameters at rest and f32 KV caches through the port's entry points,
against the JAX package.

- ``dtype="float32"`` (``Model.init``, ``init_from_hf_model``) keeps the
  embedding, the norm weights, the dense weights and the biases in f32, the
  JAX package's rule (``neural_tpu/api.py``); the activations stay bf16. A
  tiny HF Llama with its norm weights drawn off the bf16 grid goes through
  both packages: equal leaf dtypes, logits within 1e-2·max|ref| (the
  packages round bf16 activations at different places,
  ``tests/test_torch_model.py``; measured at most 6.6e-3·max|ref| over
  twelve prompts), greedy ids equal while JAX's margins stay above that
  tolerance (the prompt is one whose margins all do), and the bf16 load's
  logits apart from the f32 one's.
- ``Model.generate(kv_dtype=...)`` maps any value but int8 to bf16, as the
  JAX package does.
- ``ModelServer(kv_dtype="float32")`` serves from an f32 cache, contiguous
  or paged, as the JAX server does; the port's Scheduler over an f32 cache
  decides as JAX's does at every step.
- ``neural_tpu_torch.convert`` exports the JAX ``convert``'s four names.
"""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import neural_tpu as nt
from neural_tpu.convert import init_random as jinit_random
from neural_tpu.runtime.generate import params_to_native as jparams_to_native
from neural_tpu.runtime.sampling import SamplingParams as JSP
from neural_tpu.serving import Scheduler as JScheduler

import neural_tpu_torch as ntt
from neural_tpu_torch.convert.from_jax import params_from_numpy
from neural_tpu_torch.runtime.kvcache import init_cache, kv_torch_dtype
from neural_tpu_torch.runtime.paged import init_paged_cache
from neural_tpu_torch.runtime.sampling import SamplingParams
from neural_tpu_torch.serving import ModelServer, Query, Scheduler
from test_torch_bridge import jax_tree_to_numpy
from test_torch_serving import _prompts, _trace, tiny_kw

VOCAB = 256
REL_TOL = 1e-2
N_NEW = 8
PROMPT = np.random.default_rng(3).integers(3, VOCAB, 8).tolist()


def _hf():
    """A tiny Llama whose norm weights are f32 values off the bf16 grid."""
    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=VOCAB, hidden_size=128, intermediate_size=384,
        num_hidden_layers=2, num_attention_heads=8,
        num_key_value_heads=4)).eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if name.endswith("norm.weight"):
                p.copy_(1.0 + 0.05 * torch.randn(p.shape, generator=g))
    return hf


@pytest.fixture(scope="module")
def hf():
    return _hf()


@pytest.fixture(scope="module")
def loads(hf):
    """(JAX f32 Model, port f32 Model, port bf16 Model), dense weights."""
    jm = nt.Model().init_from_hf_model(hf, weight_dtype=None,
                                       dtype="float32")
    pm = ntt.Model().init_from_hf_model(hf, weight_dtype=None,
                                        dtype="float32", device="cpu")
    pb = ntt.Model().init_from_hf_model(hf, weight_dtype=None, device="cpu")
    return jm, pm, pb


def _close(out, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(out, np.float32), ref, rtol=0,
                               atol=REL_TOL * np.abs(ref).max())


def test_float32_load_keeps_the_reference_dtypes(loads):
    """Every leaf of the f32 load has the JAX f32 tree's dtype: the norm
    weights, the embedding and the dense projections f32."""
    jm, pm, pb = loads
    pd = pm.params.param_dict()
    for l, lp in enumerate(pd["layers"]):
        for name, t in lp.items():
            ref = jm.params["layers"][name][l]
            assert str(t.dtype).replace("torch.", "") == str(ref.dtype), name
    for name in ("embed", "final_norm_w", "lm_head"):
        assert str(pd[name].dtype).replace("torch.", "") == \
            str(jm.params[name].dtype), name
    assert pd["layers"][0]["attn_norm_w"].dtype == torch.float32
    assert pd["layers"][0]["wq"].dtype == torch.float32
    assert pb.params.param_dict()["layers"][0]["wq"].dtype == torch.bfloat16


def test_float32_logits_and_ids_match_jax(loads):
    jm, pm, pb = loads
    ref = np.asarray(jm([PROMPT]))
    out = pm([PROMPT])
    _close(out, ref)
    # the f32 norm weights move the logits: the bf16 load reads them
    # rounded
    diff = np.abs(pb([PROMPT]) - out).max()
    assert diff > 1e-3 * np.abs(ref).max(), diff
    jout = jm.generate([PROMPT], max_new_tokens=N_NEW, stop_at_eos=False)[0]
    pout = pm.generate([PROMPT], max_new_tokens=N_NEW, stop_at_eos=False)[0]
    assert len(pout) == len(PROMPT) + N_NEW
    from test_torch_model import _jax_margins
    margins = _jax_margins(jm, PROMPT, jout[len(PROMPT):])
    safe = next((i for i, (m, scale) in enumerate(margins)
                 if m < REL_TOL * scale), len(margins))
    assert safe == N_NEW, margins
    assert pout[len(PROMPT):][:safe] == jout[len(PROMPT):][:safe]


@pytest.mark.parametrize("quant", [None, "q4_j"])
def test_model_init_of_a_directory_in_float32(tmp_path, hf, quant):
    """The streamed load of a safetensors directory takes ``dtype`` too:
    its last-row logits against JAX ``Model.init(dir, dtype="float32")``."""
    hf.save_pretrained(tmp_path, safe_serialization=True)
    kw = dict(weight_dtype=quant, use_quant=quant is not None,
              dtype="float32")
    jm = nt.Model().init(str(tmp_path), **kw)
    pm = ntt.Model().init(str(tmp_path), device="cpu", **kw)
    lp = pm.params.param_dict()["layers"][0]
    assert lp["attn_norm_w"].dtype == torch.float32
    _close(pm([PROMPT])[:, -1], np.asarray(jm([PROMPT]))[:, -1])


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "bf16",
                                      torch.float32])
def test_generate_maps_kv_dtype_as_jax(loads, kv_dtype):
    """Any value but int8 is a bf16 cache (``neural_tpu/api.py``): the ids
    equal the default's, and JAX's on the same value."""
    jm, pm, _ = loads
    base = pm.generate([PROMPT], max_new_tokens=4, stop_at_eos=False)
    assert pm.generate([PROMPT], max_new_tokens=4, stop_at_eos=False,
                       kv_dtype=kv_dtype) == base
    if isinstance(kv_dtype, str):
        jbase = jm.generate([PROMPT], max_new_tokens=4, stop_at_eos=False)
        assert jm.generate([PROMPT], max_new_tokens=4, stop_at_eos=False,
                           kv_dtype=kv_dtype) == jbase


def test_caches_take_float32():
    from neural_tpu_torch.models.config import ModelConfig
    cfg = ModelConfig(**tiny_kw())
    c = init_cache(cfg, 2, 32, torch.float32, device="cpu")
    assert c.k.dtype == c.v.dtype == torch.float32 and c.k_scale is None
    p = init_paged_cache(cfg, 2, 32, page_size=16, dtype=torch.float32,
                         device="cpu")
    assert p.k.dtype == torch.float32 and p.k_scale is None
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16),
                     ("int8", torch.int8), (np.float32, torch.float32),
                     (jnp.float32, torch.float32)):
        assert kv_torch_dtype(name) == dt
    with pytest.raises(NotImplementedError):
        kv_torch_dtype("float16")


def _bridged():
    from neural_tpu.models.config import ModelConfig as JMC
    from neural_tpu_torch.models.config import ModelConfig
    jcfg, cfg = JMC(**tiny_kw()), ModelConfig(**tiny_kw())
    jp = jparams_to_native(jinit_random(jcfg, quant="q4_j"), force=True,
                           min_elems=0)
    return jp, jcfg, params_from_numpy(jax_tree_to_numpy(jp), cfg, "cpu"), \
        cfg


@pytest.fixture(scope="module")
def both():
    return _bridged()


@pytest.mark.parametrize("kv_mode", ["slots", "paged"])
def test_server_serves_from_a_float32_cache(both, kv_mode):
    """``ModelServer(kv_dtype="float32")`` passes the dtype through to its
    Scheduler, as the JAX server does; its greedy ids are the Scheduler's."""
    _, _, params, cfg = both
    results = {}

    def cb(done):
        for s in done:
            results[s.request_id] = s.output_ids

    kw = dict(max_batch=2, max_len=64, kv_mode=kv_mode, page_size=16,
              sampling=SamplingParams(greedy=True))
    prompts = [[5, 6, 7 + i] for i in range(3)]
    with ModelServer(params, cfg, cb, kv_dtype="float32", **kw) as srv:
        assert srv.scheduler.cache.k.dtype == torch.float32
        srv.issueQuery([Query(f"q{i}", p, 5) for i, p in enumerate(prompts)])
        t0 = time.time()
        while len(results) < 3 and time.time() - t0 < 120:
            time.sleep(0.05)
    sched = Scheduler(params, cfg, kv_dtype=torch.float32,
                      **{k: v for k, v in kw.items()})
    for i, p in enumerate(prompts):
        sched.add_request(f"q{i}", p, max_new_tokens=5)
    _, done = _trace(sched, kv_mode == "paged")
    assert results == done


@pytest.mark.parametrize("kv_mode", ["slots", "paged"])
def test_port_scheduler_matches_jax_scheduler_over_float32(both, kv_mode):
    """The JAX Scheduler over ``kv_dtype=jnp.float32`` and the port's over
    ``torch.float32``: equal decisions at every step and equal greedy ids
    for at least 10 of 12 requests (``test_torch_serving.py``'s rule)."""
    jp, jcfg, params, cfg = both
    prompts = _prompts(7, 12, 3, 40)
    kw = dict(max_batch=4, max_len=64, prefill_buckets=(8, 16, 32),
              prefill_chunk=16, kv_mode=kv_mode, page_size=16)
    if kv_mode == "paged":
        kw["n_pages"] = 10
    jsched = JScheduler(jp, jcfg, sampling=JSP(greedy=True),
                        kv_dtype=jnp.float32, **kw)
    sched = Scheduler(params, cfg, sampling=SamplingParams(greedy=True),
                      kv_dtype=torch.float32, **kw)
    assert sched.cache.k.dtype == torch.float32
    for s in (jsched, sched):
        for i, p in enumerate(prompts):
            s.add_request(f"q{i}", p, max_new_tokens=6)
    jtrace, jdone = _trace(jsched, kv_mode == "paged")
    trace, done = _trace(sched, kv_mode == "paged")
    assert trace == jtrace
    exact = sum(done[f"q{i}"] == jdone[f"q{i}"] for i in range(12))
    assert exact >= 10


def test_convert_exports_the_jax_names():
    import neural_tpu.convert as jconvert
    import neural_tpu_torch.convert as convert
    from neural_tpu_torch.convert import hf as phf
    from neural_tpu_torch.models import llama
    assert sorted(convert.__all__) == sorted(jconvert.__all__)
    for name in jconvert.__all__:
        assert callable(getattr(convert, name)), name
    try:
        convert.register_arch(["my_llama", "my_llama2"], llama)
        assert phf.ARCH_MODULES["my_llama"] is llama
        assert phf.family("my_llama2") is llama
    finally:
        for n in ("my_llama", "my_llama2"):
            phf.ARCH_MODULES.pop(n, None)
    assert "my_llama" not in phf.ARCH_MODULES


def test_float32_init_random_and_build_params(hf):
    """``init_random`` and ``build_params`` take f32 as the JAX ones do: the
    norms and the dense weights f32."""
    from neural_tpu_torch.convert import build_params, init_random
    from neural_tpu_torch.models import llama
    from neural_tpu_torch.models.config import ModelConfig
    cfg = ModelConfig(**tiny_kw())
    pd = init_random(cfg, dtype=torch.float32, device="cpu").param_dict()
    assert pd["layers"][0]["attn_norm_w"].dtype == torch.float32
    assert pd["embed"].dtype == torch.float32
    hcfg = llama.config_from_hf(hf.config)
    sd = {k: v.detach() for k, v in hf.state_dict().items()}
    bp = build_params(sd, hcfg, llama, None, torch.float32, "cpu")
    assert bp.param_dict()["layers"][1]["ffn_norm_w"].dtype == torch.float32


def test_jax_f32_tree_crosses_unchanged():
    """``convert.from_jax.params_from_numpy`` carries the JAX package's f32
    tree across as it is: every leaf f32 and equal, value for value."""
    from neural_tpu.models.config import ModelConfig as JMC
    from neural_tpu_torch.models.config import ModelConfig
    from test_torch_bridge import to_np
    jp = jinit_random(JMC(**tiny_kw()), dtype=jnp.float32)
    pd = params_from_numpy(jax_tree_to_numpy(jp), ModelConfig(**tiny_kw()),
                           "cpu").param_dict()
    for l, lp in enumerate(pd["layers"]):
        for name, t in lp.items():
            ref = np.asarray(jp["layers"][name][l])
            assert t.dtype == torch.float32, name
            np.testing.assert_array_equal(to_np(t), ref, err_msg=name)
    for name in ("embed", "final_norm_w", "lm_head"):
        assert pd[name].dtype == torch.float32
        np.testing.assert_array_equal(to_np(pd[name]),
                                      np.asarray(jp[name]), err_msg=name)
