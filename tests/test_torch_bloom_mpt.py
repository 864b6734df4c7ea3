"""Bloom and MPT end to end on the CPU: tiny HF models (built locally from
random configs, as ``tests/test_zoo_golden.py`` builds them, at head dim
128) converted by both packages at q4_j and run through both; and the
JAX Scheduler and the port's on the same tiny Bloom weights in paged mode.

What the two families run that Llama bypasses: ALiBi in every attention
call (no RoPE), LayerNorms (Bloom's with biases, MPT's without), Bloom's
embedding LayerNorm, biases on every Bloom projection, the non-gated MLP
with tanh (Bloom) or exact (MPT) GELU, the fused QKV split (Bloom's
per-head interleave, MPT's straight concatenation) and tied embeddings.

Tolerances, as ``test_torch_model.py`` states them for the Llama twin:
logits within 3e-2·max|ref| (bf16 activations rounded at other places in
the two packages), greedy ids equal up to the first step where JAX's
penalized top-2 margin falls below that tolerance. Params are compared
leaf for leaf, exactly. The Scheduler twin keeps ``test_torch_serving.py``'s
thresholds: equal decisions at every step, equal ids for >= 10 of 12.
"""
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402

from neural_tpu.api import Model as JModel  # noqa: E402
from neural_tpu.convert import init_random as jinit_random  # noqa: E402
from neural_tpu.models.config import ModelConfig as JMC  # noqa: E402
from neural_tpu.runtime.generate import (  # noqa: E402
    model_step as jmodel_step, params_to_native as jparams_to_native)
from neural_tpu.runtime.kvcache import init_cache as jinit_cache  # noqa: E402
from neural_tpu.runtime.sampling import SamplingParams as JSP  # noqa: E402
from neural_tpu.serving import Scheduler as JScheduler  # noqa: E402

from neural_tpu_torch.api import Model  # noqa: E402
from neural_tpu_torch.convert.from_jax import params_from_numpy  # noqa: E402
from neural_tpu_torch.convert.hf import from_hf_model  # noqa: E402
from neural_tpu_torch.models.config import ModelConfig  # noqa: E402
from neural_tpu_torch.ops.rope import alibi_slopes  # noqa: E402
from neural_tpu_torch.runtime.generate import model_step  # noqa: E402
from neural_tpu_torch.runtime.kvcache import init_cache  # noqa: E402
from neural_tpu_torch.runtime.sampling import SamplingParams  # noqa: E402
from neural_tpu_torch.serving import Scheduler  # noqa: E402
from test_torch_bridge import jax_tree_to_numpy  # noqa: E402
from test_torch_kv8 import _jax_margins_i8  # noqa: E402
from test_torch_model import _jax_margins  # noqa: E402
from test_torch_serving import _prompts, _trace  # noqa: E402

VOCAB = 256
REL_TOL = 3e-2
T_PROMPT = 20


def _hf(kind):
    t = transformers
    torch.manual_seed(0)
    if kind == "bloom":
        return t.BloomForCausalLM(t.BloomConfig(
            vocab_size=VOCAB, hidden_size=256, n_layer=2, n_head=2)).eval()
    return t.MptForCausalLM(t.MptConfig(
        vocab_size=VOCAB, d_model=256, n_layers=2, n_heads=2,
        max_seq_len=256, attn_config={"alibi": True})).eval()


@pytest.fixture(scope="module", params=["bloom", "mpt"])
def pair(request):
    """(kind, JAX Model, port Model on the bridged tree, port decoder
    from ``from_hf_model``)."""
    hf = _hf(request.param)
    jm = JModel().init_from_hf_model(hf, "q4_j")
    jm.params = jparams_to_native(jm.params, force=True, min_elems=0)
    port, cfg = from_hf_model(hf, "q4_j", device="cpu")
    bridged = params_from_numpy(jax_tree_to_numpy(jm.params), cfg, "cpu")
    return request.param, jm, Model().init_params(bridged, cfg), port


def test_from_hf_model_equals_bridged_params(pair):
    kind, jm, pm, port = pair
    a, b = port.state_dict(), pm.params.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k
    cfg = port.cfg
    assert cfg == pm.cfg and cfg.arch == jm.cfg.arch == kind
    assert cfg.use_alibi and cfg.rope_style == "none"
    assert "rope_inv_freqs" not in a and port.lm_head is None
    assert torch.equal(a["alibi_slopes"], torch.from_numpy(alibi_slopes(2)))
    has_bias = kind == "bloom"
    assert ("layers.0.bq" in a) == has_bias
    assert ("layers.0.attn_norm_b" in a) == has_bias
    assert ("embed_norm_w" in a) == has_bias
    assert "layers.0.w_gate" not in "".join(a)


def _close(out, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(out, np.float32), ref, rtol=0,
                               atol=REL_TOL * np.abs(ref).max())


def _prompt():
    return np.random.default_rng(1).integers(3, VOCAB, T_PROMPT).tolist()


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_forward_logits(pair, kv):
    """Every row of a 20-token prompt, then 5 decode steps fed the same
    tokens, over bf16 and int8 caches."""
    _, jm, pm, _ = pair
    ids, S = _prompt(), T_PROMPT + 8
    jc = jinit_cache(jm.cfg, 1, S, "int8" if kv == "int8" else jnp.bfloat16)
    pc = init_cache(pm.cfg, 1, S, torch.int8 if kv == "int8"
                    else torch.bfloat16, device="cpu")
    jl, jc = jmodel_step(jm.params, jnp.asarray([ids], jnp.int32),
                         jnp.zeros((1,), jnp.int32), jc, jm.cfg)
    pl = model_step(pm.params, torch.tensor([ids]),
                    torch.zeros(1, dtype=torch.long), pc)
    assert pl.shape == (1, T_PROMPT, VOCAB)
    _close(pl.numpy(), jl)
    tok = int(np.argmax(np.asarray(jl)[0, -1]))
    for s in range(5):
        jl, jc = jmodel_step(jm.params, jnp.asarray([[tok]], jnp.int32),
                             jnp.asarray([T_PROMPT + s], jnp.int32), jc,
                             jm.cfg)
        pl = model_step(pm.params, torch.tensor([[tok]]),
                        torch.tensor([T_PROMPT + s]), pc)
        _close(pl.numpy(), jl)
        tok = int(np.argmax(np.asarray(jl)[0, -1]))


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_generate_greedy_ids_match_jax(pair, kv):
    _, jm, pm, _ = pair
    ids, n_new = _prompt(), 8
    jout = jm.generate(ids, max_new_tokens=n_new, do_sample=False,
                       stop_at_eos=False, kv_dtype=kv)[0]
    pout = pm.generate(ids, max_new_tokens=n_new, do_sample=False,
                       stop_at_eos=False, kv_dtype=kv)[0]
    assert pout[:T_PROMPT] == ids and len(pout) == T_PROMPT + n_new
    jnew, pnew = jout[T_PROMPT:], pout[T_PROMPT:]
    margins = (_jax_margins_i8 if kv == "int8" else _jax_margins)(
        jm, ids, jnew)
    safe = next((i for i, (m, scale) in enumerate(margins)
                 if m < REL_TOL * scale), len(margins))
    assert safe >= 2, margins
    assert pnew[:safe] == jnew[:safe], (pnew, jnew, margins)


BLOOM_KW = dict(arch="bloom", vocab_size=128, hidden_size=64, n_layers=2,
                n_heads=4, n_kv_heads=4, head_dim=16, intermediate_size=256,
                norm_type="layernorm", act="gelu_tanh", mlp_gated=False,
                mlp_bias=True, qkv_bias=True, o_bias=True, rope_style="none",
                use_alibi=True, tie_word_embeddings=True, max_seq_len=256,
                eos_token_id=999)


@pytest.fixture(scope="module")
def bloom_both():
    jcfg, cfg = JMC(**BLOOM_KW), ModelConfig(**BLOOM_KW)
    jp = jparams_to_native(jinit_random(jcfg, quant="q4_j"), force=True,
                           min_elems=0)
    return jp, jcfg, params_from_numpy(jax_tree_to_numpy(jp), cfg, "cpu"), \
        cfg


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_port_scheduler_matches_jax_scheduler_bloom(bloom_both, kv_dtype):
    """The twin of ``test_torch_serving.py``'s test in paged mode on a tiny
    Bloom: the same 12 requests (prompts of 3-40 tokens, 6 new each), 4
    slots, chunked prefill (chunk 16, buckets 8/16/32), an undersized page
    pool; ALiBi in every prefill chunk (K3 over the gathered pages) and
    decode step (K6)."""
    jp, jcfg, params, cfg = bloom_both
    prompts = _prompts(7, 12, 3, 40)
    kw = dict(max_batch=4, max_len=64, prefill_buckets=(8, 16, 32),
              prefill_chunk=16, kv_mode="paged", page_size=16, n_pages=10)
    jsched = JScheduler(jp, jcfg, sampling=JSP(greedy=True),
                        kv_dtype="int8" if kv_dtype == "int8"
                        else jnp.bfloat16, **kw)
    sched = Scheduler(params, cfg, sampling=SamplingParams(greedy=True),
                      kv_dtype=torch.int8 if kv_dtype == "int8"
                      else torch.bfloat16, **kw)
    for s in (jsched, sched):
        for i, p in enumerate(prompts):
            s.add_request(f"q{i}", p, max_new_tokens=6)
    jtrace, jdone = _trace(jsched, True)
    trace, done = _trace(sched, True)
    assert trace == jtrace
    exact = sum(done[f"q{i}"] == jdone[f"q{i}"] for i in range(12))
    assert exact >= 10, [(i, done[f"q{i}"], jdone[f"q{i}"])
                         for i in range(12) if done[f"q{i}"] != jdone[f"q{i}"]]
