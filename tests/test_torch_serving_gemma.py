"""The JAX Scheduler and the port's on the same tiny Gemma-2 weights: the
twin of ``test_torch_serving.py``'s ``test_port_scheduler_matches_jax_scheduler``
for a model whose even layers attend through a sliding window of 8 (prompts
of 3-40 tokens, so the window is active in prefill chunks and decode steps),
with the attention and final softcaps, head dim 256 and tied embeddings.

Same configuration, requests and threshold as the Llama twin: 4 slots,
chunked prefill (chunk 16, buckets 8/16/32), an undersized page pool;
equal admission, chunk and page-table decisions at every step, and equal
greedy ids for at least 10 of 12 requests (the two packages round bf16
activations at different places, ``test_torch_gemma.py``).
"""
import jax.numpy as jnp
import pytest
import torch

from neural_tpu.convert import init_random as jinit_random
from neural_tpu.models.config import ModelConfig as JMC
from neural_tpu.runtime.generate import params_to_native as jparams_to_native
from neural_tpu.runtime.sampling import SamplingParams as JSP
from neural_tpu.serving import Scheduler as JScheduler

from neural_tpu_torch.convert.from_jax import params_from_numpy
from neural_tpu_torch.models.config import ModelConfig
from neural_tpu_torch.runtime.sampling import SamplingParams
from neural_tpu_torch.serving import Scheduler
from test_torch_bridge import jax_tree_to_numpy
from test_torch_serving import _prompts, _trace

KW = dict(arch="gemma2", vocab_size=128, hidden_size=64, n_layers=2,
          n_heads=2, n_kv_heads=1, head_dim=256, intermediate_size=128,
          norm_eps=1e-6, norm_offset=1.0, act="gelu_tanh",
          post_attn_norm=True, post_ffn_norm=True, attn_softcap=50.0,
          logit_softcap=30.0, attn_scale=1 / 16, sliding_window=8,
          embed_scale=8.0, tie_word_embeddings=True, max_seq_len=256,
          eos_token_id=999)


@pytest.fixture(scope="module")
def both():
    jcfg, cfg = JMC(**KW), ModelConfig(**KW)
    jp = jparams_to_native(jinit_random(jcfg, quant="q4_j"), force=True,
                           min_elems=0)
    params = params_from_numpy(jax_tree_to_numpy(jp), cfg, "cpu")
    assert [blk.window for blk in params.layers] == [8, 0]
    return jp, jcfg, params, cfg


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_port_scheduler_matches_jax_scheduler_gemma2(both, kv_dtype):
    jp, jcfg, params, cfg = both
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
