"""The graph features of the zoo slice that no imported family reaches on
its own, what the port refuses, and the Scheduler on the zoo's graphs.

- qk-norm (an RMS norm over each head's Dh before RoPE): a random tiny
  Llama config with ``qk_norm=True`` and random q/k norm weights, the JAX
  ``model_step`` against the port's on the same params (bridged), within
  3e-2·max|ref| (``test_torch_bloom_mpt.py``'s tolerance).
- Refusals: ``qwen3`` (the reference's fault: the JAX import of a tiny
  Qwen3 raises ``KeyError``) and ``qwen2_moe`` (the reference's gap), each
  naming why, where Mixtral and Grok now resolve and build (the MoE slice);
  a Falcon-7B-wide weight (K = 4544) at group 128, as the
  JAX ``quantize`` asserts; a cache longer than a learned position table.
- ``init_random`` draws the new leaves (the lm_head bias, the position
  table, the qk-norm weights) and keeps GPT-J's one shared norm.
- Learned positions where each row starts elsewhere: OPT's right-padded
  ragged prefill (``_prefill_ragged``) against the JAX package's, each
  row's last logits within 3e-2·max|ref|.
- The Scheduler twins: GPT-J (parallel residual, one shared norm, partial
  GPT-J RoPE, the lm_head bias; head dim 256; bf16 weights) with bf16 KV
  and OPT (learned positions at offset 2, ReLU; head dim 128; q4_j) with
  int8 KV, in paged mode, the JAX Scheduler and the port's on the same weights, with
  ``test_torch_serving.py``'s thresholds: equal decisions at every step,
  equal ids for >= 10 of 12 requests; and the port's OPT Scheduler in
  slots mode against its paged mode on the same requests, equal ids for
  >= 10 of 12.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from neural_tpu.convert import from_hf_model as jfrom_hf_model  # noqa: E402
from neural_tpu.convert import init_random as jinit_random  # noqa: E402
from neural_tpu.core.dtypes import PRESETS as JPRESETS  # noqa: E402
from neural_tpu.core.qtensor import quantize as jquantize  # noqa: E402
from neural_tpu.models.config import ModelConfig as JMC  # noqa: E402
from neural_tpu.runtime.generate import (  # noqa: E402
    model_step as jmodel_step, params_to_native as jparams_to_native)
from neural_tpu.runtime.kvcache import init_cache as jinit_cache  # noqa: E402
from neural_tpu.runtime.sampling import SamplingParams as JSP  # noqa: E402
from neural_tpu.serving import Scheduler as JScheduler  # noqa: E402

from neural_tpu_torch.convert.from_jax import params_from_numpy  # noqa: E402
from neural_tpu_torch.convert.hf import (REFUSED, family,  # noqa: E402
                                         from_hf_model, init_random)
from neural_tpu_torch.core.dtypes import PRESETS  # noqa: E402
from neural_tpu_torch.core.qtensor import quantize  # noqa: E402
from neural_tpu_torch.models.config import ModelConfig  # noqa: E402
from neural_tpu_torch.models.transformer import Transformer  # noqa: E402
from neural_tpu_torch.runtime.generate import model_step  # noqa: E402
from neural_tpu_torch.runtime.kvcache import init_cache  # noqa: E402
from neural_tpu_torch.runtime.paged import init_paged_cache  # noqa: E402
from neural_tpu_torch.runtime.sampling import SamplingParams  # noqa: E402
from neural_tpu_torch.serving import Scheduler  # noqa: E402
from test_torch_bridge import jax_tree_to_numpy  # noqa: E402
from test_torch_serving import _prompts, _trace  # noqa: E402

REL_TOL = 3e-2

QK_KW = dict(arch="llama", vocab_size=128, hidden_size=256, n_layers=2,
             n_heads=2, n_kv_heads=1, head_dim=128, intermediate_size=512,
             qk_norm=True, max_seq_len=64, eos_token_id=999)


def _close(out, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(out, np.float32), ref, rtol=0,
                               atol=REL_TOL * np.abs(ref).max())


def test_qk_norm_against_jax_forward():
    jcfg, cfg = JMC(**QK_KW), ModelConfig(**QK_KW)
    jp = jinit_random(jcfg, seed=3)
    rng = np.random.default_rng(4)
    for n in ("q_norm_w", "k_norm_w"):
        w = 1.0 + 0.5 * rng.standard_normal((cfg.n_layers, cfg.head_dim))
        jp["layers"][n] = jnp.asarray(w, jnp.bfloat16)
    port = params_from_numpy(jax_tree_to_numpy(jp), cfg, "cpu")
    assert port.layers[0].q_norm_w.shape == (cfg.head_dim,)
    ids = rng.integers(3, 128, 10).tolist()
    jc = jinit_cache(jcfg, 1, 16)
    pc = init_cache(cfg, 1, 16, device="cpu")
    jl, jc = jmodel_step(jp, jnp.asarray([ids], jnp.int32),
                         jnp.zeros((1,), jnp.int32), jc, jcfg)
    pl = model_step(port, torch.tensor([ids]), torch.zeros(1, dtype=torch.long),
                    pc)
    _close(pl.numpy(), jl)
    for s in range(3):
        tok = int(np.argmax(np.asarray(jl)[0, -1]))
        jl, jc = jmodel_step(jp, jnp.asarray([[tok]], jnp.int32),
                             jnp.asarray([10 + s], jnp.int32), jc, jcfg)
        pl = model_step(port, torch.tensor([[tok]]), torch.tensor([10 + s]),
                        pc)
        _close(pl.numpy(), jl)
    # the norm acts: unit weights give other logits
    flat = dataclasses.replace(cfg, qk_norm=False)
    plain = params_from_numpy(jax_tree_to_numpy(
        {**jp, "layers": {k: v for k, v in jp["layers"].items()
                          if k not in ("q_norm_w", "k_norm_w")}}), flat, "cpu")
    other = model_step(plain, torch.tensor([ids]),
                       torch.zeros(1, dtype=torch.long),
                       init_cache(flat, 1, 16, device="cpu"))
    assert not torch.allclose(other[0, -1], model_step(
        port, torch.tensor([ids]), torch.zeros(1, dtype=torch.long),
        init_cache(cfg, 1, 16, device="cpu"))[0, -1])


def _qwen3():
    t = transformers
    torch.manual_seed(0)
    return t.Qwen3ForCausalLM(t.Qwen3Config(
        vocab_size=128, hidden_size=64, num_hidden_layers=1,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        intermediate_size=128, max_position_embeddings=64)).eval()


def test_qwen3_raises_naming_the_reference_fault():
    hf = _qwen3()
    with pytest.raises(KeyError, match="q_proj.bias"):
        jfrom_hf_model(hf, quant=None)
    with pytest.raises(NotImplementedError, match="qkv_bias=True"):
        from_hf_model(hf, None, device="cpu")
    with pytest.raises(NotImplementedError, match="qwen3"):
        family("qwen3").config_from_hf(hf.config)


@pytest.mark.parametrize("model_type", ["mixtral", "grok", "grok-1",
                                        "qwen2_moe"])
def test_moe_types_raise_naming_the_moe_slice(model_type):
    """Since the MoE slice Mixtral and Grok-1 resolve to their families;
    Qwen2-MoE raises naming the reference's gap (the JAX package does not
    run it either)."""
    if model_type == "qwen2_moe":
        assert model_type in REFUSED
        with pytest.raises(NotImplementedError, match="shared-expert"):
            family(model_type)
        return
    assert model_type not in REFUSED
    assert family(model_type).__name__.rsplit(".", 1)[1] == \
        ("llama" if model_type == "mixtral" else "grok")


def test_moe_config_raises_in_the_graph():
    """Since the MoE slice the graph takes a MoE config: ``init_random``
    builds its router and expert stacks, and a forward gives finite
    logits (``test_torch_moe.py`` holds them against the JAX package)."""
    cfg = ModelConfig(**{**QK_KW, "qk_norm": False, "arch": "mixtral",
                         "n_experts": 4, "n_experts_active": 2})
    model = init_random(cfg, quant=None, device="cpu")
    assert isinstance(model, Transformer)
    assert model.layers[0].router.weight.shape == (cfg.hidden_size, 4)
    out = model_step(model, torch.tensor([[3, 4, 5]]),
                     torch.zeros(1, dtype=torch.long),
                     init_cache(cfg, 1, 8, device="cpu"))
    assert torch.isfinite(out).all()


def test_falcon7b_width_at_group_128_raises_as_jax_asserts():
    """Falcon-7B's D = 4544 is 35.5 groups of 128: neither package quantizes
    it at q4_j; q4_0 (group 32) takes it."""
    w = np.random.default_rng(0).standard_normal((4544, 256)) \
        .astype(np.float32) * 0.02
    with pytest.raises(AssertionError, match="K=4544 not divisible by "
                                             "group_size=128"):
        jquantize(jnp.asarray(w), JPRESETS["q4_j"])
    with pytest.raises(ValueError, match="K=4544 not divisible by "
                                         "group_size=128"):
        quantize(torch.from_numpy(w), PRESETS["q4_j"])
    qt = quantize(torch.from_numpy(w), PRESETS["q4_0"])
    assert qt.scales.shape == (4544 // 32, 256)


OPT_KW = dict(arch="opt", vocab_size=128, hidden_size=256, n_layers=2,
              n_heads=2, n_kv_heads=2, head_dim=128, intermediate_size=512,
              norm_type="layernorm", act="relu", mlp_gated=False,
              mlp_bias=True, qkv_bias=True, o_bias=True, rope_style="none",
              learned_pos_emb=True, pos_offset=2, tie_word_embeddings=True,
              max_seq_len=64, eos_token_id=999)
GPTJ_KW = dict(arch="gptj", vocab_size=128, hidden_size=256, n_layers=2,
               n_heads=1, n_kv_heads=1, head_dim=256, intermediate_size=512,
               norm_type="layernorm", act="gelu_tanh", mlp_gated=False,
               mlp_bias=True, rope_style="gptj", rope_dim=64,
               parallel_residual=True, max_seq_len=64, eos_token_id=999)


def test_learned_positions_bound_the_cache():
    cfg = ModelConfig(**OPT_KW)
    model = init_random(cfg, quant=None, device="cpu")
    assert model.pos_embed.shape == (64 + 2, 256)
    tok, start = torch.tensor([[5]]), torch.zeros(1, dtype=torch.long)
    model(tok, start, init_cache(cfg, 1, 64, device="cpu"))
    with pytest.raises(ValueError, match="learned position table"):
        model(tok, start, init_cache(cfg, 1, 65, device="cpu"))
    with pytest.raises(ValueError, match="learned position table"):
        model(tok, start, init_paged_cache(cfg, 1, 128, page_size=64,
                                           device="cpu"))


def test_init_random_draws_the_new_leaves():
    gptj = init_random(ModelConfig(**GPTJ_KW), quant="q4_j", device="cpu")
    assert gptj.lm_head_b.shape == (128,) and gptj.lm_head_b.abs().sum() > 0
    assert gptj.layers[0].ffn_norm_w is None and not gptj.fuse_head
    qk = init_random(ModelConfig(**QK_KW), quant=None, device="cpu")
    assert torch.equal(qk.layers[1].k_norm_w, torch.ones(128,
                                                         dtype=torch.bfloat16))
    # the leaves drawn before these came in are drawn as they were: a
    # config without them draws the same embedding and first projection
    base = init_random(ModelConfig(**{**QK_KW, "qk_norm": False}),
                       quant=None, device="cpu")
    assert torch.equal(base.embed, qk.embed)
    assert torch.equal(base.layers[0].wq.weight, qk.layers[0].wq.weight)
    for kw in (GPTJ_KW, OPT_KW):
        cfg = ModelConfig(**kw)
        out = model_step(init_random(cfg, quant="q4_j", device="cpu"),
                         torch.tensor([[3, 4, 5]]),
                         torch.zeros(1, dtype=torch.long),
                         init_cache(cfg, 1, 8, device="cpu"))
        assert torch.isfinite(out).all()


def _both_random(kw, quant=None):
    """JAX random weights (native-packed when quantized) and the same
    weights in the port: (jax params, jax cfg, port decoder, port cfg)."""
    jcfg, cfg = JMC(**kw), ModelConfig(**kw)
    jp = jparams_to_native(jinit_random(jcfg, quant=quant), force=True,
                           min_elems=0)
    return jp, jcfg, params_from_numpy(jax_tree_to_numpy(jp), cfg, "cpu"), \
        cfg


def test_learned_positions_ragged_prefill_matches_jax():
    from neural_tpu.runtime.generate import _prefill_ragged as jragged
    from neural_tpu_torch.runtime.generate import _prefill_ragged
    jp, jcfg, params, cfg = _both_random(OPT_KW)
    rows = _prompts(9, 3, 5, 30)
    T = max(map(len, rows))
    toks = np.zeros((3, T), np.int64)
    for b, r in enumerate(rows):
        toks[b, :len(r)] = r
    lens = np.array([len(r) for r in rows])
    jl, _ = jragged(jp, jnp.asarray(toks, jnp.int32),
                    jnp.asarray(lens, jnp.int32), jinit_cache(jcfg, 3, 48),
                    jcfg)
    pl = _prefill_ragged(params, torch.from_numpy(toks),
                         torch.from_numpy(lens), init_cache(cfg, 3, 48,
                                                            device="cpu"))
    _close(pl.numpy(), jl)


SCHED_OPTS = dict(max_batch=4, max_len=64, prefill_buckets=(8, 16, 32),
                  prefill_chunk=16)
PAGED = dict(kv_mode="paged", page_size=16, n_pages=10)


def test_learned_positions_slots_match_paged():
    """The port's OPT Scheduler in slots mode against its paged mode (whose
    undersized pool admits requests later, so the two schedules differ):
    each request's ids."""
    _, _, params, cfg = _both_random(OPT_KW)
    prompts = _prompts(7, 12, 3, 40)
    out = []
    for mode in (dict(kv_mode="slots"), PAGED):
        sched = Scheduler(params, cfg, sampling=SamplingParams(greedy=True),
                          kv_dtype=torch.bfloat16, **SCHED_OPTS, **mode)
        for i, p in enumerate(prompts):
            sched.add_request(f"q{i}", p, max_new_tokens=6)
        out.append(_trace(sched, False)[1])
    exact = sum(out[0][f"q{i}"] == out[1][f"q{i}"] for i in range(12))
    assert exact >= 10, out


@pytest.mark.parametrize("kw,kv_dtype", [(GPTJ_KW, "bf16"),
                                         (OPT_KW, "int8")],
                         ids=["gptj-bf16", "opt-int8"])
def test_port_scheduler_matches_jax_scheduler(kw, kv_dtype):
    """The twin of ``test_torch_serving.py``'s test in paged mode: the same
    12 requests (prompts of 3-40 tokens, 6 new each), 4 slots, chunked
    prefill (chunk 16, buckets 8/16/32), an undersized page pool; GPT-J's
    weights in bf16 (the JAX package's Pallas kernels in interpret mode
    cost most of its side's time here), OPT's at q4_j."""
    jp, jcfg, params, cfg = _both_random(kw, None if kw is GPTJ_KW
                                         else "q4_j")
    prompts = _prompts(7, 12, 3, 40)
    opts = dict(SCHED_OPTS, **PAGED)
    jsched = JScheduler(jp, jcfg, sampling=JSP(greedy=True),
                        kv_dtype="int8" if kv_dtype == "int8"
                        else jnp.bfloat16, **opts)
    sched = Scheduler(params, cfg, sampling=SamplingParams(greedy=True),
                      kv_dtype=torch.int8 if kv_dtype == "int8"
                      else torch.bfloat16, **opts)
    for s in (jsched, sched):
        for i, p in enumerate(prompts):
            s.add_request(f"q{i}", p, max_new_tokens=6)
    jtrace, jdone = _trace(jsched, True)
    trace, done = _trace(sched, True)
    assert trace == jtrace
    exact = sum(done[f"q{i}"] == jdone[f"q{i}"] for i in range(12))
    assert exact >= 10, [(i, done[f"q{i}"], jdone[f"q{i}"])
                         for i in range(12) if done[f"q{i}"] != jdone[f"q{i}"]]
    jax.clear_caches()
