"""ChatGLM-1 end to end on the CPU: a tiny model from the JAX package's
``init_random`` (the ``mk_cfg`` of ``tests/test_chatglm1.py`` at head dim
128), bridged into the port at q4_j and run through both packages.

What ChatGLM-1 runs that no other ported family does: the GLM prefix-LM
mask in every prefill (K3's prefix branch), the 2-D GLM RoPE anchored at
the prompt length on every decode step, DeepNorm residuals (alpha on the
normed branch input, a bf16 scalar), LayerNorms and projections with
biases, the non-gated tanh-GELU MLP and an untied lm_head.

Also the reference's fault in paged prefill: the JAX ``attend_paged`` takes
no prefix bound, so a JAX ``Scheduler(kv_mode="paged")`` prefills a
ChatGLM-1 prompt with a causal mask, where ``kv_mode="slots"`` and
``Model.generate`` use the prefix mask. The port's paged Scheduler passes
the mask on and matches the JAX slots Scheduler.

Tolerances, as ``test_torch_model.py`` states them: logits within
3e-2·max|ref| (bf16 activations rounded at other places in the two
packages); greedy ids equal up to the first step where JAX's top-2 margin
falls below that tolerance; Scheduler twins equal in their decisions at
every step and in their ids for >= 10 of 12 requests.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: E402

from neural_tpu.convert import init_random as jinit_random  # noqa: E402
from neural_tpu.runtime.generate import (  # noqa: E402
    decode_loop as jdecode_loop, greedy_generate as jgreedy_generate,
    model_step as jmodel_step, params_to_native as jparams_to_native)
from neural_tpu.runtime.kvcache import init_cache as jinit_cache  # noqa: E402
from neural_tpu.runtime.paged import init_paged_cache as jinit_paged  # noqa: E402
from neural_tpu.runtime.sampling import SamplingParams as JSP  # noqa: E402
from neural_tpu.serving import Scheduler as JScheduler  # noqa: E402

from neural_tpu_torch.api import Model  # noqa: E402
from neural_tpu_torch.convert.from_jax import params_from_numpy  # noqa: E402
from neural_tpu_torch.models.config import ModelConfig  # noqa: E402
from neural_tpu_torch.models.transformer import bf16_scalar  # noqa: E402
from neural_tpu_torch.runtime.generate import (  # noqa: E402
    decode_loop, greedy_generate, model_step, prefill_step)
from neural_tpu_torch.runtime.kvcache import init_cache  # noqa: E402
from neural_tpu_torch.runtime.paged import init_paged_cache  # noqa: E402
from neural_tpu_torch.runtime.sampling import SamplingParams  # noqa: E402
from neural_tpu_torch.serving import Scheduler  # noqa: E402
from test_chatglm1 import mk_cfg  # noqa: E402
from test_torch_bridge import jax_tree_to_numpy  # noqa: E402
from test_torch_serving import _prompts, _trace  # noqa: E402

REL_TOL = 3e-2
VOCAB = 128
T_PROMPT = 20


@pytest.fixture(scope="module")
def both():
    """(JAX params, JAX cfg, port decoder, port cfg)."""
    jcfg = dataclasses.replace(mk_cfg(L=2, D=256, H=2, V=VOCAB),
                               eos_token_id=999)   # never drawn
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jp = jparams_to_native(jinit_random(jcfg, seed=4, quant="q4_j"),
                           force=True, min_elems=0)
    return jp, jcfg, params_from_numpy(jax_tree_to_numpy(jp), cfg, "cpu"), \
        cfg


def _close(out, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(out, np.float32), ref, rtol=0,
                               atol=REL_TOL * np.abs(ref).max())


def _prompt(seed=0):
    return np.random.default_rng(seed).integers(3, VOCAB, T_PROMPT).tolist()


def test_bridged_model(both):
    """The bridge carries every bias, the untied lm_head and the GLM RoPE
    table (Dh/2 rotary dims: Dh/4 frequencies); the DeepNorm alpha is a
    bf16 scalar, so ChatGLM-6B's sqrt(56) = 7.4833 is 7.46875."""
    _, jcfg, params, cfg = both
    sd = params.state_dict()
    for name in ("bq", "bk", "bv", "bo", "b_up", "b_down", "attn_norm_b",
                 "ffn_norm_b"):
        assert f"layers.1.{name}" in sd, name
    assert "final_norm_b" in sd and params.lm_head is not None
    assert sd["rope_inv_freqs"].shape == (cfg.head_dim // 4,)
    assert params.alibi_slopes is None
    assert params.layers[0].alpha == 2.0          # sqrt(2 * 2), exact
    assert bf16_scalar(float(np.sqrt(56.0))) == 7.46875


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_forward_logits(both, kv):
    """Every row of a 20-token prompt (the whole prompt is the prefix),
    then 5 decode steps fed the same tokens with the prompt length, over
    bf16 and int8 caches. Without the prompt length a decode step anchors
    the 2-D RoPE elsewhere and its logits move."""
    jp, jcfg, params, cfg = both
    ids, S = _prompt(), T_PROMPT + 8
    jc = jinit_cache(jcfg, 1, S, "int8" if kv == "int8" else jnp.bfloat16)
    pc = init_cache(cfg, 1, S, torch.int8 if kv == "int8"
                    else torch.bfloat16, device="cpu")
    jplen, plen = jnp.asarray([T_PROMPT], jnp.int32), torch.tensor([T_PROMPT])
    jl, jc = jmodel_step(jp, jnp.asarray([ids], jnp.int32),
                      jnp.zeros((1,), jnp.int32), jc, jcfg, prompt_len=jplen)
    pl = model_step(params, torch.tensor([ids]),
                    torch.zeros(1, dtype=torch.long), pc, plen)
    _close(pl.numpy(), jl)
    tok = int(np.argmax(np.asarray(jl)[0, -1]))
    for s in range(5):
        jl, jc = jmodel_step(jp, jnp.asarray([[tok]], jnp.int32),
                          jnp.asarray([T_PROMPT + s], jnp.int32), jc, jcfg,
                          prompt_len=jplen)
        pl = model_step(params, torch.tensor([[tok]]),
                        torch.tensor([T_PROMPT + s]), pc, plen)
        _close(pl.numpy(), jl)
        if s == 1:
            pc2 = init_cache(cfg, 1, S, pc.k.dtype, device="cpu")
            for f in ("k", "v", "k_scale", "v_scale"):
                if getattr(pc, f) is not None:
                    getattr(pc2, f).copy_(getattr(pc, f))
            wrong = model_step(params, torch.tensor([[tok]]),
                               torch.tensor([T_PROMPT + s]), pc2)
            # the same arithmetic on both sides: only the anchor differs
            assert (wrong - pl).abs().max() > 1e-3 * pl.abs().max()
        tok = int(np.argmax(np.asarray(jl)[0, -1]))


def _margins(jp, jcfg, ids, new):
    """JAX's top-1/top-2 margin at each greedy step (no penalties), the
    prompt length on every decode step."""
    jc = jinit_cache(jcfg, 1, len(ids) + len(new))
    plen = jnp.asarray([len(ids)], jnp.int32)
    logits, jc = jmodel_step(jp, jnp.asarray([ids], jnp.int32),
                          jnp.zeros((1,), jnp.int32), jc, jcfg,
                          prompt_len=plen)
    out = []
    for i, tok in enumerate(new):
        row = np.sort(np.asarray(logits[0, -1], np.float32))
        out.append((row[-1] - row[-2], np.abs(row).max()))
        logits, jc = jmodel_step(jp, jnp.asarray([[tok]], jnp.int32),
                              jnp.asarray([len(ids) + i], jnp.int32), jc,
                              jcfg, prompt_len=plen)
    return out


def test_greedy_generate_and_decode_loop_match_jax(both):
    """``greedy_generate`` and ``decode_loop`` (the prompt length on every
    step) against the JAX package's, up to JAX's first step with a margin
    below the tolerance; ``Model.generate`` gives ``greedy_generate``'s ids
    where the repetition penalty is off."""
    jp, jcfg, params, cfg = both
    ids, n_new = _prompt(4), 8
    jids = jgreedy_generate(jp, jcfg, ids, max_new_tokens=n_new, max_len=40,
                            stop_at_eos=False)[T_PROMPT:]
    margins = _margins(jp, jcfg, ids, jids)
    safe = next((i for i, (m, scale) in enumerate(margins)
                 if m < REL_TOL * scale), len(margins))
    assert safe >= 3, margins
    ours = greedy_generate(params, cfg, ids, max_new_tokens=n_new,
                           max_len=40, stop_at_eos=False)[T_PROMPT:]
    assert ours[:safe] == jids[:safe], (ours, jids, margins)
    assert Model().init_params(params, cfg).generate(
        ids, max_new_tokens=n_new, stop_at_eos=False, repetition_penalty=1.0,
        max_len=40)[0][T_PROMPT:] == ours

    plen = torch.tensor([T_PROMPT])
    cache = init_cache(cfg, 1, 40, device="cpu")
    first = prefill_step(params, torch.tensor([ids]),
                         torch.zeros(1, dtype=torch.long), cache)
    tok0 = torch.argmax(first[:, -1], dim=-1)[:, None]
    toks = decode_loop(params, tok0, torch.tensor([T_PROMPT]), cache,
                       n_new - 1, prompt_len=plen)
    jc = jinit_cache(jcfg, 1, 40)
    jl, jc = jmodel_step(jp, jnp.asarray([ids], jnp.int32),
                      jnp.zeros((1,), jnp.int32), jc, jcfg)
    jtoks, _ = jdecode_loop(jp, jnp.argmax(jl[:, -1], -1).astype(
        jnp.int32)[:, None], jnp.asarray([T_PROMPT], jnp.int32), jc, jcfg,
        n_new - 1, prompt_len=jnp.asarray([T_PROMPT], jnp.int32))
    got = [int(tok0)] + toks[:, 0].tolist()
    want = [jids[0]] + np.asarray(jtoks)[:, 0].tolist()
    assert got[:safe] == want[:safe], (got, want, margins)


def test_prefix_mask_bidirectional(both):
    """Changing a later prompt token changes an earlier row's logits (the
    prefix is bidirectional), in both packages, by about as much."""
    jp, jcfg, params, cfg = both
    t1 = _prompt(3)
    t2 = list(t1)
    t2[12] = (t2[12] + 7) % VOCAB
    rows = []
    for toks in (t1, t2):
        jl, _ = jmodel_step(jp, jnp.asarray([toks], jnp.int32),
                         jnp.zeros((1,), jnp.int32),
                         jinit_cache(jcfg, 1, 32), jcfg)
        pl = model_step(params, torch.tensor([toks]),
                        torch.zeros(1, dtype=torch.long),
                        init_cache(cfg, 1, 32, device="cpu"))
        rows.append((np.asarray(jl[0, 3], np.float32), pl[0, 3].numpy()))
    jd = np.abs(rows[0][0] - rows[1][0]).max()
    pd = np.abs(rows[0][1] - rows[1][1]).max()
    scale = np.abs(rows[0][0]).max()
    # a causal model's row 3 would not move at all
    assert jd > 1e-3 * scale and pd > 1e-3 * scale
    _close(rows[0][1], rows[0][0])
    _close(rows[1][1], rows[1][0])


def _twin(params, cfg, kv_mode, kv_dtype, prompts):
    kw = dict(max_batch=4, max_len=64, prefill_buckets=(8, 16, 32, 64),
              kv_mode=kv_mode, page_size=16)
    sched = Scheduler(params, cfg, sampling=SamplingParams(greedy=True),
                      kv_dtype=kv_dtype, **kw)
    for i, p in enumerate(prompts):
        sched.add_request(f"q{i}", p, max_new_tokens=6)
    return sched


def _jtwin(jp, jcfg, kv_mode, prompts):
    jsched = JScheduler(jp, jcfg, sampling=JSP(greedy=True), max_batch=4,
                        max_len=64, prefill_buckets=(8, 16, 32, 64),
                        kv_mode=kv_mode, page_size=16)
    for i, p in enumerate(prompts):
        jsched.add_request(f"q{i}", p, max_new_tokens=6)
    return jsched


def test_port_scheduler_matches_jax_scheduler_slots(both):
    """Slots mode, bf16 KV: 12 requests (prompts of 3-40 tokens, 6 new
    each), 4 slots, single-shot prefill (a prefix-LM model never chunks),
    per-slot prompt lengths on every decode step: equal decisions at every
    step, equal ids for >= 10 of 12."""
    jp, jcfg, params, cfg = both
    prompts = _prompts(7, 12, 3, 40)
    jtrace, jdone = _trace(_jtwin(jp, jcfg, "slots", prompts), False)
    sched = _twin(params, cfg, "slots", torch.bfloat16, prompts)
    assert sched.prefill_chunk is None
    trace, done = _trace(sched, False)
    assert trace == jtrace
    exact = sum(done[f"q{i}"] == jdone[f"q{i}"] for i in range(12))
    assert exact >= 10, [(i, done[f"q{i}"], jdone[f"q{i}"])
                         for i in range(12) if done[f"q{i}"] != jdone[f"q{i}"]]


def test_reference_paged_prefill_drops_the_prefix_mask(both):
    """The JAX package's fault, and the port's fix. JAX ``model_step`` over
    a paged cache computes another prefill than over a contiguous cache
    with the same prompt length: its ``attend_paged`` takes no prefix
    bound, so the rows before the prompt's end attend causally. Over the
    20-token prompt the logits move by more than 2e-2·max|logit| (measured
    2.5e-2-3.9e-2 over five prompts), four times the port's distance to
    JAX's contiguous prefill (1e-2; measured 6e-3-7.6e-3, bf16 roundings);
    the port's paged prefill equals its contiguous one exactly. The port's
    paged Scheduler (bf16 and int8 KV) then matches the JAX slots
    Scheduler: equal ids for >= 10 of 12 requests."""
    jp, jcfg, params, cfg = both
    ids = _prompt(4)
    plen = jnp.asarray([T_PROMPT], jnp.int32)
    jslots, _ = jmodel_step(jp, jnp.asarray([ids], jnp.int32),
                            jnp.zeros((1,), jnp.int32),
                            jinit_cache(jcfg, 1, 32), jcfg, prompt_len=plen)
    jpc = jinit_paged(jcfg, 1, 32, page_size=16)._replace(
        table=jnp.asarray([[0, 1]], jnp.int32))
    jpaged, _ = jmodel_step(jp, jnp.asarray([ids], jnp.int32),
                            jnp.zeros((1,), jnp.int32), jpc, jcfg,
                            prompt_len=plen)
    jslots, jpaged = (np.asarray(x[0], np.float32) for x in (jslots, jpaged))
    scale = np.abs(jslots).max()
    assert np.abs(jpaged - jslots).max() > 2e-2 * scale
    pc = init_paged_cache(cfg, 1, 32, page_size=16, device="cpu")
    pc.table.copy_(torch.tensor([[0, 1]], dtype=torch.int32))
    start = torch.zeros(1, dtype=torch.long)
    ours = model_step(params, torch.tensor([ids]), start, pc)
    assert torch.equal(ours, model_step(params, torch.tensor([ids]), start,
                                        init_cache(cfg, 1, 32, device="cpu")))
    assert np.abs(ours[0].numpy() - jslots).max() <= 1e-2 * scale

    prompts = _prompts(8, 12, 3, 40)
    _, jslots_done = _trace(_jtwin(jp, jcfg, "slots", prompts), False)
    for kv_dtype in (torch.bfloat16, torch.int8):
        _, done = _trace(_twin(params, cfg, "paged", kv_dtype, prompts),
                         True)
        exact = sum(done[f"q{i}"] == jslots_done[f"q{i}"] for i in range(12))
        assert exact >= 10, (kv_dtype, exact)
