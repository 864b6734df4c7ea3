"""StreamingLLM slots and decode blocks in the port's Scheduler and
ModelServer on the CPU: twins of the streaming and decode-block cases of
``tests/test_serving.py``, on the tiny q4_j Llama that
``tests/test_torch_serving.py`` bridges from the JAX package.

A streaming slot is held to the port's ``stream_generate`` on the same
prompt (equal ids, through two shifts of a 32-position row, bf16 and int8
KV); decode blocks to single steps (equal ids, an EOS inside a block
included, slots and paged). Against the JAX Scheduler on the same weights a
streaming request's ids are compared as ``tests/test_torch_streaming.py``
compares ``stream_generate``: both packages teacher-forced on JAX's ids
through the same shifts, each step's logits within REL_TOL·max|logit|, and
the ids parting only at a step whose JAX top-2 margin does not exceed
twice that step's largest logit difference.
"""
import dataclasses
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_tpu.runtime.generate import model_step as jmodel_step
from neural_tpu.runtime.kvcache import init_cache as jinit_cache
from neural_tpu.runtime.sampling import SamplingParams as JSP
from neural_tpu.runtime.streaming import shift_cache as jshift_cache
from neural_tpu.serving import Scheduler as JScheduler

from neural_tpu_torch.runtime.generate import model_step
from neural_tpu_torch.runtime.kvcache import init_cache
from neural_tpu_torch.runtime.sampling import SamplingParams
from neural_tpu_torch.runtime.streaming import shift_cache, stream_generate
from neural_tpu_torch.serving import ModelServer, Query, Scheduler
from test_torch_serving import GREEDY, bridged

MAX_LEN, N_KEEP, N_DISCARD = 32, 2, 8
PROMPTS = [[3, 14, 15, 9], [7, 8], [21, 22, 23], [40, 41, 42, 43, 44]]
N_NEW = 48                        # overflows a 32-position row twice
REL_TOL = 3e-2                    # tests/test_torch_streaming.py's
KV = {"bf16": torch.bfloat16, "int8": torch.int8}


@pytest.fixture(scope="module")
def both():
    return bridged()


@pytest.fixture(scope="module")
def model(both):
    return both[2], both[3]


def _streaming(params, cfg, kv, **kw):
    sched = Scheduler(params, cfg, max_batch=2, max_len=MAX_LEN,
                      prefill_buckets=(8, 16, 32), streaming=True,
                      n_keep=N_KEEP, n_discard=N_DISCARD, sampling=GREEDY,
                      kv_dtype=KV[kv], **kw)
    for i, p in enumerate(PROMPTS):
        sched.add_request(f"q{i}", p, max_new_tokens=N_NEW)
    return {s.request_id: s.output_ids for s in sched.run_to_completion()}


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_scheduler_streaming_matches_stream_generate(model, kv):
    """Per-slot sink+shift equals the single-sequence stream_generate,
    through two shifts of every slot."""
    params, cfg = model
    done = _streaming(params, cfg, kv)
    for i, p in enumerate(PROMPTS):
        ref = stream_generate(params, cfg, p, N_NEW, MAX_LEN, n_keep=N_KEEP,
                              n_discard=N_DISCARD, kv_dtype=KV[kv])[len(p):]
        assert done[f"q{i}"] == ref, (i, done[f"q{i}"], ref)


def test_server_streaming_kwargs(model):
    """shift_roped_k/n_keep/n_discard reach the scheduler (a negative
    n_keep keeps 4 sinks, a negative n_discard takes the default), and a
    query runs past ctx_size."""
    params, cfg = model
    srv = ModelServer(params, cfg, max_batch=2, ctx_size=32,
                      shift_roped_k=True, n_keep=2, n_discard=8,
                      prefill_chunk=None)
    try:
        assert srv.scheduler.streaming
        assert srv.scheduler.n_keep == 2 and srv.scheduler.n_discard == 8
        srv.issueQuery(Query("a", [3, 4, 5], max_new_tokens=40))
        t0 = time.time()
        while not srv.Empty() and time.time() - t0 < 120:
            time.sleep(0.02)
        with srv._lock:
            done = list(srv.finished)
        assert len(done) == 1 and len(done[0].output_ids) == 40
    finally:
        srv.stop()
    with ModelServer(params, cfg, max_batch=2, ctx_size=32,
                     shift_roped_k=True, n_keep=-1, n_discard=-1) as srv:
        assert srv.scheduler.n_keep == 4
        assert srv.scheduler.n_discard == (32 - 4) // 2


def _block_run(params, cfg, prompts, block, n_new, sp=GREEDY, **kw):
    sched = Scheduler(params, cfg, max_batch=3, max_len=64,
                      prefill_buckets=(32,), decode_block=block, sampling=sp,
                      **kw)
    for i, p in enumerate(prompts):
        sched.add_request(f"q{i}", p, max_new_tokens=n_new)
    return {s.request_id: s.output_ids for s in sched.run_to_completion()}


def _ragged(seed, n):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, 128, int(k))))
            for k in rng.integers(3, 20, n)]


def _eos_inside_a_block(params, cfg, prompts, n_new, k):
    """A config whose stop id is a token the first request emits (with no
    stop id) inside a k-block, past the block's first step, and not
    before: its tokens after it in that block are discarded."""
    out = _block_run(params, cfg, prompts, 1, n_new)["q0"]
    # output 0 comes from the prefill; blocks then cover 1..k, k+1..2k, ...
    i = next(i for i in range(2, n_new)
             if (i - 1) % k and out[i] not in out[:i])
    return dataclasses.replace(cfg, eos_token_id=out[i]), i


def test_decode_block_matches_single_step(model):
    """decode_block=4 gives the single-step greedy ids exactly, an EOS
    inside a block and ragged finish times included."""
    params, cfg = model
    prompts = _ragged(11, 6)
    cfg_eos, i = _eos_inside_a_block(params, cfg, prompts, 11, 4)
    one = _block_run(params, cfg_eos, prompts, 1, 11)
    four = _block_run(params, cfg_eos, prompts, 4, 11)
    assert one == four, (one, four)
    assert len(one["q0"]) == i + 1      # the EOS stopped it inside a block


def test_decode_block_with_penalties(model):
    """The block's on-device penalty ring equals the host-side history of
    single steps (greedy with a repetition penalty)."""
    params, cfg = model
    sp = SamplingParams(greedy=True, repeat_penalty=1.3, repeat_last_n=16)
    prompts = [[5, 6, 7], [9, 1, 2, 3]]
    assert _block_run(params, cfg, prompts, 1, 10, sp) == \
        _block_run(params, cfg, prompts, 4, 10, sp)


def test_decode_block_paged_matches_single_step(model):
    """decode_block over the paged pool: positions past a row's
    reservation land on the trash page; ids equal single steps."""
    params, cfg = model
    prompts = _ragged(13, 5)
    kw = dict(kv_mode="paged", page_size=16)
    cfg_eos, _ = _eos_inside_a_block(params, cfg, prompts, 9, 4)
    assert _block_run(params, cfg_eos, prompts, 1, 9, **kw) == \
        _block_run(params, cfg_eos, prompts, 4, 9, **kw)


def test_decode_block_sampled_seeds(model):
    """A sampled decode block draws from the Scheduler's seeded generator:
    one seed gives the same ids twice, another seed other ids."""
    params, cfg = model
    sp = SamplingParams(temperature=1.5, top_k=0, top_p=1.0,
                        repeat_penalty=1.0)
    prompts = _ragged(17, 3)
    a, b, c = (_block_run(params, cfg, prompts, 4, 9, sp, seed=s)
               for s in (1, 1, 2))
    assert a == b and a != c


def _stream_rows(step, shift, ids, new):
    """The logits row [V] f32 at each step of a greedy stream fed ``new``
    after ``ids``, the cache shifted before the write that would overflow
    it, as the Scheduler orders them."""
    rows = [step(ids, 0)]
    pos = len(ids)
    for tok in new[:-1]:
        if pos >= MAX_LEN:
            shift()
            pos -= N_DISCARD
        rows.append(step([tok], pos))
        pos += 1
    return rows


def _jax_rows(jp, jcfg, ids, new):
    st = {"cache": jinit_cache(jcfg, 1, MAX_LEN)}

    def step(toks, pos):
        logits, st["cache"] = jmodel_step(
            jp, jnp.asarray([toks], jnp.int32), jnp.asarray([pos], jnp.int32),
            st["cache"], jcfg)
        return np.asarray(logits[0, -1], np.float32)

    def shift():
        st["cache"] = jshift_cache(st["cache"], jp["rope_inv_freqs"], jcfg,
                                   N_KEEP, N_DISCARD)
    return _stream_rows(step, shift, ids, new)


def _port_rows(params, cfg, ids, new):
    cache = init_cache(cfg, 1, MAX_LEN, device="cpu")

    def step(toks, pos):
        return model_step(params, torch.tensor([toks]), torch.tensor([pos]),
                          cache)[0, -1].numpy()

    def shift():
        shift_cache(cache, params.rope_inv_freqs, cfg, N_KEEP, N_DISCARD)
    return _stream_rows(step, shift, ids, new)


def test_scheduler_streaming_matches_jax_scheduler(both):
    """The same streaming requests through the JAX Scheduler and the
    port's (bf16 KV): each request's ids equal JAX's up to a step the
    margins do not prove, and most steps are proven."""
    jp, jcfg, params, cfg = both
    jsched = JScheduler(jp, jcfg, max_batch=2, max_len=MAX_LEN,
                        prefill_buckets=(8, 16, 32), streaming=True,
                        n_keep=N_KEEP, n_discard=N_DISCARD,
                        sampling=JSP(greedy=True, repeat_penalty=1.0),
                        kv_dtype=jnp.bfloat16)
    for i, p in enumerate(PROMPTS):
        jsched.add_request(f"q{i}", p, max_new_tokens=N_NEW)
    jdone = {s.request_id: s.output_ids for s in jsched.run_to_completion()}
    done = _streaming(params, cfg, "bf16")
    compared = proven = 0
    for i, p in enumerate(PROMPTS):
        jnew, pnew = jdone[f"q{i}"], done[f"q{i}"]
        assert len(pnew) == len(jnew) == N_NEW
        jrows = _jax_rows(jp, jcfg, p, jnew)
        prows = _port_rows(params, cfg, p, jnew)
        for t, (j, q) in enumerate(zip(jrows, prows)):
            err = np.abs(q - j).max()
            assert err <= REL_TOL * np.abs(j).max(), (i, t, err)
            top = np.sort(j)
            sure = top[-1] - top[-2] > 2 * err
            if pnew[t] != jnew[t]:
                assert not sure, (i, t, pnew, jnew)
                break
            compared += 1
            proven += sure
    assert compared >= 2 * N_NEW, (compared, proven)
    assert proven >= compared * 3 // 4, (proven, compared)
