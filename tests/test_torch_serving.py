"""The port's continuous-batching Scheduler and ModelServer on the CPU.

Twins of ``tests/test_serving.py`` and ``tests/test_paged.py`` (the same
configurations, prompts and thresholds), run on the port with q4_j weights
bridged from the JAX package (``QLinear`` holds native-pack weights only),
plus one test that drives the JAX Scheduler and the port's on the same
weights and requests: their admission order, chunk spans and page-table
rows must be equal, and their greedy ids equal for at least 10 of 12
requests — JAX's own threshold for the scheduler against sequential
generation (``test_serving.py``), since the two packages round bf16
activations at different places (``test_torch_model.py``).
"""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_tpu.convert import init_random as jinit_random
from neural_tpu.models.config import ModelConfig as JMC
from neural_tpu.runtime.generate import params_to_native as jparams_to_native
from neural_tpu.runtime.sampling import SamplingParams as JSP
from neural_tpu.serving import Scheduler as JScheduler

from neural_tpu_torch.convert.from_jax import params_from_numpy
from neural_tpu_torch.models.config import ModelConfig
from neural_tpu_torch.runtime.generate import greedy_generate
from neural_tpu_torch.runtime.sampling import SamplingParams
from neural_tpu_torch.serving import ModelServer, Query, Scheduler
from test_torch_bridge import jax_tree_to_numpy

GREEDY = SamplingParams(greedy=True, repeat_penalty=1.0)


def tiny_kw(**kw):
    d = dict(arch="llama", vocab_size=128, hidden_size=64, n_layers=2,
             n_heads=4, n_kv_heads=4, head_dim=16, intermediate_size=128,
             max_seq_len=256, eos_token_id=999)  # never hit
    d.update(kw)
    return d


def bridged(**kw):
    """JAX q4_j random weights (native-packed) and the same weights in the
    port: (jax params, jax cfg, port decoder, port cfg)."""
    jcfg, cfg = JMC(**tiny_kw(**kw)), ModelConfig(**tiny_kw(**kw))
    jp = jparams_to_native(jinit_random(jcfg, quant="q4_j"), force=True,
                           min_elems=0)
    return jp, jcfg, params_from_numpy(jax_tree_to_numpy(jp), cfg, "cpu"), \
        cfg


@pytest.fixture(scope="module")
def model():
    _, _, params, cfg = bridged()
    return params, cfg


@pytest.fixture(scope="module")
def both():
    return bridged()


def ref_outputs(params, cfg, prompts, n_new):
    return [greedy_generate(params, cfg, p, max_new_tokens=n_new,
                            stop_at_eos=False)[len(p):] for p in prompts]


def _prompts(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, 128, int(rng.integers(lo, hi)))))
            for _ in range(n)]


def test_scheduler_matches_sequential(model):
    params, cfg = model
    prompts = _prompts(0, 12, 3, 20)
    n_new = 8
    ref = ref_outputs(params, cfg, prompts, n_new)
    sched = Scheduler(params, cfg, max_batch=4, max_len=64, sampling=GREEDY,
                      prefill_buckets=(32,))
    for i, p in enumerate(prompts):
        sched.add_request(f"q{i}", p, max_new_tokens=n_new)
    done = sched.run_to_completion()
    assert len(done) == 12
    got = {s.request_id: s.output_ids for s in done}
    exact = sum(got[f"q{i}"] == ref[i] for i in range(12))
    assert exact >= 10, [(i, got[f"q{i}"], ref[i]) for i in range(12)
                         if got[f"q{i}"] != ref[i]]


def test_scheduler_interleaves(model):
    """More requests than slots → some must wait; all finish."""
    params, cfg = model
    sched = Scheduler(params, cfg, max_batch=2, max_len=64,
                      prefill_buckets=(32,), sampling=GREEDY)
    for i in range(5):
        sched.add_request(f"q{i}", [1 + i, 2, 3], max_new_tokens=6)
    done = sched.run_to_completion()
    assert len(done) == 5
    assert all(len(s.output_ids) == 6 for s in done)


def test_model_server_threaded(model):
    params, cfg = model
    results = {}

    def cb(done):
        for s in done:
            results[s.request_id] = s.output_ids

    with ModelServer(params, cfg, cb, max_batch=2, max_len=64,
                     sampling=GREEDY) as srv:
        srv.issueQuery([Query(f"q{i}", [5, 6, 7 + i], 5) for i in range(4)])
        t0 = time.time()
        while len(results) < 4 and time.time() - t0 < 120:
            time.sleep(0.05)
    assert len(results) == 4
    ref = ref_outputs(params, cfg, [[5, 6, 7 + i] for i in range(4)], 5)
    exact = sum(results[f"q{i}"] == ref[i] for i in range(4))
    assert exact >= 3, (results, ref)


def test_model_server_reference_kwargs(model):
    """Reference server kwargs, paged int8 KV, ``issueQuery(i, ids)``, a
    2-argument callback and ``Empty()``; the unported options raise."""
    params, cfg = model
    got, working = {}, []

    def cb(seqs, n_working):
        got.update({s.request_id: list(s.output_ids) for s in seqs})
        working.append(n_working)

    srv = ModelServer(params, cfg, cb, ctx_size=64, max_request_num=2,
                      batch_size=1, memory_dtype="int8", max_new_tokens=4,
                      kv_mode="paged", page_size=16, continuous_batching=True,
                      threads=8, scratch_size_ratio=2, do_sample=False,
                      repetition_penalty=1.0, seed=3)
    try:
        assert srv.scheduler.cache.k.dtype == torch.int8
        assert srv.scheduler.kv_mode == "paged"
        srv.issueQuery(0, [3, 17, 91])
        srv.issueQuery(Query(1, [9, 33], max_new_tokens=3))
        with pytest.raises(ValueError):
            srv.issueQuery(2, list(range(1, 64)))   # exceeds ctx_size
        t0 = time.time()
        while (not srv.Empty() or len(got) < 2) and time.time() - t0 < 120:
            time.sleep(0.05)
    finally:
        srv.stop()
    assert set(got) == {0, 1}
    assert len(got[0]) == 4 and len(got[1]) == 3
    assert working and all(n >= 0 for n in working)
    with pytest.raises(TypeError):
        ModelServer(params, cfg, not_a_real_kwarg=1)
    # the options beyond greedy reach the scheduler
    for kw, ok in ((dict(num_beams=2), lambda s: s.default_num_beams == 2),
                   (dict(shift_roped_k=True),
                    lambda s: s.scheduler.streaming),
                   (dict(decode_block=4),
                    lambda s: s.scheduler.decode_block == 4),
                   (dict(do_sample=True),
                    lambda s: not s.scheduler.sampling.greedy)):
        with ModelServer(params, cfg, max_batch=2, max_len=64, **kw) as srv:
            assert ok(srv), kw


def test_chunked_prefill_matches_and_interleaves(model):
    """Chunked prefill: outputs match the sequential reference, and running
    decodes advance on EVERY scheduler iteration while a long prompt
    prefills."""
    params, cfg = model
    rng = np.random.default_rng(3)
    long_prompt = list(map(int, rng.integers(1, 128, 25)))  # 4 chunks of 8
    short = [5, 6, 7]
    n_new = 12
    ref_long = ref_outputs(params, cfg, [long_prompt], n_new)[0]
    sched = Scheduler(params, cfg, max_batch=2, max_len=64,
                      prefill_buckets=(8, 16, 32), prefill_chunk=8,
                      sampling=GREEDY)
    sched.add_request("short", short, max_new_tokens=n_new)
    sched.step()                      # prefill short (1 chunk) + decode
    assert sched.running
    sched.add_request("long", long_prompt, max_new_tokens=n_new)
    short_seq = next(iter(sched.running.values()))
    grew = []
    for _ in range(4):
        before = len(short_seq.output_ids)
        sched.step()
        grew.append(len(short_seq.output_ids) == before + 1)
    assert all(grew), grew            # no decode stall during long prefill
    done = {s.request_id: s.output_ids for s in sched.run_to_completion()}
    assert done["long"] == ref_long
    assert len(done["short"]) == n_new


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.int8],
                         ids=["bf16", "int8"])
def test_chunked_prefill_paged(model, kv_dtype):
    """Chunked prefill composes with the paged KV pool (pad-tail offsets
    must stay inside the slot's reserved pages)."""
    params, cfg = model
    rng = np.random.default_rng(5)
    prompts = [list(map(int, rng.integers(1, 128, n))) for n in (25, 11, 3,
                                                                 30)]
    n_new = 6
    ref = [greedy_generate(params, cfg, p, max_new_tokens=n_new,
                           stop_at_eos=False)[len(p):] for p in prompts] \
        if kv_dtype == torch.bfloat16 else [
            _generate_i8(params, cfg, p, n_new) for p in prompts]
    sched = Scheduler(params, cfg, max_batch=2, max_len=64,
                      prefill_buckets=(8, 16, 32), prefill_chunk=8,
                      kv_mode="paged", page_size=16, kv_dtype=kv_dtype,
                      sampling=GREEDY)
    for i, p in enumerate(prompts):
        sched.add_request(f"q{i}", p, max_new_tokens=n_new)
    done = {s.request_id: s.output_ids for s in sched.run_to_completion()}
    exact = sum(done[f"q{i}"] == ref[i] for i in range(len(prompts)))
    assert exact >= len(prompts) - 1, (done, ref)


def _generate_i8(params, cfg, prompt, n_new):
    from neural_tpu_torch.runtime.generate import generate
    return generate(params, cfg, prompt, GREEDY, n_new, stop_at_eos=False,
                    kv_dtype=torch.int8)[len(prompt):]


def test_chunked_prefill_bucket_pad_never_crosses_max_len(model):
    """A prompt whose final chunk's bucket pad would cross max_len falls
    back to single-shot prefill (41 tokens: [40, 41) pads to 48 > 42); the
    40-token prompt chunks, and matches the reference."""
    params, cfg = model
    rng = np.random.default_rng(13)
    prompt = list(map(int, rng.integers(1, 128, 40)))
    n_new = 2
    ref = ref_outputs(params, cfg, [prompt], n_new)[0]
    sched = Scheduler(params, cfg, max_batch=1, max_len=42,
                      prefill_buckets=(8, 16), prefill_chunk=8,
                      sampling=GREEDY)
    assert sched._chunk_for(41) is None and sched._chunk_for(40) == 8
    sched.add_request("a", prompt, max_new_tokens=n_new)
    done = sched.run_to_completion()
    assert done[0].output_ids == ref, (done[0].output_ids, ref)


def test_paged_impossible_request_rejected(model):
    """A request whose page reservation can NEVER be satisfied raises at
    add_request instead of livelocking run_to_completion."""
    params, cfg = model
    sched = Scheduler(params, cfg, max_batch=1, max_len=128,
                      kv_mode="paged", page_size=32, n_pages=3)
    with pytest.raises(ValueError, match="pages"):
        sched.add_request("big", list(range(1, 60)), max_new_tokens=64)
    sched.add_request("ok", [3, 5, 7], max_new_tokens=8)
    assert len(sched.run_to_completion()) == 1


def test_paged_scheduler_matches_sequential(model):
    """12 requests through an UNDERSIZED page pool (oversubscription forces
    admission deferral) must match per-request loop generation."""
    params, cfg = model
    prompts = _prompts(0, 12, 3, 20)
    n_new = 8
    ref = ref_outputs(params, cfg, prompts, n_new)
    # pool holds 6 pages of 32 (+1 trash): max_len 64 = 2 pages per seq →
    # at most 3 resident despite 4 slots
    sched = Scheduler(params, cfg, max_batch=4, max_len=64, sampling=GREEDY,
                      prefill_buckets=(32,), kv_mode="paged", page_size=32,
                      n_pages=7)
    for i, p in enumerate(prompts):
        sched.add_request(f"q{i}", p, max_new_tokens=n_new)
    done = sched.run_to_completion()
    assert len(done) == 12
    assert sched.allocator.n_free == 6
    got = {s.request_id: s.output_ids for s in done}
    exact = sum(got[f"q{i}"] == ref[i] for i in range(12))
    assert exact >= 10, [(i, got[f"q{i}"], ref[i]) for i in range(12)
                         if got[f"q{i}"] != ref[i]]


def test_admission_reservation_formula_agrees_with_begin_prefill(model):
    """Non-doubling buckets where a chunked prefill's last-chunk pad end
    exceeds bucket(T): admission and the reservation share
    _pages_required, so the request admits with enough pages."""
    params, cfg = model
    sched = Scheduler(params, cfg, max_batch=2, max_len=224, sampling=GREEDY,
                      prefill_buckets=(64, 130, 200), prefill_chunk=64,
                      kv_mode="paged", page_size=32, n_pages=8)
    # T=130: chunks [0,64),[64,128),[128,130) -> pad_end = 128 + 64 = 192
    assert sched._pad_end(130) > 130
    sched.add_request("edge", [1 + i % 127 for i in range(130)],
                      max_new_tokens=8)
    done = sched.run_to_completion()
    assert len(done) == 1 and len(done[0].output_ids) == 8
    assert sched.allocator.n_free == sched.cache.n_pages - 1


def test_unported_requests_raise(model):
    """What the port still refuses, each with its cause: a paged streaming
    scheduler, more beams than slots, a streaming prompt that fills the
    cache, a request past max_len, an empty prompt, and a server built
    from a checkpoint path (ROADMAP A10)."""
    params, cfg = model
    with pytest.raises(ValueError, match="kv_mode='slots'"):
        Scheduler(params, cfg, max_batch=2, max_len=64, kv_mode="paged",
                  page_size=16, streaming=True)
    sched = Scheduler(params, cfg, max_batch=2, max_len=64)
    with pytest.raises(ValueError, match="num_beams 3 exceeds"):
        sched.add_request("b", [1, 2], 4, num_beams=3)
    with pytest.raises(ValueError, match="exceeds max_len"):
        sched.add_request("long", [1] * 60, max_new_tokens=8)
    with pytest.raises(ValueError, match="at least one prompt token"):
        sched.add_request("empty", [], max_new_tokens=8)
    stream = Scheduler(params, cfg, max_batch=2, max_len=64, streaming=True)
    stream.add_request("past", [1] * 60, max_new_tokens=100)
    with pytest.raises(ValueError, match="shorter than max_len"):
        stream.add_request("full", [1] * 64, max_new_tokens=8)
    assert not (sched.has_work or sched.waiting)
    with pytest.raises(NotImplementedError, match="A10"):
        ModelServer(params, cfg, model_path="m.bin")


def _trace(sched, paged):
    """Run to completion, recording after every step what the scheduler
    decided: the in-flight prefill (request, next chunk start), the running
    slots, and in paged mode the page table."""
    trace = []
    while sched.has_work:
        sched.step()
        pre = sched._prefilling
        trace.append((
            None if pre is None else (pre.request_id, pre.slot,
                                      pre.prefill_pos),
            tuple(sorted((s, q.request_id)
                         for s, q in sched.running.items())),
            sched.table_np.tolist() if paged else None))
    return trace, {s.request_id: s.output_ids for s in sched.pop_finished()}


@pytest.mark.parametrize("kv_mode,kv_dtype,beams", [
    ("slots", "bf16", False), ("slots", "int8", False),
    ("paged", "bf16", False), ("paged", "int8", False),
    ("slots", "bf16", True), ("paged", "int8", True)],
    ids=["slots-bf16", "slots-int8", "paged-bf16", "paged-int8",
         "slots-bf16-beams", "paged-int8-beams"])
def test_port_scheduler_matches_jax_scheduler(both, kv_mode, kv_dtype, beams):
    """Same weights, same 12 requests (prompts 3-40 tokens, 6 new each, the
    default repetition penalty), 4 slots, chunked prefill, an undersized
    page pool: equal decisions at every step, and equal greedy ids for at
    least 10 of 12 requests. With ``beams``, requests 3 and 8 are beam
    groups (3 and 2 beams), which wait for contiguous slots and take a
    page reservation per beam: the decisions and page tables still equal
    JAX's at every step."""
    jp, jcfg, params, cfg = both
    prompts = _prompts(7, 12, 3, 40)
    kw = dict(max_batch=4, max_len=64, prefill_buckets=(8, 16, 32),
              prefill_chunk=16, kv_mode=kv_mode, page_size=16)
    if kv_mode == "paged":
        kw["n_pages"] = 10 + 4 * beams
    widths = {3: 3, 8: 2} if beams else {}
    jsched = JScheduler(jp, jcfg, sampling=JSP(greedy=True),
                        kv_dtype="int8" if kv_dtype == "int8"
                        else jnp.bfloat16, **kw)
    sched = Scheduler(params, cfg, sampling=SamplingParams(greedy=True),
                      kv_dtype=torch.int8 if kv_dtype == "int8"
                      else torch.bfloat16, **kw)
    for s in (jsched, sched):
        for i, p in enumerate(prompts):
            s.add_request(f"q{i}", p, max_new_tokens=6,
                          num_beams=widths.get(i, 1))
    jtrace, jdone = _trace(jsched, kv_mode == "paged")
    trace, done = _trace(sched, kv_mode == "paged")
    assert trace == jtrace
    if beams:   # each group held its W slots, and one beside others
        batches = [[r for _, r in running] for _, running, _ in trace]
        for i, w in widths.items():
            assert any(b.count(f"q{i}") == w for b in batches)
        assert any(len(b) > len(set(b)) > 1 for b in batches)
    exact = sum(done[f"q{i}"] == jdone[f"q{i}"] for i in range(12))
    assert exact >= 10, [(i, done[f"q{i}"], jdone[f"q{i}"])
                         for i in range(12) if done[f"q{i}"] != jdone[f"q{i}"]]
