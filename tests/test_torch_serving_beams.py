"""Beam groups and sampled rows in the port's Scheduler and ModelServer on
the CPU: twins of the beam, sampling and min-new-tokens cases of
``tests/test_serving.py``, on the tiny q4_j Llama that
``tests/test_torch_serving.py`` bridges from the JAX package.

The in-scheduler beam is held to the port's own ``beam_search`` exactly:
equal hypotheses, scores within 1e-4 (they rank through one routine,
``runtime.beam.rank_beams``, on the same logits). The prompt has 18
tokens so that the Scheduler's single-shot prefill ([1, 32]) and
``beam_search``'s ([1, 18]; both copy the prompt's KV to the group's other
rows) take the same product route (K5's plain version); at M <= 16 the route is K1's, which keeps bf16 scales where
K5's keeps f32 ones, and a 4-token prompt's scores part by about 3e-4.
Against the JAX Scheduler on the same weights the hypotheses are compared
rank by rank as ``tests/test_torch_beam.py`` compares ``beam_search``:
equal ids and scores within SCORE_TOL, except at a near tie of JAX's
scores. Sampled rows: one seed gives the same ids twice, another seed
other ids; they are not compared id for id with JAX (the two packages'
random streams differ).
"""
import dataclasses
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_tpu.runtime.sampling import SamplingParams as JSP
from neural_tpu.serving import Scheduler as JScheduler

from neural_tpu_torch.runtime.beam import beam_search
from neural_tpu_torch.runtime.sampling import SamplingParams
from neural_tpu_torch.serving import ModelServer, Query, Scheduler
from test_torch_serving import GREEDY, _generate_i8, bridged, ref_outputs

PROMPT = [3, 11, 7, 29, 41, 5, 88, 17, 2, 60, 91, 14, 33, 70, 9, 121, 46,
          18]
N_NEW, W = 6, 3
# bf16 activations: the packages round at other places (as
# tests/test_torch_beam.py)
SCORE_TOL = 2e-3
GAP_TOL = 4e-3
HOT = SamplingParams(temperature=1.5, top_k=0, top_p=1.0,
                     repeat_penalty=1.0)
KV = {"bf16": torch.bfloat16, "int8": torch.int8}


@pytest.fixture(scope="module")
def both():
    return bridged()


@pytest.fixture(scope="module")
def model(both):
    return both[2], both[3]


def _greedy_ref(params, cfg, prompt, n_new, kv):
    if kv == "int8":
        return _generate_i8(params, cfg, prompt, n_new)
    return ref_outputs(params, cfg, [prompt], n_new)[0]


def _run_beam(params, cfg, kv, **kw):
    sched = Scheduler(params, cfg, max_batch=4, max_len=64,
                      prefill_buckets=(32,), sampling=GREEDY,
                      kv_dtype=KV[kv], **kw)
    sched.add_request("beam", PROMPT, max_new_tokens=N_NEW, num_beams=W)
    sched.add_request("greedy", [5, 6, 7], max_new_tokens=N_NEW)
    done = {s.request_id: s for s in sched.run_to_completion()}
    assert set(done) == {"beam", "greedy"}
    return sched, done


def _check_beam(params, cfg, kv, done):
    ref = beam_search(params, cfg, PROMPT, beam_size=W, max_new_tokens=N_NEW,
                      max_len=64, kv_dtype=KV[kv])
    got = done["beam"]
    assert got.output_ids == ref[0].ids[len(PROMPT):]
    assert len(got.hypotheses) == W
    for (ids, score), hyp in zip(got.hypotheses, ref):
        assert ids == hyp.ids[len(PROMPT):]
        assert abs(score - hyp.score) <= 1e-4, (score, hyp.score)
    # the greedy request is unchanged by sharing the batch with the group
    assert done["greedy"].output_ids == _greedy_ref(params, cfg, [5, 6, 7],
                                                    N_NEW, kv)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_scheduler_beam_matches_standalone(model, kv):
    params, cfg = model
    _, done = _run_beam(params, cfg, kv)
    _check_beam(params, cfg, kv, done)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_scheduler_beam_paged_matches_standalone(model, kv):
    """Paged mode: the prompt's KV and each reorder are page-content
    copies over the shared pool; every page comes back at the end."""
    params, cfg = model
    sched, done = _run_beam(params, cfg, kv, kv_mode="paged", page_size=16)
    _check_beam(params, cfg, kv, done)
    assert sched.allocator.n_free == sched.cache.n_pages - 1


def test_scheduler_beam_blocks_until_slots(model):
    """A beam request needing W contiguous slots defers until they free."""
    params, cfg = model
    sched = Scheduler(params, cfg, max_batch=4, max_len=64,
                      prefill_buckets=(32,), sampling=GREEDY)
    for i in range(3):
        sched.add_request(f"g{i}", [2 + i, 3, 4], max_new_tokens=4)
    sched.add_request("beam", [9, 8], max_new_tokens=4, num_beams=3)
    admitted_with = None
    while sched.has_work:
        sched.step()
        groups = [q for q in sched.running.values() if q.beam is not None]
        if groups and admitted_with is None:
            admitted_with = len(sched.running) - W
            assert sorted(s for s, q in sched.running.items()
                          if q is groups[0]) == list(
                range(groups[0].beam.base, groups[0].beam.base + W))
    done = {s.request_id: s for s in sched.pop_finished()}
    assert set(done) == {"g0", "g1", "g2", "beam"}
    assert admitted_with <= 1        # it waited for three contiguous slots
    assert len(done["beam"].output_ids) <= 4
    assert len(done["beam"].hypotheses) == 3


def test_beam_reservation_covers_its_single_shot_pad(model):
    """A beam prefill is single-shot even where a plain prompt of its
    length would be chunked, so the pages reserved per beam cover
    bucket(T), not the chunks' pad end: a pool too small for that refuses
    the request up front, and one just large enough serves it."""
    params, cfg = model
    kw = dict(max_batch=4, max_len=128, prefill_buckets=(32, 64, 128),
              kv_mode="paged", page_size=16, prefill_chunk=32,
              sampling=GREEDY)
    prompt = [(7 * i) % 100 + 3 for i in range(70)]
    sched = Scheduler(params, cfg, n_pages=13, **kw)
    # chunks of 32 end their pads at 96 (6 pages); the single shot at 128
    assert sched._pad_end(70) == 96
    assert sched._pages_required(70, 4) == 6
    assert sched._pages_required(70, 4, 2) == 2 * 8
    with pytest.raises(ValueError, match="pool"):
        sched.add_request("beam", prompt, max_new_tokens=4, num_beams=2)
    sched = Scheduler(params, cfg, n_pages=17, **kw)
    sched.add_request("beam", prompt, max_new_tokens=4, num_beams=2)
    done = sched.run_to_completion()
    assert [q.request_id for q in done] == ["beam"]
    assert len(done[0].hypotheses) == 2
    assert sched.allocator.n_free == 16


def _serve(srv, queries, want):
    got = {}
    srv.callback = lambda seqs: got.update({s.request_id: s for s in seqs})
    srv.issueQuery(queries)
    t0 = time.time()
    while len(got) < want and time.time() - t0 < 120:
        time.sleep(0.02)
    return got


def test_server_beam_query(model):
    """Beam queries through ModelServer: a query's own num_beams, and the
    server's default for a query that sets none."""
    params, cfg = model
    ref = beam_search(params, cfg, PROMPT, beam_size=2, max_new_tokens=4,
                      max_len=64)
    want = ref[0].ids[len(PROMPT):]
    with ModelServer(params, cfg, max_batch=4, max_len=64,
                     sampling=GREEDY) as srv:
        got = _serve(srv, [Query("b", PROMPT, 4, num_beams=2)], 1)
    assert got["b"].output_ids == want
    with ModelServer(params, cfg, max_batch=4, max_len=64, sampling=GREEDY,
                     num_beams=2, length_penalty=1.0) as srv:
        got = _serve(srv, [Query("d", PROMPT, 4)], 1)
    assert got["d"].output_ids == want and len(got["d"].hypotheses) == 2


def _sampled_run(params, cfg, seed):
    sched = Scheduler(params, cfg, max_batch=2, max_len=64,
                      prefill_buckets=(32,), sampling=GREEDY, seed=seed)
    sched.add_request("greedy", [5, 9, 2], max_new_tokens=6)
    sched.add_request("hot", [5, 9, 2], max_new_tokens=6, sampling=HOT)
    return {s.request_id: s.output_ids for s in sched.run_to_completion()}


def test_per_request_sampling(model):
    """A greedy and a sampled request in one batch: the greedy ids equal
    sequential generation; the sampled ones are fixed by the seed."""
    params, cfg = model
    a, b, c = (_sampled_run(params, cfg, s) for s in (1, 1, 2))
    ref = ref_outputs(params, cfg, [[5, 9, 2]], 6)[0]
    assert a["greedy"] == c["greedy"] == ref
    assert len(a["hot"]) == 6 and all(0 <= t < 128 for t in a["hot"])
    assert a == b
    assert a["hot"] != c["hot"]


def test_mixed_batch_keeps_greedy_and_beam_rows(model):
    """Greedy, sampled and mirostat rows and a beam group in one paged
    int8 batch: the greedy rows equal a greedy-only run of the same
    Scheduler, and the beam equals ``beam_search``."""
    params, cfg = model
    miro = SamplingParams(mirostat=2, mirostat_tau=3.0, repeat_penalty=1.0,
                          repeat_last_n=0)
    prompts = [[5, 9, 2], [7, 1, 4, 4], [30, 2]]

    def run(mixed):
        sched = Scheduler(params, cfg, max_batch=8, max_len=64,
                          prefill_buckets=(32,), sampling=GREEDY,
                          kv_mode="paged", page_size=16, kv_dtype=torch.int8)
        for i, p in enumerate(prompts):
            sched.add_request(f"g{i}", p, max_new_tokens=N_NEW)
        if mixed:
            sched.add_request("hot", [5, 9, 2], max_new_tokens=N_NEW,
                              sampling=HOT)
            sched.add_request("miro", [5, 9, 2], max_new_tokens=N_NEW,
                              sampling=miro)
            sched.add_request("beam", PROMPT, max_new_tokens=N_NEW,
                              num_beams=W)
        return {s.request_id: s for s in sched.run_to_completion()}

    done, alone = run(True), run(False)
    for i in range(len(prompts)):
        assert done[f"g{i}"].output_ids == alone[f"g{i}"].output_ids
    ref = beam_search(params, cfg, PROMPT, beam_size=W, max_new_tokens=N_NEW,
                      max_len=64, kv_dtype=torch.int8)
    assert done["beam"].output_ids == ref[0].ids[len(PROMPT):]
    assert all(len(done[k].output_ids) == N_NEW for k in ("hot", "miro"))


def test_min_new_tokens_non_beam(model):
    """min_new_tokens suppresses EOS for plain requests too."""
    params, cfg = model
    probe = Scheduler(params, cfg, max_batch=1, max_len=64, sampling=GREEDY)
    probe.add_request("p", [3, 5, 7], max_new_tokens=1)
    first = probe.run_to_completion()[0].output_ids[0]
    cfg_eos = dataclasses.replace(cfg, eos_token_id=first)
    sched = Scheduler(params, cfg_eos, max_batch=1, max_len=64,
                      sampling=GREEDY)
    sched.add_request("q", [3, 5, 7], max_new_tokens=8, min_new_tokens=4)
    out = sched.run_to_completion()[0]
    assert len(out.output_ids) >= 4
    assert first not in out.output_ids[:3]   # EOS masked while below min


def test_mirostat_mu_persists(model):
    """Mirostat's mu adapts across tokens in the scheduler, per slot."""
    params, cfg = model
    sp = SamplingParams(greedy=False, mirostat=2, mirostat_tau=3.0,
                        repeat_penalty=1.0, repeat_last_n=0)
    sched = Scheduler(params, cfg, max_batch=1, max_len=64, sampling=sp)
    sched.add_request("m", [3, 5, 7], max_new_tokens=6)
    slot_mu = []
    while sched.has_work:
        sched.step()
        slot_mu.append(float(sched._mu[0]))
    assert len(slot_mu) >= 5
    assert any(abs(m - 6.0) > 1e-3 for m in slot_mu)
    assert len(set(np.round(slot_mu, 5))) > 1


@pytest.mark.parametrize("kv_mode", ["slots", "paged"])
def test_scheduler_beam_matches_jax_scheduler(both, kv_mode):
    """The same beam request (and a greedy one beside it) through the JAX
    Scheduler and the port's on the same weights: hypotheses rank by rank
    equal, scores within SCORE_TOL, but where JAX's scores are a near tie;
    the best hypothesis at least."""
    jp, jcfg, params, cfg = both
    kw = dict(max_batch=4, max_len=64, prefill_buckets=(32,),
              kv_mode=kv_mode, page_size=16)
    out = []
    for sched in (JScheduler(jp, jcfg, sampling=JSP(greedy=True,
                                                     repeat_penalty=1.0),
                             kv_dtype=jnp.bfloat16, **kw),
                  Scheduler(params, cfg, sampling=GREEDY, **kw)):
        sched.add_request("beam", PROMPT, max_new_tokens=N_NEW, num_beams=W)
        sched.add_request("greedy", [5, 6, 7], max_new_tokens=N_NEW)
        out.append({s.request_id: s for s in sched.run_to_completion()})
    jdone, done = out
    ref, got = jdone["beam"].hypotheses, done["beam"].hypotheses
    assert len(got) == len(ref) == W
    equal = 0
    for i, ((ids, score), (rids, rscore)) in enumerate(zip(got, ref)):
        if ids != rids:
            gaps = [abs(rscore - s) for j, (_, s) in enumerate(ref) if j != i]
            assert gaps and min(gaps) < GAP_TOL, (i, got, ref)
            continue
        assert abs(score - rscore) < SCORE_TOL, (i, score, rscore)
        equal += 1
    assert equal >= 1 and done["beam"].output_ids == list(got[0][0])
