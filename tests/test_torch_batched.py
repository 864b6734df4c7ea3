"""Batches of prompts, ``truncate_at_eos``, ``batch_logits`` and the
``Model.generate`` modes of the sampling slice, in the port against the JAX
package, on the tiny q4_j Llama of ``test_torch_streaming.py`` (weights
carried over by the bridge).

Greedy ids of a ragged batch (prompts of 5, 9 and 12 tokens, 8 new each)
are proven by margins: both packages are teacher-forced through the same
padded prefill and batched steps on JAX's ids, each step's logits held
within 3e-2·max|logit| (the model tolerance of ``test_torch_model.py``);
where the reference's penalized top-1/top-2 margin exceeds twice the
step's largest logit difference times the repetition penalty, the argmax
is proven the same. Ids must agree step by step and may part only at a
step not proven. The port's batch against its own row-wise ``generate``
the same way (the batch prefills at other widths, so through other
kernels' plain versions). Sampled ids are held by distribution: 4000
first tokens of ``Model.generate(do_sample=True)`` against the softmax over
JAX's filtered set (chi-square, p > 1e-4).
"""
import numpy as np
import pytest
import torch

scipy_stats = pytest.importorskip("scipy.stats")

import jax.numpy as jnp

from neural_tpu.runtime import sampling as JS
from neural_tpu.runtime.generate import _prefill_ragged as j_prefill_ragged
from neural_tpu.runtime.generate import batch_logits as jbatch_logits
from neural_tpu.runtime.generate import batched_generate as jbatched_generate
from neural_tpu.runtime.generate import model_step as jmodel_step
from neural_tpu.runtime.generate import prefill_step as jprefill_step
from neural_tpu.runtime.generate import truncate_at_eos as jtruncate_at_eos
from neural_tpu.runtime.kvcache import init_cache as jinit_cache

from neural_tpu_torch.api import Model
from neural_tpu_torch.runtime.generate import (_prefill_ragged,
                                               batch_logits,
                                               batched_generate, generate,
                                               model_step, prefill_step,
                                               truncate_at_eos)
from neural_tpu_torch.runtime.kvcache import init_cache
from neural_tpu_torch.runtime.sampling import SamplingParams
from neural_tpu_torch.runtime.streaming import stream_generate
from test_torch_streaming import pair  # noqa: F401  (the shared fixture)

REL_TOL = 3e-2
RP = 1.1            # Model.generate's repetition penalty
N_NEW = 8
ROWS = [np.random.default_rng(20 + n).integers(3, 256, n).tolist()
        for n in (5, 9, 12)]


def _feed(new):
    return [list(f) for f in new]


def _port_batched_rows(pm, rows, feed):
    lens = torch.tensor([len(r) for r in rows])
    toks = torch.zeros((len(rows), int(lens.max())), dtype=torch.long)
    for b, r in enumerate(rows):
        toks[b, :len(r)] = torch.tensor(r)
    cache = init_cache(pm.cfg, len(rows), int(lens.max()) + N_NEW,
                       device="cpu")
    out = [_prefill_ragged(pm.params, toks, lens, cache).numpy()]
    for t in range(len(feed[0]) - 1):
        tok = torch.tensor([[f[t]] for f in feed])
        out.append(model_step(pm.params, tok, lens + t, cache)[:, -1]
                   .numpy())
    return out


def _jax_batched_rows(jm, rows, feed):
    lens = np.asarray([len(r) for r in rows], np.int32)
    toks = np.zeros((len(rows), lens.max()), np.int32)
    for b, r in enumerate(rows):
        toks[b, :len(r)] = r
    cache = jinit_cache(jm.cfg, len(rows), int(lens.max()) + N_NEW)
    logits, cache = j_prefill_ragged(jm.params, jnp.asarray(toks),
                                     jnp.asarray(lens), cache, jm.cfg)
    out = [np.asarray(logits, np.float32)]
    for t in range(len(feed[0]) - 1):
        tok = jnp.asarray([[f[t]] for f in feed], jnp.int32)
        logits, cache = jmodel_step(jm.params, tok, jnp.asarray(lens + t),
                                    cache, jm.cfg)
        out.append(np.asarray(logits[:, -1], np.float32))
    return out


def _port_rowwise_rows(pm, rows, feed):
    """Each row alone, as ``generate`` computes it: the last-row prefill,
    then one step per fed id."""
    out = []
    for r, f in zip(rows, feed):
        cache = init_cache(pm.cfg, 1, len(r) + N_NEW, device="cpu")
        rs = [prefill_step(pm.params, torch.tensor([r]),
                           torch.zeros(1, dtype=torch.long), cache)[0, -1]]
        for t, tok in enumerate(f[:-1]):
            rs.append(model_step(pm.params, torch.tensor([[tok]]),
                                 torch.tensor([len(r) + t]), cache)[0, -1])
        out.append([x.numpy() for x in rs])
    return [np.stack([out[b][t] for b in range(len(rows))])
            for t in range(len(feed[0]))]


def _penalized(row, history):
    sp = JS.SamplingParams(greedy=True)
    hist = jnp.asarray([history[-sp.repeat_last_n:]], jnp.int32)
    counts = JS.token_counts(hist, jnp.ones(hist.shape, bool), row.shape[-1])
    return np.asarray(JS.apply_penalties(jnp.asarray(row[None]), counts,
                                         sp))[0]


def _agree_where_proven(got, want, ref_rows, other_rows, rows):
    """Step by step per row: ``got`` ids may part from ``want`` only where
    the reference rows' penalized margin does not exceed 2·RP times the
    step's logit difference. Returns (compared, proven) step counts."""
    compared = proven = 0
    for b, r in enumerate(rows):
        for t in range(len(want[b])):
            ref, other = ref_rows[t][b], other_rows[t][b]
            np.testing.assert_allclose(other, ref, rtol=0,
                                       atol=REL_TOL * np.abs(ref).max())
            top = np.sort(_penalized(ref, r + want[b][:t]))
            sure = top[-1] - top[-2] > 2 * RP * np.abs(other - ref).max()
            if got[b][t] != want[b][t]:
                assert not sure, (b, t, got, want)
                break
            compared += 1
            proven += sure
    return compared, proven


def test_batched_generate_greedy_matches_jax_and_rowwise(pair):
    jm, pm = pair
    sp, jsp = SamplingParams(greedy=True), JS.SamplingParams(greedy=True)
    jout = jbatched_generate(jm.params, jm.cfg, ROWS, jsp, N_NEW,
                             stop_at_eos=False)
    pout = batched_generate(pm.params, pm.cfg, ROWS, sp, N_NEW,
                            stop_at_eos=False)
    jnew = [o[len(r):] for o, r in zip(jout, ROWS)]
    pnew = [o[len(r):] for o, r in zip(pout, ROWS)]
    assert [len(n) for n in pnew] == [N_NEW] * 3
    jrows = _jax_batched_rows(jm, ROWS, _feed(jnew))
    prows = _port_batched_rows(pm, ROWS, _feed(jnew))
    compared, proven = _agree_where_proven(pnew, jnew, jrows, prows, ROWS)
    assert proven >= 12, (compared, proven, pnew, jnew)
    # the port's batch against its own row-wise generate
    rnew = [generate(pm.params, pm.cfg, r, sp, N_NEW,
                     stop_at_eos=False)[len(r):] for r in ROWS]
    brows = _port_batched_rows(pm, ROWS, _feed(pnew))
    rrows = _port_rowwise_rows(pm, ROWS, _feed(pnew))
    compared, proven = _agree_where_proven(rnew, pnew, brows, rrows, ROWS)
    assert proven >= 12, (compared, proven, rnew, pnew)


def test_truncate_at_eos_equals_jax(pair):
    jm, pm = pair
    eos = pm.cfg.eos_token_ids[0]
    for ids in ([5, 6, eos, 7, eos], [eos], [1, 2, 3], []):
        assert truncate_at_eos(ids, pm.cfg) == jtruncate_at_eos(ids, jm.cfg)


def test_batch_logits_match_jax(pair):
    jm, pm = pair
    ids = np.random.default_rng(9).integers(3, 256, (2, 10))
    ref = np.asarray(jbatch_logits(jm.params, jm.cfg, ids), np.float32)
    out = batch_logits(pm.params, pm.cfg, ids).numpy()
    assert out.shape == ref.shape == (2, 10, 256)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=REL_TOL * np.abs(ref).max())


def test_model_generate_batch_of_prompts(pair):
    """A batch goes through ``batched_generate`` (prompt + new ids, or the
    new ids alone), greedy by default."""
    _, pm = pair
    model = Model().init_params(pm.params, pm.cfg)
    out = model.generate(ROWS, max_new_tokens=N_NEW, stop_at_eos=False)
    sp = SamplingParams(greedy=True, temperature=0.8, top_k=40, top_p=0.95,
                        repeat_penalty=RP)
    assert out == batched_generate(pm.params, pm.cfg, ROWS, sp, N_NEW,
                                   stop_at_eos=False)
    new = model.generate(ROWS, max_new_tokens=N_NEW, stop_at_eos=False,
                         ignore_prompt=True)
    assert new == [o[len(r):] for o, r in zip(out, ROWS)]


def test_model_generate_streaming(pair):
    """``streaming=True`` runs ``stream_generate`` with Model.generate's
    sampling (the repetition penalty), past the cache's end."""
    _, pm = pair
    model = Model().init_params(pm.params, pm.cfg)
    out = model.generate(ROWS[0], max_new_tokens=30, streaming=True,
                         max_len=16, n_keep=2, n_discard=6,
                         stop_at_eos=False)[0]
    sp = SamplingParams(greedy=True, temperature=0.8, top_k=40, top_p=0.95,
                        repeat_penalty=RP)
    assert out == stream_generate(pm.params, pm.cfg, ROWS[0], 30, 16,
                                  n_keep=2, n_discard=6, sampling=sp)
    assert len(out) == len(ROWS[0]) + 30


def test_model_generate_do_sample_by_distribution(pair):
    """The first sampled token of ``Model.generate(do_sample=True,
    temperature=0.8, top_k=k, top_p=1.0)``, over 4000 draws (80 seeds of a
    50-row batch of one prompt), against the softmax of JAX's penalized,
    tempered, top-k-filtered prefill logits. The filter's boundary gap is
    asserted to exceed twice the two packages' logit difference, so both
    keep the same set."""
    jm, pm = pair
    model = Model().init_params(pm.params, pm.cfg)
    prompt = ROWS[0]
    jl, _ = jprefill_step(jm.params, jnp.asarray([prompt], jnp.int32),
                          jnp.zeros((1,), jnp.int32),
                          jinit_cache(jm.cfg, 1, 8), jm.cfg)
    ref = np.asarray(jl[0, -1], np.float32)
    pl = prefill_step(pm.params, torch.tensor([prompt]),
                      torch.zeros(1, dtype=torch.long),
                      init_cache(pm.cfg, 1, 8, device="cpu"))[0, -1].numpy()
    err = np.abs(pl - ref).max()
    pen = _penalized(ref, prompt) / np.float32(0.8)
    top = np.sort(pen)[::-1]
    # k where the kept set's boundary is widest among 20..60: a boundary
    # inside the two packages' logit difference could be cut either way
    k = max(range(20, 61), key=lambda k: top[k - 1] - top[k])
    assert top[k - 1] - top[k] > 2 * RP * err / 0.8
    kept = np.asarray(JS.top_k_filter(jnp.asarray(pen[None]), k))[0]
    kept = kept.astype(np.float64)
    probs = np.exp(kept - kept.max()) * (kept > JS.NEG / 2)
    probs /= probs.sum()
    draws = []
    for seed in range(80):
        out = model.generate([prompt] * 50, max_new_tokens=1, do_sample=True,
                             temperature=0.8, top_k=k, top_p=1.0, seed=seed,
                             ignore_prompt=True, stop_at_eos=False)
        draws += [o[0] for o in out]
    counts = np.bincount(draws, minlength=len(probs))
    assert counts[probs == 0].sum() == 0
    exp = probs * len(draws)
    big = exp >= 5
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(exp[big], exp[~big].sum())
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    assert scipy_stats.chisquare(obs, exp).pvalue > 1e-4
    again = model.generate([prompt] * 50, max_new_tokens=4, do_sample=True,
                           seed=3)
    assert again == model.generate([prompt] * 50, max_new_tokens=4,
                                   do_sample=True, seed=3)


def test_model_generate_hooks(pair):
    """The host-stepped loop of ``streamer``, ``stopping_criteria`` and
    ``interactive``: the streamer gets the prompt, then each new id, then
    its end; a criterion that holds after three ids stops there; greedy
    rounds of an interactive session keep the cache (the next round starts
    where the last stopped) and return the new ids only, until
    ``reset_kv_cache``. The same greedy first round through the hooks and
    through ``stopping_criteria`` that never holds agree."""
    _, pm = pair
    model = Model().init_params(pm.params, pm.cfg)
    prompt = ROWS[1]

    class Streamer:
        def __init__(self):
            self.got, self.ended = [], 0

        def put(self, ids):
            self.got.append(np.asarray(ids).tolist())

        def end(self):
            self.ended += 1

    st = Streamer()
    out = model.generate(prompt, max_new_tokens=5, streamer=st,
                         stop_at_eos=False)[0]
    assert st.got == [[prompt]] + [[[t]] for t in out[len(prompt):]]
    assert st.ended == 1 and len(out) == len(prompt) + 5
    assert model.is_token_end()
    seen = []

    def stop(ids, scores):
        seen.append(ids.shape)
        return ids.shape[1] >= len(prompt) + 3

    cut = model.generate(prompt, max_new_tokens=8, stopping_criteria=stop,
                         stop_at_eos=False)[0]
    assert cut == out[:len(prompt) + 3]
    assert seen == [(1, len(prompt) + i) for i in (1, 2, 3)]
    never = model.generate(prompt, max_new_tokens=5, stop_at_eos=False,
                           stopping_criteria=lambda ids, scores: False)[0]
    assert never == out
    first = model.generate(prompt, max_new_tokens=4, interactive=True,
                           max_len=64, stop_at_eos=False)[0]
    assert first == out[:len(prompt) + 4]
    assert model._session[1] == len(prompt) + 3
    more = model.generate([7], max_new_tokens=3, interactive=True,
                          stop_at_eos=False)[0]
    assert len(more) == 3 and model._session[1] == len(prompt) + 3 + 1 + 2
    model.reset_kv_cache()
    assert model._session is None and model.is_token_end()
