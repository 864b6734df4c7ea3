"""Beam search in the port against the JAX package's and against
HuggingFace ``generate(num_beams=3)`` (as ``tests/test_beam.py`` does), on a
tiny Llama whose weights are rounded to bf16 first, so that the three run
the same weights (the two packages with bf16 activations, HF in f32).

Hypotheses are compared rank by rank: ids equal and scores within
SCORE_TOL of JAX's, except where the reference's score lies within GAP_TOL
of another of its hypotheses, where a rounding may rightly swap the two;
HF's best hypothesis likewise, its score within GAP_TOL (HF computes in
f32). ``reorder_batch`` is held to JAX's exactly.
"""
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax.numpy as jnp

from neural_tpu.api import Model as JModel
from neural_tpu.runtime.beam import beam_search as jbeam_search
from neural_tpu.runtime.kvcache import KVCache as JKV
from neural_tpu.runtime.kvcache import reorder_batch as jreorder_batch

from neural_tpu_torch.api import Model
from neural_tpu_torch.runtime.beam import beam_search
from neural_tpu_torch.runtime.kvcache import KVCache, reorder_batch

W, N_NEW = 3, 6
PROMPT = [3, 17, 91, 4, 120]
# the stop id: every beam's likeliest first token after PROMPT, so that
# hypotheses finish early and min_new_tokens has work to do
EOS = 22
# bf16 activations: the packages round at other places (score differences
# up to 9.8e-4 measured against JAX, 4.9e-4 against HF's f32)
SCORE_TOL = 2e-3
# a near tie: a score gap under this may order two hypotheses either way
GAP_TOL = 4e-3


@pytest.fixture(scope="module")
def models():
    cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=128, intermediate_size=352,
        num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=4,
        max_position_embeddings=256, eos_token_id=EOS, pad_token_id=0)
    torch.manual_seed(7)
    hf = transformers.LlamaForCausalLM(cfg).eval()
    with torch.no_grad():
        for p in hf.parameters():
            p.copy_(p.to(torch.bfloat16).to(torch.float32))
    jm = JModel().init_from_hf_model(hf, None)
    pm = Model().init_from_hf_model(hf, None, device="cpu")
    return hf, jm, pm


def _agree_where_gaps_allow(ours, ref):
    """Each hypothesis against the reference's of the same rank: equal ids
    and scores within SCORE_TOL, unless the reference's score lies within
    GAP_TOL of another of its hypotheses (a near tie, which a rounding may
    order either way). Returns the number held equal."""
    n = 0
    for i, (a, b) in enumerate(zip(ours, ref)):
        if a.ids != b.ids:
            gaps = [abs(b.score - r.score) for r in ref if r is not b]
            assert gaps and min(gaps) < GAP_TOL, (i, a, b)
            continue
        assert abs(a.score - b.score) < SCORE_TOL, (i, a.score, b.score)
        n += 1
    return n


@pytest.mark.parametrize("min_new", [0, 2])
def test_beam_search_matches_jax(models, min_new):
    _, jm, pm = models
    ref = jbeam_search(jm.params, jm.cfg, PROMPT, beam_size=W,
                       max_new_tokens=N_NEW, min_new_tokens=min_new)
    ours = beam_search(pm.params, pm.cfg, PROMPT, beam_size=W,
                       max_new_tokens=N_NEW, min_new_tokens=min_new)
    assert len(ours) == len(ref) == W
    assert all(ours[i].score >= ours[i + 1].score for i in range(W - 1))
    assert _agree_where_gaps_allow(ours, ref) >= 1
    if min_new:
        for h in ours:
            new = h.ids[len(PROMPT):]
            assert EOS not in new[:min_new - 1]


@pytest.mark.parametrize("min_new", [0, 2])
def test_beam_search_matches_hf(models, min_new):
    hf, _, pm = models
    ours = beam_search(pm.params, pm.cfg, PROMPT, beam_size=W,
                       max_new_tokens=N_NEW, min_new_tokens=min_new)
    with torch.no_grad():
        out = hf.generate(torch.tensor([PROMPT]), num_beams=W,
                          max_new_tokens=N_NEW, do_sample=False,
                          length_penalty=1.0, early_stopping=True,
                          min_new_tokens=min_new, num_return_sequences=1,
                          output_scores=True, return_dict_in_generate=True)
    ref = out.sequences[0].tolist()
    got = ours[0].ids
    # HF pads after an early stop
    same = got[:len(ref)] == ref or ref[:len(got)] == got
    assert same or abs(float(out.sequences_scores[0]) - ours[0].score) \
        < GAP_TOL, (got, ref)
    if same:
        assert abs(float(out.sequences_scores[0]) - ours[0].score) < GAP_TOL


def test_model_generate_num_beams_is_the_best_hypothesis(models):
    _, jm, pm = models
    ours = pm.generate(PROMPT, max_new_tokens=N_NEW, num_beams=W)[0]
    ref = jm.generate(PROMPT, max_new_tokens=N_NEW, num_beams=W)[0]
    best = beam_search(pm.params, pm.cfg, PROMPT, beam_size=W,
                       max_new_tokens=N_NEW)[0]
    assert ours == best.ids
    assert ours == ref


def _cache(rng, int8, L=2, B=4, H=2, S=8, Dh=16):
    shape = (L, B, H, S, Dh)
    if int8:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = (rng.random(shape[:-1]) * 0.1).astype(np.float32)
        vs = (rng.random(shape[:-1]) * 0.1).astype(np.float32)
        j = JKV(jnp.asarray(k), jnp.asarray(v),
                jnp.asarray(ks, jnp.bfloat16), jnp.asarray(vs, jnp.bfloat16))
        p = KVCache(torch.from_numpy(k), torch.from_numpy(v),
                    torch.from_numpy(ks).bfloat16(),
                    torch.from_numpy(vs).bfloat16())
        return j, p
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    j = JKV(jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
            None, None)
    p = KVCache(torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16())
    return j, p


def _as_np(t):
    return None if t is None else np.asarray(t.to(torch.float32)
                                             if t.dtype == torch.bfloat16
                                             else t)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_reorder_batch_equals_jax(int8):
    rng = np.random.default_rng(int(int8))
    jc, pc = _cache(rng, int8)
    idx = np.asarray([2, 2, 0, 3])
    ref = jreorder_batch(jc, jnp.asarray(idx))
    spare = KVCache(*(None if c is None else torch.empty_like(c)
                      for c in (pc.k, pc.v, pc.k_scale, pc.v_scale)))
    for out in (reorder_batch(pc, torch.from_numpy(idx)),
                reorder_batch(pc, torch.from_numpy(idx), spare)):
        for a, b in zip((out.k, out.v, out.k_scale, out.v_scale), ref):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(
                    _as_np(a), np.asarray(b, np.float32)
                    if b.dtype == jnp.bfloat16 else np.asarray(b))
    assert spare.k.data_ptr() != pc.k.data_ptr()
