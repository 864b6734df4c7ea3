"""The port's sampler against the JAX package's on the same seeded logits.

Filters: the kept set of every filter (top-k, top-p, tail-free, typical, and
the per-row chain ``_rowwise_filters``) equals JAX's exactly, on f32 logits
[4, 257] whose values lie more than 1e-4 apart, so no kept set hangs on a
rounding. Greedy and temperature-0 rows: the penalized argmax, equal ids.
Mirostat: ``mu`` after a forced token (one-hot logits) within 1e-6 of JAX's.
Draws: the two packages' random streams differ, so ``sample`` and
``sample_batched`` are drawn 20 000 times with a seeded ``torch.Generator``
and held by a chi-square test (p > 1e-4) to the softmax over the kept set
that JAX's filters give, with no draw outside that set.
"""
import numpy as np
import pytest
import torch

scipy_stats = pytest.importorskip("scipy.stats")

import jax
import jax.numpy as jnp

from neural_tpu.runtime import sampling as J

from neural_tpu_torch.runtime import sampling as P

V = 257
N_DRAWS = 20000
P_MIN = 1e-4


def _logits(seed=0, B=4, scale=2.0):
    """Normal logits [B, V], each row's sorted values spread by 2e-4 a rank
    so that no two lie within 1e-4."""
    z = np.random.default_rng(seed).standard_normal((B, V)) * scale
    order = np.argsort(z, axis=-1)
    x = np.empty_like(z)
    np.put_along_axis(x, order, np.sort(z, axis=-1) + np.arange(V) * 2e-4,
                      axis=-1)
    x = x.astype(np.float32)
    assert np.diff(np.sort(x, axis=-1), axis=-1).min() > 1e-4
    return x


def _kept(x):
    return np.asarray(x) > P.NEG / 2


FILTERS = [("top_k", k) for k in (1, 10, 40, 0, 300)] + \
    [("top_p", p) for p in (0.3, 0.9, 0.95, 1.0)] + \
    [("tail_free", z) for z in (0.5, 0.95, 1.0)] + \
    [("typical", p) for p in (0.2, 0.8, 1.0)]


@pytest.mark.parametrize("name,arg", FILTERS,
                         ids=[f"{n}_{a}" for n, a in FILTERS])
def test_filter_kept_set_equals_jax(name, arg):
    x = _logits(1)
    ref = getattr(J, name + "_filter")(jnp.asarray(x), arg)
    out = getattr(P, name + "_filter")(torch.from_numpy(x), arg)
    np.testing.assert_array_equal(_kept(out.numpy()), _kept(ref))
    kept = _kept(ref)
    np.testing.assert_array_equal(out.numpy()[kept], x[kept])


def _bp_rows():
    """Four rows with different filter settings, one with each filter
    off."""
    return [J.SamplingParams(top_k=20, top_p=0.9, tfs_z=1.0, typical_p=1.0),
            J.SamplingParams(top_k=0, top_p=0.8, tfs_z=0.9, typical_p=1.0),
            J.SamplingParams(top_k=50, top_p=1.0, tfs_z=1.0, typical_p=0.7),
            J.SamplingParams(top_k=300, top_p=0.95, tfs_z=0.95,
                             typical_p=0.9)]


def _port_sp(sp):
    return P.SamplingParams(**{f: getattr(sp, f)
                               for f in P.SamplingParams.__dataclass_fields__})


def test_rowwise_filters_equal_jax():
    x = _logits(2)
    rows = _bp_rows()
    ref = J._rowwise_filters(jnp.asarray(x), J.batch_params(rows))
    out = P._rowwise_filters(torch.from_numpy(x),
                             P.batch_params([_port_sp(r) for r in rows]))
    np.testing.assert_array_equal(_kept(out.numpy()), _kept(ref))


def test_greedy_and_temperature_zero_rows_equal_jax():
    """``sample`` greedy and at temperature 0 after the repetition penalty,
    and ``sample_batched``'s greedy rows beside sampled ones: JAX's ids."""
    x = _logits(3)
    hist = np.random.default_rng(3).integers(0, V, (4, 16)).astype(np.int32)
    for sp in (J.SamplingParams(greedy=True),
               J.SamplingParams(temperature=0.0, repeat_penalty=1.3)):
        ref, _ = J.sample(jnp.asarray(x), jax.random.PRNGKey(0), sp,
                          prev_tokens=jnp.asarray(hist))
        out, _ = P.sample(torch.from_numpy(x), _port_sp(sp),
                          prev_tokens=torch.from_numpy(hist).long())
        assert out.tolist() == np.asarray(ref).tolist()
    rows = [J.SamplingParams(greedy=True), J.SamplingParams(),
            J.SamplingParams(temperature=0.0), J.SamplingParams(mirostat=2)]
    bp = J.batch_params(rows)
    ref, _ = J.sample_batched(jnp.asarray(x), jax.random.PRNGKey(0), bp,
                              jnp.full((4,), 10.0), prev_tokens=hist)
    out, _ = P.sample_batched(torch.from_numpy(x),
                              P.batch_params([_port_sp(r) for r in rows]),
                              torch.full((4,), 10.0),
                              prev_tokens=torch.from_numpy(hist).long(),
                              generator=torch.Generator().manual_seed(0))
    for r in (0, 2):
        assert int(out[r]) == int(np.asarray(ref)[r])


@pytest.mark.parametrize("mirostat", [1, 2])
def test_mirostat_mu_after_a_forced_token(mirostat):
    """One-hot logits force the token; mu then moves by eta·(tau -
    surprise) in both packages, per row of sample and of sample_batched."""
    x = np.zeros((3, V), np.float32)
    x[np.arange(3), [5, 77, 200]] = 40.0
    mu0 = np.asarray([10.0, 7.5, 3.0], np.float32)
    sp = J.SamplingParams(mirostat=mirostat, mirostat_tau=4.0,
                          mirostat_eta=0.2, temperature=0.7)
    ref_tok, ref_st = J.sample(jnp.asarray(x), jax.random.PRNGKey(1), sp,
                               J.SamplerState(mu=jnp.asarray(mu0)))
    tok, st = P.sample(torch.from_numpy(x), _port_sp(sp),
                       P.SamplerState(mu=torch.from_numpy(mu0)),
                       generator=torch.Generator().manual_seed(1))
    assert tok.tolist() == np.asarray(ref_tok).tolist() == [5, 77, 200]
    np.testing.assert_allclose(st.mu.numpy(), np.asarray(ref_st.mu),
                               rtol=0, atol=1e-6)
    bp = J.batch_params([sp] * 3)
    ref_tok, ref_mu = J.sample_batched(jnp.asarray(x), jax.random.PRNGKey(1),
                                       bp, jnp.asarray(mu0))
    tok, mu = P.sample_batched(torch.from_numpy(x),
                               P.batch_params([_port_sp(sp)] * 3),
                               torch.from_numpy(mu0),
                               generator=torch.Generator().manual_seed(1))
    assert tok.tolist() == np.asarray(ref_tok).tolist()
    np.testing.assert_allclose(mu.numpy(), np.asarray(ref_mu), rtol=0,
                               atol=1e-6)


def _chi_square(draws, probs):
    """Draws [N] against probabilities [V]: none outside the support, and
    the chi-square p-value over the support (bins expecting fewer than 5
    draws pooled)."""
    n = len(draws)
    counts = np.bincount(draws, minlength=len(probs))
    assert counts[probs == 0].sum() == 0
    exp = probs * n
    big = exp >= 5
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(exp[big], exp[~big].sum())
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    return scipy_stats.chisquare(obs, exp).pvalue


def _softmax(x):
    x = np.asarray(x, np.float64)
    e = np.exp(x - x.max())
    e[np.asarray(x) <= P.NEG / 2] = 0.0
    return e / e.sum()


DRAW_CASES = {
    "top_k_top_p": J.SamplingParams(temperature=0.8, top_k=40, top_p=0.95),
    "tail_free": J.SamplingParams(temperature=1.0, top_k=0, top_p=1.0,
                                  tfs_z=0.9),
    "typical": J.SamplingParams(temperature=1.2, top_k=0, top_p=1.0,
                                typical_p=0.8),
}


def _jax_filtered(x, sp):
    t = jnp.asarray(x) / sp.temperature
    for f, a in (("top_k", sp.top_k), ("tail_free", sp.tfs_z),
                 ("typical", sp.typical_p), ("top_p", sp.top_p)):
        t = getattr(J, f + "_filter")(t, a)
    return np.asarray(t)


@pytest.mark.parametrize("case", list(DRAW_CASES))
def test_sample_draws_follow_jax_filtered_softmax(case):
    sp = DRAW_CASES[case]
    x = _logits(4, B=1, scale=1.5)
    probs = _softmax(_jax_filtered(x, sp)[0])
    big = torch.from_numpy(np.repeat(x, N_DRAWS, axis=0))
    gen = torch.Generator().manual_seed(11)
    tok, _ = P.sample(big, _port_sp(sp), generator=gen)
    assert _chi_square(tok.numpy(), probs) > P_MIN


@pytest.mark.parametrize("enable", [("filters",), ("filters", "mirostat")])
def test_sample_batched_draws_follow_jax(enable):
    """sample_batched with per-row filters (``enable`` with "filters"), and
    mirostat v2 rows besides (the first step's truncation at mu = 2·tau),
    each row's draws against its JAX distribution."""
    x = _logits(5, B=1, scale=1.5)
    rows = [DRAW_CASES["top_k_top_p"], DRAW_CASES["typical"]]
    if "mirostat" in enable:
        rows.append(J.SamplingParams(mirostat=2, mirostat_tau=3.0,
                                     temperature=0.9))
    expect = []
    for sp in rows:
        if sp.mirostat:
            t = x[0] / np.float32(sp.temperature)
            logp = np.asarray(jax.nn.log_softmax(jnp.asarray(t)))
            keep = -logp / np.log(2.0) <= 2.0 * sp.mirostat_tau
            expect.append(_softmax(np.where(keep, t, P.NEG)))
        else:
            expect.append(_softmax(_jax_filtered(x, sp)[0]))
    # the draws in chunks of CHUNK rows of each kind, to keep [B, V] small
    CHUNK = N_DRAWS // 4
    bp = P.batch_params([_port_sp(r) for r in rows for _ in range(CHUNK)])
    big = torch.from_numpy(np.repeat(x, CHUNK * len(rows), axis=0))
    gen = torch.Generator().manual_seed(12)
    toks = []
    for _ in range(N_DRAWS // CHUNK):
        tok, mu = P.sample_batched(big, bp, enable=enable, generator=gen)
        toks.append(tok.numpy().reshape(len(rows), CHUNK))
    tok = np.concatenate(toks, axis=1)
    for r, probs in enumerate(expect):
        assert _chi_square(tok[r], probs) > P_MIN, r
    if "mirostat" in enable:
        assert not torch.equal(mu[-CHUNK:], 2.0 * bp.mirostat_tau[-CHUNK:])


def test_same_generator_seed_same_draws():
    x = torch.from_numpy(_logits(6))
    sp = _port_sp(DRAW_CASES["top_k_top_p"])
    a = [P.sample(x, sp, generator=torch.Generator().manual_seed(s))[0]
         for s in (3, 3, 4)]
    assert torch.equal(a[0], a[1]) and not torch.equal(a[0], a[2])
