"""The port's ``eval`` against the JAX package's, on the CPU: the twins of
``tests/test_eval.py``. The JAX test runs f32 activations, which the port
does not have yet (``Model`` refuses them: ROADMAP A14); here both packages
run the same tiny Llama at bf16 activations, each converting it from the
HF model, fp and q4_0.

Tolerances: the two packages round bf16 activations at different places
(tests/test_torch_model.py: up to 1.8e-2·max|logit| apart), so each
window's perplexity and a loglikelihood are held within 1e-2 relative of
the JAX package's (measured: below 6e-4 on both, fp and q4_0); ``logits_diff`` is numpy on the
same arrays in both: equal. Against the HF torch model (f32) the JAX test's
2e-2 relative on the first window becomes 5e-2 (bf16 activations).
"""
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from neural_tpu.api import Model as JModel
from neural_tpu.eval import (compare_vs_hf as jcompare_vs_hf,
                             logits_diff as jlogits_diff,
                             loglikelihood as jloglikelihood,
                             make_lm_eval_model as jmake_lm_eval_model,
                             perplexity as jperplexity,
                             score_choices as jscore_choices)

from neural_tpu_torch.api import Model
from neural_tpu_torch.eval import (compare_vs_hf, logits_diff, loglikelihood,
                                   make_lm_eval_model, perplexity,
                                   score_choices)

REL = 1e-2


def tiny():
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=256, hidden_size=128, intermediate_size=352,
        num_hidden_layers=2, num_attention_heads=8,
        num_key_value_heads=4)).eval()


@pytest.fixture(scope="module")
def models():
    hf = tiny()
    return {q: (JModel().init_from_hf_model(hf, weight_dtype=q),
                Model().init_from_hf_model(hf, weight_dtype=q, device="cpu"))
            for q in (None, "q4_0")} | {"hf": hf}


def _ids(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n).tolist()


@pytest.mark.parametrize("quant", [None, "q4_0"])
def test_perplexity_matches_jax(models, quant):
    jm, pm = models[quant]
    ids = _ids(0, 96)
    ref = jperplexity(jm.params, jm.cfg, ids, ctx_size=32, stride=16)
    got = perplexity(pm.params, pm.cfg, ids, ctx_size=32, stride=16)
    assert got["n_tokens"] == ref["n_tokens"] > 0 and got["ppl"] > 1
    assert len(got["per_window"]) == len(ref["per_window"])
    np.testing.assert_allclose(got["per_window"], ref["per_window"], rtol=REL)
    assert abs(got["ppl"] / ref["ppl"] - 1) < REL
    # the padded last batch is dropped: batch 2 over 5 windows is batch 1
    b2 = perplexity(pm.params, pm.cfg, ids, ctx_size=32, stride=16, batch=2)
    np.testing.assert_allclose(b2["per_window"], got["per_window"],
                               rtol=1e-6)
    assert b2["n_tokens"] == got["n_tokens"]


def test_perplexity_first_window_matches_torch(models):
    _, pm = models[None]
    hf = models["hf"]
    ids = _ids(0, 96)
    res = perplexity(pm.params, pm.cfg, ids, ctx_size=32, stride=16)
    with torch.no_grad():
        lp = torch.log_softmax(hf(torch.tensor([ids[:32]])).logits[0]
                               .float(), -1)
        nll = -lp[range(31), ids[1:32]].mean()
    ref = float(np.exp(float(nll)))
    assert abs(res["per_window"][0] - ref) / ref < 5e-2


def test_perplexity_needs_more_tokens_than_the_window(models):
    _, pm = models[None]
    with pytest.raises(ValueError, match="context window"):
        perplexity(pm.params, pm.cfg, _ids(1, 32), ctx_size=32)


def test_int4_ppl_delta_reasonable(models):
    ids = _ids(1, 80)
    p16 = perplexity(models[None][1].params, models[None][1].cfg, ids,
                     ctx_size=32, stride=16)["ppl"]
    p4 = perplexity(models["q4_0"][1].params, models["q4_0"][1].cfg, ids,
                    ctx_size=32, stride=16)["ppl"]
    assert p4 / p16 < 1.5, (p4, p16)


def test_compare_vs_hf_matches_jax(models):
    jm, pm = models["q4_0"]
    hf = models["hf"]
    prompts = [[3, 5, 9], [8, 2, 4]]
    ref = jcompare_vs_hf(jm, hf, prompts)
    got = compare_vs_hf(pm, hf, prompts)
    assert got["cos_min"] > 0.95 and 0 <= got["argmax_agree"] <= 1
    assert abs(got["cos_mean"] - ref["cos_mean"]) < 1e-2
    assert len(got["per_prompt"]) == 2


def test_logits_diff_equals_jax():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((2, 5, 64)).astype(np.float32)
    b = a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
    assert logits_diff(a, b) == jlogits_diff(a, b)
    with pytest.raises(ValueError, match="shapes"):
        logits_diff(a, b[:, :4])


@pytest.mark.parametrize("quant", [None, "q4_0"])
def test_loglikelihood_and_choices_match_jax(models, quant):
    jm, pm = models[quant]
    ctx, cont = [3, 17, 91], [4, 120]
    ll, greedy = loglikelihood(pm.params, pm.cfg, ctx, cont)
    jll, jgreedy = jloglikelihood(jm.params, jm.cfg, ctx, cont)
    assert abs(ll - jll) < REL * abs(jll) and greedy == jgreedy
    good = [int(np.argmax(pm([ctx])[0, -1]))]
    bad = [(good[0] + 7) % 256]
    choices = [bad, good, [5, 6]]
    assert score_choices(pm.params, pm.cfg, ctx, choices) == 1
    assert score_choices(pm.params, pm.cfg, ctx, choices) == \
        jscore_choices(jm.params, jm.cfg, ctx, choices)
    assert score_choices(pm.params, pm.cfg, ctx, choices, False) == \
        jscore_choices(jm.params, jm.cfg, ctx, choices, False)


def test_loglikelihood_matches_torch(models):
    _, pm = models[None]
    hf = models["hf"]
    ctx, cont = [3, 17, 91], [4, 120]
    ll, _ = loglikelihood(pm.params, pm.cfg, ctx, cont)
    with torch.no_grad():
        lp = torch.log_softmax(hf(torch.tensor([ctx + cont])).logits[0]
                               .float(), -1)
    ref = float(lp[2, 4] + lp[3, 120])
    assert abs(ll - ref) < 5e-2 * abs(ref), (ll, ref)


def test_lm_eval_adapter_gated():
    """lm-eval is not installed: both adapters raise ImportError."""
    with pytest.raises(ImportError):
        jmake_lm_eval_model(JModel())
    with pytest.raises(ImportError, match="lm-eval"):
        make_lm_eval_model(Model())
