"""The dense model zoo end to end on the CPU: tiny HF models (built locally
from random configs, as ``tests/test_zoo_golden.py``'s ``build`` makes
them) of GPT-J, GPT-NeoX (parallel and serial residual), OPT and Falcon
(7B-style and the new decoder architecture) here, and of GPT-BigCode,
Qwen2, Phi-2, Phi-3, StableLM and SOLAR in ``test_torch_zoo_more.py`` (the
same checks, a file each to keep each under a minute), converted by both
packages at ``quant=None`` and at q4_j and run through both.

What they run that Llama bypasses: GPT-J's interleaved RoPE on part of
the head, NeoX RoPE on part of it (GPT-NeoX, Phi-2, StableLM), parallel
residuals with one shared norm (GPT-J, Phi-2, Falcon-7B) or two (GPT-NeoX,
Falcon's new architecture), learned positions (OPT at offset 2,
GPT-BigCode), the lm_head bias (GPT-J, Phi-2), multi-query attention
(Falcon-7B, GPT-BigCode), G = 7 (Qwen2-7B's 28 heads over 4, here 7 over
1), the fused q/k/v splits (GPT-NeoX's per-head interleave, Falcon's
layouts, GPT-BigCode's concatenation, Phi-3's qkv_proj and gate_up_proj)
and ReLU (OPT). The families whose full-size heads the card's attention
kernels take (GPT-J 256; GPT-NeoX as Pythia, OPT, GPT-BigCode, Qwen2 and
SOLAR 128) are widened to those head dims here, as
``test_torch_bloom_mpt.py`` widens Bloom's, so that the port's CPU run
goes through the kernels' plain versions; Falcon, Phi-2, Phi-3 and
StableLM keep the golden test's head dim 16 (their full-size heads, 64,
80 and 96, go to ``attend_xla`` in both packages).

Tolerances, as ``test_torch_bloom_mpt.py`` states them: params equal leaf
for leaf, exactly; logits within 3e-2·max|ref| (bf16 activations rounded
at other places in the two packages); greedy ids (no penalty) equal to
JAX's up to the first step where JAX's top-2 margin falls below that
tolerance, for GPT-J, Falcon, Phi-2 and GPT-BigCode (the JAX golden test's
greedy set).
"""
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402

from neural_tpu.convert import from_hf_model as jfrom_hf_model  # noqa: E402
from neural_tpu.runtime.generate import (  # noqa: E402
    model_step as jmodel_step, params_to_native as jparams_to_native)
from neural_tpu.runtime.kvcache import init_cache as jinit_cache  # noqa: E402

from neural_tpu_torch.api import Model  # noqa: E402
from neural_tpu_torch.convert.from_jax import params_from_numpy  # noqa: E402
from neural_tpu_torch.convert.hf import from_hf_model  # noqa: E402
from neural_tpu_torch.runtime.generate import model_step  # noqa: E402
from neural_tpu_torch.runtime.kvcache import init_cache  # noqa: E402
from test_torch_bridge import jax_tree_to_numpy  # noqa: E402
from test_zoo_golden import build as golden_build  # noqa: E402

VOCAB = 256
REL_TOL = 3e-2
T_PROMPT = 12
N_STEPS = 6


def _mk(cls, cfg):
    torch.manual_seed(0)
    return cls(cfg).eval()


def build(arch):
    """``test_zoo_golden.build``'s model, widened to the full-size head dim
    where the family's full-size heads reach the card's attention kernels."""
    t = transformers
    if arch == "gptj":           # EleutherAI/gpt-j-6b: Dh 256, rotary 64
        return _mk(t.GPTJForCausalLM, t.GPTJConfig(
            vocab_size=VOCAB, n_embd=256, n_layer=2, n_head=1,
            n_positions=256, rotary_dim=64))
    if arch in ("gpt_neox", "gpt_neox_seq"):   # Pythia-6.9B: Dh 128
        return _mk(t.GPTNeoXForCausalLM, t.GPTNeoXConfig(
            vocab_size=VOCAB, hidden_size=256, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=512,
            rotary_pct=0.25 if arch == "gpt_neox" else 1.0,
            max_position_embeddings=256,
            use_parallel_residual=arch == "gpt_neox"))
    if arch == "opt":            # facebook/opt-6.7b: Dh 128
        return _mk(t.OPTForCausalLM, t.OPTConfig(
            vocab_size=VOCAB, hidden_size=256, num_hidden_layers=2,
            num_attention_heads=2, ffn_dim=512, max_position_embeddings=256,
            activation_function="relu"))
    if arch == "gpt_bigcode":    # bigcode/starcoder: Dh 128, one KV head
        return _mk(t.GPTBigCodeForCausalLM, t.GPTBigCodeConfig(
            vocab_size=VOCAB, n_embd=256, n_layer=2, n_head=2,
            n_positions=256, multi_query=True,
            activation_function="gelu_pytorch_tanh"))
    if arch == "qwen2":          # Qwen/Qwen2-7B: Dh 128, G = 7
        return _mk(t.Qwen2ForCausalLM, t.Qwen2Config(
            vocab_size=VOCAB, hidden_size=896, num_hidden_layers=2,
            num_attention_heads=7, num_key_value_heads=1,
            intermediate_size=512, max_position_embeddings=256,
            rope_theta=1e6, rms_norm_eps=1e-6))
    if arch == "solar":          # upstage/SOLAR-10.7B: Llama's graph
        m = _mk(t.LlamaForCausalLM, t.LlamaConfig(
            vocab_size=VOCAB, hidden_size=256, num_hidden_layers=2,
            num_attention_heads=2, num_key_value_heads=1,
            intermediate_size=512, max_position_embeddings=256))
        m.config.model_type = "solar"
        return m
    return golden_build(arch)


ARCHS = ["gptj", "gpt_neox", "gpt_neox_seq", "opt", "falcon", "falcon_new"]
GREEDY = ("gptj", "falcon", "phi", "gpt_bigcode")


def cases(archs):
    return dict(scope="module", params=[(a, q) for a in archs
                                        for q in (None, "q4_j")],
                ids=lambda p: f"{p[0]}-{p[1] or 'bf16'}")


def make_pair(arch, quant):
    """(arch, quant, JAX params, JAX cfg, port decoder on the bridged JAX
    tree, port decoder from ``from_hf_model``)."""
    hf = build(arch)
    jp, jcfg = jfrom_hf_model(hf, quant)
    if quant is not None:
        jp = jparams_to_native(jp, force=True, min_elems=0)
    port, cfg = from_hf_model(hf, quant, device="cpu")
    bridged = params_from_numpy(jax_tree_to_numpy(jp), cfg, "cpu")
    return arch, quant, jp, jcfg, bridged, port


@pytest.fixture(**cases(ARCHS))
def pair(request):
    return make_pair(*request.param)


def test_from_hf_model_equals_bridged_params(pair):
    check_params(pair)


def test_logits_and_greedy_ids(pair):
    check_logits_and_greedy(pair)


def check_params(pair):
    arch, quant, _, jcfg, bridged, port = pair
    a, b = port.state_dict(), bridged.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k
    cfg = port.cfg
    assert cfg == bridged.cfg and cfg.arch == jcfg.arch
    assert ("pos_embed" in a) == cfg.learned_pos_emb
    assert ("lm_head_b" in a) == (arch in ("gptj", "phi"))
    shared = arch in ("gptj", "phi", "falcon")
    assert ("layers.0.ffn_norm_w" not in a) == shared
    assert cfg.parallel_residual == (arch not in (
        "gpt_neox_seq", "opt", "gpt_bigcode", "qwen2", "phi3", "stablelm",
        "solar"))


def _close(out, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(out, np.float32), ref, rtol=0,
                               atol=REL_TOL * np.abs(ref).max())


def check_logits_and_greedy(pair):
    """Every row of a 12-token prompt, then 6 decode steps fed JAX's argmax,
    over a bf16 cache; for the greedy set also the port's
    ``Model.generate`` (no penalty) against JAX's argmax ids."""
    arch, _, jp, jcfg, bridged, _ = pair
    ids = np.random.default_rng(1).integers(3, VOCAB, T_PROMPT).tolist()
    S = T_PROMPT + N_STEPS + 2
    jc = jinit_cache(jcfg, 1, S)
    pc = init_cache(bridged.cfg, 1, S, device="cpu")
    jl, jc = jmodel_step(jp, jnp.asarray([ids], jnp.int32),
                         jnp.zeros((1,), jnp.int32), jc, jcfg)
    pl = model_step(bridged, torch.tensor([ids]),
                    torch.zeros(1, dtype=torch.long), pc)
    assert pl.shape == (1, T_PROMPT, VOCAB)
    _close(pl.numpy(), jl)
    jnew, margins = [], []
    for s in range(N_STEPS):
        row = np.asarray(jl, np.float32)[0, -1]
        top2 = np.sort(row)[-2:]
        margins.append((top2[1] - top2[0], np.abs(row).max()))
        tok = int(np.argmax(row))
        jnew.append(tok)
        jl, jc = jmodel_step(jp, jnp.asarray([[tok]], jnp.int32),
                             jnp.asarray([T_PROMPT + s], jnp.int32), jc,
                             jcfg)
        pl = model_step(bridged, torch.tensor([[tok]]),
                        torch.tensor([T_PROMPT + s]), pc)
        _close(pl.numpy(), jl)
    if arch not in GREEDY:
        return
    out = Model().init_params(bridged, bridged.cfg).generate(
        ids, max_new_tokens=N_STEPS, do_sample=False, stop_at_eos=False,
        repetition_penalty=1.0)[0]
    assert out[:T_PROMPT] == ids and len(out) == T_PROMPT + N_STEPS
    safe = next((i for i, (m, scale) in enumerate(margins)
                 if m < REL_TOL * scale), len(margins))
    assert safe >= 1, margins
    assert out[T_PROMPT:][:safe] == jnew[:safe], (out, jnew, margins)
