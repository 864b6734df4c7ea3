"""The slice end to end on the CPU: a tiny q4_j Llama (GQA, hidden 256, head
dim 128 like the 7B) converted by both packages, run through both.

JAX side: ``from_hf_model(..., "q4_j")`` then ``params_to_native(force=True,
min_elems=0)`` — the port's single at-rest layout — inside a JAX ``Model``.
Port side: the same tree carried over by ``params_from_numpy``.

Logit tolerance: 3e-2·max|ref|. Both packages run bf16 activations; they
round at different places: K1 dequantizes in f32 where the JAX CPU path
(``qmatmul_native``) rounds the weight to bf16, the port's attention rounds
P to bf16 where ``attend_xla`` keeps f32, XLA keeps f32 between fused
elementwise ops, and jitted XLA division moves a few int8 activation codes
of the prefill's a8 products (ROADMAP.md section C). Measured: at most
1.8e-2·max|ref| over these prompts.

Greedy ids are compared up to the first step where JAX's top-1/top-2 margin
(after the repetition penalty) falls below that tolerance: beyond it a
rounding difference may rightly pick the other token.
"""
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax.numpy as jnp

from neural_tpu.api import Model as JModel
from neural_tpu.runtime.generate import (model_step as jmodel_step,
                                         params_to_native as jparams_to_native,
                                         prefill_step as jprefill_step)
from neural_tpu.runtime.kvcache import init_cache as jinit_cache
from neural_tpu.runtime.sampling import (SamplingParams as JSP,
                                         apply_penalties as japply_penalties,
                                         token_counts as jtoken_counts)

from neural_tpu_torch.api import Model
from neural_tpu_torch.convert.from_jax import params_from_numpy
from neural_tpu_torch.convert.hf import from_hf_model
from neural_tpu_torch.runtime.generate import (decode_loop, greedy_generate,
                                               model_step, prefill_step)
from neural_tpu_torch.runtime.kvcache import init_cache
from test_torch_bridge import jax_tree_to_numpy

VOCAB = 256
REL_TOL = 3e-2
N_NEW = 10


@pytest.fixture(scope="module")
def pair():
    hc = transformers.LlamaConfig(
        vocab_size=VOCAB, hidden_size=256, intermediate_size=1000,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
        max_position_embeddings=512, rms_norm_eps=1e-5, rope_theta=10000.0)
    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(hc).eval()
    jm = JModel().init_from_hf_model(hf, "q4_j")
    jm.params = jparams_to_native(jm.params, force=True, min_elems=0)
    port, cfg = from_hf_model(hf, "q4_j", device="cpu")
    bridged = params_from_numpy(jax_tree_to_numpy(jm.params), cfg, "cpu")
    pm = Model().init_params(bridged, cfg)
    return hf, jm, pm, port


# prompt seeds picked among the first twelve so that JAX's greedy margins
# stay above the tolerance for all N_NEW steps; with random ones about one
# step in four falls below it, and the id comparison would stop there
PROMPT_SEEDS = {12: 12007, 300: 300005}


def _prompt(T):
    return np.random.default_rng(PROMPT_SEEDS[T]).integers(
        3, VOCAB, T).tolist()


def test_from_hf_model_equals_bridged_params(pair):
    _, jm, pm, port = pair
    a, b = port.state_dict(), pm.params.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k
    assert [type(m).__name__ for m in port.modules()] == \
        [type(m).__name__ for m in pm.params.modules()]
    assert pm.cfg == port.cfg
    # FFN padded 1000 → 1024 at conversion, as in the JAX package
    assert port.layers[0].w_down.qt.shape == (1024, 256)


def _close(out, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(out, np.float32), ref, rtol=0,
                               atol=REL_TOL * np.abs(ref).max())


@pytest.mark.parametrize("T", [12, 300])
def test_prefill_and_decode_logits(pair, T):
    """Last-row prefill logits, then 8 decode steps fed the same tokens."""
    _, jm, pm, _ = pair
    ids = _prompt(T)
    S = T + 8
    jc = jinit_cache(jm.cfg, 1, S)
    jl, jc = jprefill_step(jm.params, jnp.asarray([ids], jnp.int32),
                           jnp.zeros((1,), jnp.int32), jc, jm.cfg)
    pc = init_cache(pm.cfg, 1, S, device="cpu")
    pl = prefill_step(pm.params, torch.tensor([ids]),
                      torch.zeros(1, dtype=torch.long), pc)
    assert pl.shape == (1, 1, VOCAB)
    _close(pl.numpy(), jl)
    tok = int(np.argmax(np.asarray(jl)[0, -1]))
    for s in range(8):
        jl, jc = jmodel_step(jm.params, jnp.asarray([[tok]], jnp.int32),
                             jnp.asarray([T + s], jnp.int32), jc, jm.cfg)
        pl = model_step(pm.params, torch.tensor([[tok]]),
                        torch.tensor([T + s]), pc)
        _close(pl.numpy(), jl)
        tok = int(np.argmax(np.asarray(jl)[0, -1]))


def _jax_margins(jm, ids, new, logits=None):
    """JAX's penalized top-1/top-2 margin at each generated step, replaying
    ``runtime.generate.generate``'s penalties over the JAX ids. ``logits``:
    the JAX logits of those steps the caller has already computed (the
    prompt's last row, then one step per id of ``new`` but the last, each
    an array whose last axis is the vocabulary), so that JAX's prefill and
    steps are not run twice; without them they are run here."""
    sp = JSP(greedy=True)
    T = len(ids)
    if logits is None:
        jc = jinit_cache(jm.cfg, 1, T + len(new))
        row, jc = jprefill_step(jm.params, jnp.asarray([ids], jnp.int32),
                                jnp.zeros((1,), jnp.int32), jc, jm.cfg)
        logits = [row]
        for i, tok in enumerate(new[:-1]):
            row, jc = jmodel_step(jm.params, jnp.asarray([[tok]], jnp.int32),
                                  jnp.asarray([T + i], jnp.int32), jc,
                                  jm.cfg)
            logits.append(row)
    out, margins = list(ids), []
    for tok, row in zip(new, logits):
        row = jnp.asarray(np.asarray(row, np.float32).reshape(
            -1, VOCAB)[-1:])
        hist = jnp.asarray([out[-sp.repeat_last_n:]], jnp.int32)
        counts = jtoken_counts(hist, jnp.ones(hist.shape, bool), VOCAB)
        pen = np.sort(np.asarray(japply_penalties(row, counts, sp))[0])
        margins.append((pen[-1] - pen[-2], np.abs(pen).max()))
        out.append(tok)
    return margins


@pytest.mark.parametrize("T", [12, 300])
def test_generate_greedy_ids_match_jax(pair, T):
    _, jm, pm, _ = pair
    ids = _prompt(T)
    jout = jm.generate(ids, max_new_tokens=N_NEW, do_sample=False,
                       stop_at_eos=False)[0]
    pout = pm.generate(ids, max_new_tokens=N_NEW, do_sample=False,
                       stop_at_eos=False)[0]
    assert pout[:T] == ids and len(pout) == T + N_NEW
    jnew, pnew = jout[T:], pout[T:]
    margins = _jax_margins(jm, ids, jnew)
    safe = next((i for i, (m, scale) in enumerate(margins)
                 if m < REL_TOL * scale), len(margins))
    assert safe >= 6, margins
    assert pnew[:safe] == jnew[:safe], (pnew, jnew, margins)


def test_greedy_generate_and_decode_loop_agree(pair):
    """The loops of the port agree with each other: greedy_generate (host
    argmax per token) and decode_loop (argmax on the device)."""
    _, _, pm, _ = pair
    ids = _prompt(12)
    out = greedy_generate(pm.params, pm.cfg, ids, max_new_tokens=6,
                          stop_at_eos=False)
    cache = init_cache(pm.cfg, 1, 32, device="cpu")
    logits = prefill_step(pm.params, torch.tensor([ids]),
                          torch.zeros(1, dtype=torch.long), cache)
    first = torch.argmax(logits[:, -1], dim=-1)
    toks = decode_loop(pm.params, first[:, None], torch.tensor([12]), cache,
                       n_steps=5)
    assert toks.shape == (5, 1)
    # decode_loop rounds its logits to bf16 before the argmax, as the JAX
    # decode_loop does; on these steps the top-2 margin survives that
    assert [int(first)] + toks[:, 0].tolist() == out[12:]


def test_generate_rejects_unported_options(pair):
    """What Model.generate still refuses: a session file with more than one
    prompt or with beams (as the JAX package asserts; session files run
    since the model-files slice), and under a mesh what the JAX package
    refuses there, in its words: beams, and the hooks, session files and
    streaming (``generate(mesh=...)`` runs since the parallelism slice).
    Sampling, beams, batches of prompts and streaming run since the
    sampling slice."""
    from neural_tpu_torch.parallel import make_mesh
    _, _, pm, _ = pair
    with pytest.raises(ValueError, match="session_file"):
        pm.generate([[1, 2, 3], [4, 5]], session_file="session.bin")
    with pytest.raises(ValueError, match="session_file"):
        pm.generate([1, 2, 3], session_file="session.bin", num_beams=2)
    mesh = make_mesh(device="cpu")
    with pytest.raises(ValueError, match="beam search not supported under "
                       "mesh"):
        pm.generate([1, 2, 3], mesh=mesh, num_beams=2)
    for kw in (dict(streaming=True), dict(interactive=True),
               dict(session_file="session.bin"),
               dict(stopping_criteria=lambda ids, scores: False)):
        with pytest.raises(ValueError, match=r"generate\(mesh=\.\.\.\) "
                           "does not support"):
            pm.generate([1, 2, 3], mesh=mesh, **kw)
