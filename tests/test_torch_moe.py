"""The mixture-of-experts slice on the CPU: Mixtral and Grok-1 through the
routed expert MLP of the port (``models/transformer.py Block._moe``,
``moe_grouped``, ``moe_route``) against the JAX package's ``_moe_mlp`` /
``_moe_grouped`` on the same weights.

- Mixtral: a tiny HF ``MixtralForCausalLM`` (hidden 128, 2 layers, 4
  experts, top 2, 2 heads of 128 over 1, FFN 256) built locally as
  ``tests/test_zoo_golden.py`` builds it, converted by both packages with
  bf16 experts and at q4_j (the JAX side then at rest by its
  ``params_to_native(force=True, min_elems=0)``): params equal leaf for
  leaf; full-sequence logits at B·T = 4 (the dense mixture), 8 and 2 × 4
  (the grouped path for bf16 experts, the dense mixture over QTensors for
  q4_j) within 3e-2·max|ref|, the tolerance of ``test_torch_zoo.py`` (bf16
  activations on both sides, rounded at other places); a 12-token prefill
  and 6 decode steps fed JAX's argmax, and ``Model.generate``'s greedy ids
  against JAX's up to the first step whose margin does not prove them.
- Grok-1: ``tests/test_zoo_oracles.py``'s Grok checkpoint (its tensor
  names, ``rsd`` draws, softcaps, post norms, embedding scale, attention
  multiplier) at head dim 128, held to that file's numpy oracle within its
  2e-2 taken relative to max|oracle| and to the JAX ``model_step`` within
  3e-2·max|ref|, at 5 tokens (dense mixture) and 8 (grouped, f32 experts
  cast to bf16 in the products as ``rdot`` casts them).
- The pieces: ``moe_norm_topk=False`` (the full softmax gathered at the
  chosen experts) against JAX; a router whose columns tie on purpose,
  ``moe_route`` against ``jax.lax.top_k`` (lower index first) and a model
  with tied router columns against JAX; the grouped path's static form
  (the one a CUDA graph captures) against its eager form; experts are never
  FFN-padded.
- The port's Scheduler on the tiny Mixtral (q4_j, and bf16 experts whose
  batch-8 decode step takes the grouped path), slots and paged, each
  request's ids against the port's own greedy generation (>= 10 of 12
  exact, ``test_torch_serving.py``'s threshold); sampling, beams, a
  batch of prompts, StreamingLLM and the threaded ``ModelServer`` on it.
- The refusals: ``qwen2_moe`` names the reference's gap, ``qwen3`` is
  unchanged, a registry's requantization of experts and a
  layer-heterogeneous registry raise as in the JAX package, and a GGUF
  export of a MoE model raises.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from neural_tpu.convert import from_hf_model as jfrom_hf_model  # noqa: E402
from neural_tpu.convert import init_random as jinit_random  # noqa: E402
from neural_tpu.convert.hf import ARCH_MODULES as JARCH  # noqa: E402
from neural_tpu.convert.hf import build_params as jbuild_params  # noqa: E402
from neural_tpu.convert.hf import requantize as jrequantize  # noqa: E402
from neural_tpu.convert.quant_registry import \
    QuantRegistry as JQuantRegistry  # noqa: E402
from neural_tpu.models.config import ModelConfig as JMC  # noqa: E402
from neural_tpu.runtime.generate import (  # noqa: E402
    batch_logits as jbatch_logits, model_step as jmodel_step,
    params_to_native as jparams_to_native)
from neural_tpu.runtime.kvcache import init_cache as jinit_cache  # noqa: E402

from neural_tpu_torch.api import Model  # noqa: E402
from neural_tpu_torch.convert import gguf_models  # noqa: E402
from neural_tpu_torch.convert.from_jax import params_from_numpy  # noqa: E402
from neural_tpu_torch.convert.hf import (  # noqa: E402
    REFUSED, build_params, family, from_hf_model, init_random, requantize)
from neural_tpu_torch.convert.quant_registry import (  # noqa: E402
    QuantRegistry)
from neural_tpu_torch.core.dtypes import PRESETS  # noqa: E402
from neural_tpu_torch.models import qwen  # noqa: E402
from neural_tpu_torch.models.config import ModelConfig  # noqa: E402
from neural_tpu_torch.models.transformer import (  # noqa: E402
    ACTS, moe_grouped, moe_route)
from neural_tpu_torch.runtime.generate import (  # noqa: E402
    batch_logits, greedy_generate, model_step)
from neural_tpu_torch.runtime.kvcache import init_cache  # noqa: E402
from neural_tpu_torch.runtime.sampling import SamplingParams  # noqa: E402
from neural_tpu_torch.serving import Scheduler  # noqa: E402
from test_torch_bridge import jax_tree_to_numpy  # noqa: E402
from test_zoo_oracles import (RTOL, Obj, attn, gelu_tanh,  # noqa: E402
                              rmsnorm, rope_neox, rsd)

VOCAB = 256
REL_TOL = 3e-2
T_PROMPT = 12
N_STEPS = 6
# picked among the first twelve seeds so that JAX's greedy margins stay
# above the tolerance for all N_STEPS steps at bf16 and q4_j (as
# ``test_torch_model.py``'s PROMPT_SEEDS); with the others one step in
# five falls below it at random, and the id comparison stops there
PROMPT_SEED = 2
E, K = 4, 2


def build_mixtral():
    hc = transformers.MixtralConfig(
        vocab_size=VOCAB, hidden_size=128, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
        head_dim=128, num_local_experts=E, num_experts_per_tok=K,
        max_position_embeddings=256)
    torch.manual_seed(0)
    return transformers.MixtralForCausalLM(hc).eval()


@pytest.fixture(scope="module")
def hf():
    return build_mixtral()


@pytest.fixture(scope="module", params=[None, "q4_j"],
                ids=lambda q: q or "bf16")
def pair(request, hf):
    """(quant, JAX params, JAX cfg, port decoder on the bridged JAX tree,
    port decoder from ``from_hf_model``)."""
    quant = request.param
    jp, jcfg = jfrom_hf_model(hf, quant)
    if quant is not None:
        jp = jparams_to_native(jp, force=True, min_elems=0)
    port, cfg = from_hf_model(hf, quant, device="cpu")
    bridged = params_from_numpy(jax_tree_to_numpy(jp), cfg, "cpu")
    return quant, jp, jcfg, bridged, port


def _same(a, b):
    a, b = a.state_dict(), b.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _close(out, ref, tol=REL_TOL):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(out, np.float32), ref, rtol=0,
                               atol=tol * np.abs(ref).max())


def test_from_hf_model_equals_bridged_params(pair):
    quant, _, jcfg, bridged, port = pair
    _same(port, bridged)
    cfg = port.cfg
    assert cfg == bridged.cfg and (cfg.arch, cfg.n_experts,
                                   cfg.n_experts_active) == ("mixtral", E, K)
    blk = port.layers[0]
    assert blk.router.cfg is None and blk.router.weight.shape == (128, E) \
        and blk.router.weight.dtype == torch.bfloat16
    ex = blk.experts
    assert ex.quantized == (quant is not None) and not ex.biased
    if quant is None:
        assert ex.w_down.weight.shape == (E, 256, 128)
    else:
        assert ex.w_gate.qt.planes[0].shape[0] == E
        assert ex.w_down.qt.shape == (256, 128)
    assert not hasattr(blk, "w_gate")


@pytest.mark.parametrize("shape", [(1, 4), (1, 8), (2, 4)],
                         ids=["bt4", "bt8", "b2t4"])
def test_forward_logits_match_jax(pair, shape):
    """Full-sequence logits of one forward: B·T = 4 takes the dense
    mixture; 8 the grouped path with bf16 experts, the dense mixture over
    QTensors at q4_j."""
    _, jp, jcfg, bridged, _ = pair
    ids = np.random.default_rng(sum(shape)).integers(3, VOCAB, shape)
    jl = jbatch_logits(jp, jcfg, ids.astype(np.int32))
    pl = batch_logits(bridged, bridged.cfg, ids.tolist())
    assert pl.shape == (*shape, VOCAB) and torch.isfinite(pl).all()
    _close(pl.numpy(), jl)


def test_decode_steps_and_greedy_ids_match_jax(pair):
    """A 12-token prefill (grouped for bf16 experts), then 6 decode steps
    (the dense mixture) fed JAX's argmax over a bf16 cache; then
    ``Model.generate``'s greedy ids (no penalty) against JAX's up to the
    first step whose top-1/top-2 margin falls below the tolerance."""
    _, jp, jcfg, bridged, _ = pair
    ids = np.random.default_rng(PROMPT_SEED).integers(
        3, VOCAB, T_PROMPT).tolist()
    S = T_PROMPT + N_STEPS + 2
    jc = jinit_cache(jcfg, 1, S)
    pc = init_cache(bridged.cfg, 1, S, device="cpu")
    jl, jc = jmodel_step(jp, jnp.asarray([ids], jnp.int32),
                         jnp.zeros((1,), jnp.int32), jc, jcfg)
    pl = model_step(bridged, torch.tensor([ids]),
                    torch.zeros(1, dtype=torch.long), pc)
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
    out = Model().init_params(bridged, bridged.cfg).generate(
        ids, max_new_tokens=N_STEPS, do_sample=False, stop_at_eos=False,
        repetition_penalty=1.0)[0]
    assert out[:T_PROMPT] == ids and len(out) == T_PROMPT + N_STEPS
    safe = next((i for i, (m, scale) in enumerate(margins)
                 if m < REL_TOL * scale), len(margins))
    assert safe >= 4, margins
    assert out[T_PROMPT:T_PROMPT + safe] == jnew[:safe], (out, jnew, margins)


# --------------------------------------------------------------------- grok

GROK = dict(L=2, D=256, H=2, Hkv=1, V=96, I=128, mult=0.08838834764831845,
            scale=78.38367176906169)


def _grok_sd():
    """``test_zoo_oracles.py``'s Grok checkpoint, widened to head dim 128."""
    g = GROK
    L, D, H, Hkv, V, I = g["L"], g["D"], g["H"], g["Hkv"], g["V"], g["I"]
    Dh = D // H
    shapes = {"model.embed_tokens.weight": (V, D),
              "model.norm.weight": [(D,)], "lm_head.weight": (V, D)}
    for i in range(L):
        p = f"model.layers.{i}."
        shapes.update({
            p + "attn.q_proj.weight": (H * Dh, D),
            p + "attn.k_proj.weight": (Hkv * Dh, D),
            p + "attn.v_proj.weight": (Hkv * Dh, D),
            p + "attn.o_proj.weight": (D, H * Dh),
            p + "moe_block.gate.weight": (E, D),
            p + "pre_attn_norm.weight": [(D,)],
            p + "post_attn_norm.weight": [(D,)],
            p + "pre_moe_norm.weight": [(D,)],
            p + "post_moe_norm.weight": [(D,)],
        })
        for e in range(E):
            ep = p + f"moe_block.experts.{e}."
            shapes.update({ep + "linear.weight": (I, D),
                           ep + "linear_v.weight": (I, D),
                           ep + "linear_1.weight": (D, I)})
    sd = rsd(shapes, 13)
    hf_cfg = Obj(model_type="grok-1", vocab_size=V, hidden_size=D,
                 num_hidden_layers=L, num_attention_heads=H,
                 num_key_value_heads=Hkv, intermediate_size=I,
                 rms_norm_eps=1e-6, num_experts=E, num_experts_per_tok=K,
                 attn_output_multiplier=g["mult"],
                 embedding_multiplier_scale=g["scale"],
                 max_position_embeddings=2048)
    return sd, hf_cfg


def _grok_oracle(sd, toks):
    """``test_zoo_oracles.py test_grok_moe_golden``'s numpy oracle (f64)."""
    g = GROK
    L, D, H, Hkv = g["L"], g["D"], g["H"], g["Hkv"]
    Dh = D // H
    w = lambda k: np.asarray(sd[k], np.float64)
    T = len(toks)
    x = w("model.embed_tokens.weight")[toks] * g["scale"]
    pos = np.arange(T)
    for i in range(L):
        p = f"model.layers.{i}."
        h = rmsnorm(x, w(p + "pre_attn_norm.weight"))
        q = rope_neox((h @ w(p + "attn.q_proj.weight").T
                       ).reshape(T, H, Dh), pos)
        k = rope_neox((h @ w(p + "attn.k_proj.weight").T
                       ).reshape(T, Hkv, Dh), pos)
        v = (h @ w(p + "attn.v_proj.weight").T).reshape(T, Hkv, Dh)
        ctx = attn(q, k, v, Hkv, g["mult"], softcap=30.0)
        a = ctx @ w(p + "attn.o_proj.weight").T
        x = x + rmsnorm(a, w(p + "post_attn_norm.weight"))
        h2 = rmsnorm(x, w(p + "pre_moe_norm.weight"))
        logits = h2 @ w(p + "moe_block.gate.weight").T
        top = np.argsort(-logits, axis=-1)[:, :K]
        moe = np.zeros_like(h2)
        for t in range(T):
            lg = logits[t, top[t]]
            wts = np.exp(lg - lg.max())
            wts = wts / wts.sum()
            for j, e in enumerate(top[t]):
                ep = p + f"moe_block.experts.{e}."
                m = gelu_tanh(h2[t] @ w(ep + "linear.weight").T) * (
                    h2[t] @ w(ep + "linear_v.weight").T)
                moe[t] += wts[j] * (m @ w(ep + "linear_1.weight").T)
        x = x + rmsnorm(moe, w(p + "post_moe_norm.weight"))
    ref = rmsnorm(x, w("model.norm.weight")) @ w("lm_head.weight").T
    return 30.0 * np.tanh(ref / 30.0)


@pytest.fixture(scope="module")
def grok():
    sd, hf_cfg = _grok_sd()
    mod = family(hf_cfg.model_type)
    cfg = mod.config_from_hf(hf_cfg)
    jmod = JARCH[hf_cfg.model_type]
    jcfg = jmod.config_from_hf(hf_cfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    port = build_params(dict(sd), cfg, mod, quant=None, dtype=torch.float32,
                        device="cpu")
    jp = jbuild_params(dict(sd), jcfg, jmod, quant=None, dtype=jnp.float32)
    _same(port, params_from_numpy(jax_tree_to_numpy(jp), cfg, "cpu"))
    return sd, cfg, port, jcfg, jp


@pytest.mark.parametrize("T", [5, 8])
def test_grok_against_oracle_and_jax(grok, T):
    sd, cfg, port, jcfg, jp = grok
    assert (cfg.arch, cfg.act, cfg.attn_softcap, cfg.logit_softcap) == \
        ("grok", "gelu_tanh", 30.0, 30.0)
    assert cfg.post_attn_norm and cfg.post_ffn_norm and \
        cfg.attn_scale == GROK["mult"] and cfg.head_dim == 128
    toks = [4, 61, 2, 19, 8, 33, 70, 11][:T]
    jl, _ = jmodel_step(jp, jnp.asarray([toks], jnp.int32),
                        jnp.zeros((1,), jnp.int32), jinit_cache(jcfg, 1, 16),
                        jcfg)
    pl = model_step(port, torch.tensor([toks]),
                    torch.zeros(1, dtype=torch.long),
                    init_cache(cfg, 1, 16, device="cpu"))[0].numpy()
    oracle = _grok_oracle(sd, toks)
    np.testing.assert_allclose(pl, oracle, rtol=0,
                               atol=RTOL * np.abs(oracle).max())
    _close(pl, np.asarray(jl[0], np.float32))


# ------------------------------------------------------------------ pieces

TINY = dict(arch="mixtral", vocab_size=128, hidden_size=128, n_layers=2,
            n_heads=2, n_kv_heads=1, head_dim=64, intermediate_size=128,
            n_experts=E, n_experts_active=K, max_seq_len=64, eos_token_id=999)


def _random_pair(kw, quant=None, edit=None):
    """JAX random weights (at rest when quantized), optionally edited, and
    the same tree in the port: (jax params, jax cfg, port decoder)."""
    jcfg, cfg = JMC(**kw), ModelConfig(**kw)
    jp = jinit_random(jcfg, quant=quant)
    if quant is not None:
        jp = jparams_to_native(jp, force=True, min_elems=0)
    if edit is not None:
        jp = edit(jp)
    return jp, jcfg, params_from_numpy(jax_tree_to_numpy(jp), cfg, "cpu")


@pytest.mark.parametrize("T", [4, 8])
def test_full_softmax_weights_match_jax(T):
    """``moe_norm_topk=False``: the softmax over every expert's logit,
    gathered at the chosen ones (no family of either package sets it)."""
    jp, jcfg, port = _random_pair({**TINY, "moe_norm_topk": False})
    ids = np.random.default_rng(T).integers(3, 128, (1, T))
    _close(batch_logits(port, port.cfg, ids.tolist()).numpy(),
           jbatch_logits(jp, jcfg, ids.astype(np.int32)))
    logits = torch.randn(6, E)
    w, idx = moe_route(logits, K, False)
    torch.testing.assert_close(
        w, torch.softmax(logits, -1).gather(-1, idx), rtol=0, atol=0)


def test_router_ties_take_the_lower_index_as_jax():
    """Router logits are bf16 values before their f32 cast, so ties among
    experts are common: ``moe_route`` must pick as ``jax.lax.top_k`` does
    (the lower index first on a tie)."""
    rng = np.random.default_rng(0)
    logits = rng.integers(-2, 3, (256, 8)).astype(np.float32) * 0.5
    jw, jidx = jax.lax.top_k(jnp.asarray(logits), 2)
    w, idx = moe_route(torch.from_numpy(logits), 2, True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(
        w.numpy(), np.asarray(jax.nn.softmax(jw, axis=-1)), rtol=1e-6)
    assert (logits[:, None, :] == logits[:, :, None]).sum() > 256 * 8


@pytest.mark.parametrize("T", [4, 8])
def test_tied_router_columns_match_jax(T):
    """A model whose router gives experts 1 and 2 one column (their logits
    tie in every row): the port routes every row as JAX does."""
    def tie(jp):
        r = jp["layers"]["router"]
        jp["layers"]["router"] = r.at[..., 2].set(r[..., 1])
        return jp
    jp, jcfg, port = _random_pair(TINY, edit=tie)
    w = port.layers[0].router.weight
    assert torch.equal(w[:, 1], w[:, 2])
    ids = np.random.default_rng(3).integers(3, 128, (1, T))
    _close(batch_logits(port, port.cfg, ids.tolist()).numpy(),
           jbatch_logits(jp, jcfg, ids.astype(np.int32)))


def test_grouped_static_form_equals_eager_form():
    """The grouped path's capture-safe form (a fixed capacity of B·T rows an
    expert) against its eager form (group sizes read on the host), on a
    2-layer model's experts: the same rows through the same per-expert
    products, so the same outputs up to the products' f32 sum order."""
    cfg = ModelConfig(**TINY)
    model = init_random(cfg, quant=None, device="cpu")
    ex = model.layers[0].experts
    gen = torch.Generator().manual_seed(0)
    for B, T in ((1, 8), (8, 1), (3, 7)):
        x = torch.randn((B, T, 128), generator=gen).bfloat16()
        logits = torch.randn((B, T, E), generator=gen)
        w, idx = moe_route(logits, K, True)
        args = (x, ex, w, idx, cfg, ACTS[cfg.act])
        eager = moe_grouped(*args, static=False)
        static = moe_grouped(*args, static=True)
        assert eager.shape == (B, T, 128) and eager.dtype == torch.bfloat16
        torch.testing.assert_close(static.float(), eager.float(), rtol=0,
                                   atol=1e-2 * eager.abs().max().item())
        # and against the dense mixture over the same experts
        mix = torch.zeros_like(logits).scatter_(-1, idx, w)
        dense = sum(ex.mlp(e, x, cfg, ACTS[cfg.act]).float()
                    * mix[..., e:e + 1] for e in range(E))
        torch.testing.assert_close(eager.float(), dense, rtol=0,
                                   atol=2e-2 * dense.abs().max().item())


def test_experts_are_not_ffn_padded():
    """The JAX ``build_params`` pads the plain FFN names only: at q4_0
    (group 32) an FFN of 992 pads the dense gate/up/down to 1024 but leaves
    every expert at 992, in both packages."""
    kw = {**TINY, "intermediate_size": 992}
    model = init_random(ModelConfig(**kw), quant="q4_0", device="cpu")
    ex = model.layers[1].experts
    assert ex.w_gate.qt.shape == (128, 992) and \
        ex.w_down.qt.shape == (992, 128)
    jp = jinit_random(JMC(**kw), quant="q4_0")
    assert jp["layers"]["experts"]["w_down"].K == 992
    dense = init_random(ModelConfig(**{**kw, "n_experts": 0,
                                       "n_experts_active": 0}),
                        quant="q4_0", device="cpu")
    assert dense.layers[0].w_down.qt.shape == (1024, 128)


# --------------------------------------------------------------- scheduler

SCHED_OPTS = dict(max_batch=8, max_len=64, prefill_buckets=(8, 16, 32),
                  prefill_chunk=16)


def _prompts(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, 128, int(rng.integers(lo, hi)))))
            for _ in range(n)]


@pytest.mark.parametrize("quant,mode", [
    ("q4_j", "slots"), ("q4_j", "paged"), (None, "paged")],
    ids=["q4_j-slots", "q4_j-paged", "bf16-paged"])
def test_scheduler_matches_generate(quant, mode):
    """The port's Scheduler on the tiny Mixtral (8 slots, chunked prefill,
    in paged mode an undersized pool): each of 12 requests' ids against the
    port's greedy generation of the same prompt; with bf16 experts the
    batched decode step (8 rows) and the prefill chunks (8-16 rows) take
    the grouped path, the references' decode steps the dense mixture. The
    references share one cache size, so their decode steps share their
    shapes."""
    cfg = ModelConfig(**TINY)
    params = init_random(cfg, seed=3, quant=quant, device="cpu")
    prompts = _prompts(5, 12, 3, 30)
    ref = [greedy_generate(params, cfg, p, max_new_tokens=6, max_len=64,
                           stop_at_eos=False)[len(p):] for p in prompts]
    opts = dict(kv_mode="paged", page_size=16, n_pages=10) \
        if mode == "paged" else {}
    sched = Scheduler(params, cfg,
                      sampling=SamplingParams(greedy=True, repeat_penalty=1.0),
                      kv_dtype=torch.bfloat16, **SCHED_OPTS, **opts)
    for i, p in enumerate(prompts):
        sched.add_request(f"q{i}", p, max_new_tokens=6)
    got = {s.request_id: s.output_ids for s in sched.run_to_completion()}
    exact = sum(got[f"q{i}"] == ref[i] for i in range(12))
    assert exact >= 10, [(i, got[f"q{i}"], ref[i]) for i in range(12)
                         if got[f"q{i}"] != ref[i]]


def test_fused_decode_path_norms_outside_the_mixture(monkeypatch):
    """Under the fused decode path (``NTPU_FUSED_DECODE=interpret`` runs it
    on the CPU) a MoE block's attention half still fuses, and its FFN norm
    runs outside the kernels before the routing, as the JAX ``_mlp`` does:
    the decode steps' logits equal the unfused graph's. (Head dim 128: K1
    fuses a product only at 128-column multiples.)"""
    cfg = ModelConfig(**{**TINY, "head_dim": 128})
    params = init_random(cfg, seed=6, quant="q4_j", device="cpu")
    ids = [7, 11, 13, 2, 40, 9, 1, 66, 5]
    rows = []
    for mode in ("0", "interpret"):
        monkeypatch.setenv("NTPU_FUSED_DECODE", mode)
        cache = init_cache(cfg, 1, 16, device="cpu")
        model_step(params, torch.tensor([ids]),
                   torch.zeros(1, dtype=torch.long), cache)
        rows.append([model_step(params, torch.tensor([[t]]),
                                torch.tensor([len(ids) + i]), cache)
                     for i, t in enumerate((3, 8, 21))])
    assert params.layers[0].fusable >= {"wq", "wk", "wv", "wo"}
    for a, b in zip(*rows):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_generation_paths_run_moe():
    """``Model.generate``'s other paths and the ``ModelServer`` take a MoE
    model with no change but the graph's: sampling (``sample_loop``; one
    seed twice gives one sequence), beam search, a batch of ragged prompts,
    StreamingLLM, and the threaded server, whose greedy ids equal the
    port's greedy generation."""
    import time

    from neural_tpu_torch.serving import ModelServer, Query
    cfg = ModelConfig(**TINY)
    params = init_random(cfg, seed=4, quant="q4_j", device="cpu")
    m = Model().init_params(params, cfg)
    ids = [5, 9, 17, 3, 44, 21]
    runs = [m.generate(ids, max_new_tokens=5, do_sample=True, seed=s,
                       stop_at_eos=False)[0] for s in (1, 1)]
    assert runs[0] == runs[1] and len(runs[0]) == len(ids) + 5
    beam = m.generate(ids, max_new_tokens=4, num_beams=3,
                      stop_at_eos=False)[0]
    rows = m.generate([ids, ids[:3]], max_new_tokens=4, stop_at_eos=False)
    stream = m.generate(ids, max_new_tokens=20, streaming=True, max_len=16,
                        stop_at_eos=False)[0]
    assert len(beam) == len(ids) + 4 and [len(r) for r in rows] == [10, 7]
    assert len(stream) == len(ids) + 20
    assert all(0 <= t < 128 for t in beam + rows[0] + rows[1] + stream)
    results = {}

    def cb(done):
        for q in done:
            results[q.request_id] = q.output_ids

    prompts = [[5, 6, 7 + i] for i in range(4)]
    with ModelServer(params, cfg, cb, max_batch=2, max_len=64,
                     sampling=SamplingParams(greedy=True,
                                             repeat_penalty=1.0)) as srv:
        srv.issueQuery([Query(f"q{i}", p, 5) for i, p in enumerate(prompts)])
        t0 = time.time()
        while len(results) < 4 and time.time() - t0 < 120:
            time.sleep(0.05)
    ref = [greedy_generate(params, cfg, p, max_new_tokens=5, max_len=64,
                           stop_at_eos=False)[3:] for p in prompts]
    assert sum(results.get(f"q{i}") == ref[i] for i in range(4)) >= 3, \
        (results, ref)


# ---------------------------------------------------------------- refusals

def test_qwen2_moe_names_the_reference_gap():
    assert set(REFUSED) == {"qwen2_moe", "qwen3"}
    with pytest.raises(NotImplementedError, match="shared-expert"):
        family("qwen2_moe")
    hf_cfg = Obj(model_type="qwen2_moe", vocab_size=64, hidden_size=64)
    with pytest.raises(NotImplementedError, match="num_experts"):
        qwen.config_from_hf(hf_cfg)
    with pytest.raises(KeyError):
        JARCH["qwen2_moe"]
    with pytest.raises(NotImplementedError, match="qkv_bias=True"):
        family("qwen3")


def test_registry_refusals_as_jax():
    """A registry's requantization of experts raises in both packages, and
    so does a registry whose rules for a layer's plain names differ by
    layer; one config requantizes every expert."""
    jp, _, port = _random_pair(TINY, "q4_j")
    rules = dict(rules=[("w_gate", "int8")], default="q4_0")
    with pytest.raises(NotImplementedError, match="MoE experts"):
        jrequantize(jp, JQuantRegistry(**rules))
    with pytest.raises(NotImplementedError, match="MoE experts"):
        requantize(port.param_dict(), QuantRegistry(**rules))
    rules = dict(rules=[("layers.0.wq", "int8")], default="q4_j")
    with pytest.raises(NotImplementedError, match="layer-heterogeneous"):
        jinit_random(JMC(**TINY), quant=JQuantRegistry(**rules))
    with pytest.raises(NotImplementedError, match="layer-heterogeneous"):
        init_random(ModelConfig(**TINY), quant=QuantRegistry(**rules),
                    device="cpu")
    out = requantize(port.param_dict(), "q4_0")
    stack = out["layers"][1]["experts"]["w_up"]
    assert stack.cfg == PRESETS["q4_0"] and stack.planes[0].shape[0] == E


def test_gguf_export_refuses_experts(hf, tmp_path):
    with pytest.raises(NotImplementedError, match="expert"):
        gguf_models.export_gguf(hf, str(tmp_path / "m.gguf"))
