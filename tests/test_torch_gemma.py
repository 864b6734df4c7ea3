"""Gemma and Gemma-2 end to end on the CPU: tiny HF models (built locally
from random configs, as ``tests/test_zoo_golden.py`` builds them) converted
by both packages at q4_j, run through both.

Three models: Gemma-2 at head dim 256 with ``query_pre_attn_scalar`` equal
to it (Gemma-2-9B's ratio), Gemma-2 at head dim 128 with
``query_pre_attn_scalar`` 64 (an attention scale other than head_dim^-0.5),
and Gemma 1. The Gemma-2 models have a sliding window of 8 on their even
layer, the attention softcap 50 and the final softcap 30; every prompt is
longer than the window, so the sliding layer masks.

Tolerances, as ``test_torch_model.py`` states them for the Llama twin:
logits within 3e-2·max|ref| (bf16 activations rounded at other places in
the two packages; measured at most 9.4e-3 here), greedy ids equal up to the
first step where JAX's penalized top-2 margin falls below that tolerance.
Params are compared leaf for leaf, exactly.
"""
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from neural_tpu.api import Model as JModel  # noqa: E402
from neural_tpu.convert.hf import init_random as jinit_random  # noqa: E402
from neural_tpu.models.config import ModelConfig as JMC  # noqa: E402
from neural_tpu.runtime.generate import (  # noqa: E402
    model_step as jmodel_step, params_to_native as jparams_to_native)
from neural_tpu.runtime.kvcache import init_cache as jinit_cache  # noqa: E402

from neural_tpu_torch.api import Model  # noqa: E402
from neural_tpu_torch.convert.from_jax import params_from_numpy  # noqa: E402
from neural_tpu_torch.convert.hf import from_hf_model, init_random  # noqa: E402
from neural_tpu_torch.models.config import ModelConfig  # noqa: E402
from neural_tpu_torch.runtime.generate import model_step  # noqa: E402
from neural_tpu_torch.runtime.kvcache import init_cache  # noqa: E402
from test_torch_bridge import jax_tree_to_numpy  # noqa: E402
from test_torch_kv8 import _jax_margins_i8  # noqa: E402
from test_torch_model import _jax_margins  # noqa: E402

VOCAB = 256
REL_TOL = 3e-2
WINDOW = 8
T_PROMPT = 20


def _hf(kind):
    t = transformers
    torch.manual_seed(0)
    common = dict(vocab_size=VOCAB, hidden_size=256, num_hidden_layers=2,
                  intermediate_size=512, max_position_embeddings=512)
    if kind == "gemma":
        return t.GemmaForCausalLM(t.GemmaConfig(
            num_attention_heads=2, num_key_value_heads=1, head_dim=128,
            **common)).eval()
    hd = 256 if kind == "gemma2_hd256" else 128
    return t.Gemma2ForCausalLM(t.Gemma2Config(
        num_attention_heads=2 if hd == 256 else 4,
        num_key_value_heads=1 if hd == 256 else 2, head_dim=hd,
        attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
        query_pre_attn_scalar=256 if hd == 256 else 64,
        sliding_window=WINDOW, **common)).eval()


KINDS = ["gemma2_hd256", "gemma2_qpas64", "gemma"]


@pytest.fixture(scope="module", params=KINDS)
def pair(request):
    """(kind, JAX Model, port Model on the bridged tree, port decoder
    from ``from_hf_model``)."""
    hf = _hf(request.param)
    jm = JModel().init_from_hf_model(hf, "q4_j")
    jm.params = jparams_to_native(jm.params, force=True, min_elems=0)
    port, cfg = from_hf_model(hf, "q4_j", device="cpu")
    bridged = params_from_numpy(jax_tree_to_numpy(jm.params), cfg, "cpu")
    return request.param, jm, Model().init_params(bridged, cfg), port


def test_from_hf_model_equals_bridged_params(pair):
    kind, jm, pm, port = pair
    a, b = port.state_dict(), pm.params.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k
    cfg = port.cfg
    assert cfg == pm.cfg and cfg.arch == jm.cfg.arch
    assert cfg.attn_scale == jm.cfg.attn_scale
    assert port.lm_head is None                     # tied embeddings
    if kind == "gemma":
        assert "layers.0.use_sliding" not in a
        assert [blk.window for blk in port.layers] == [0, 0]
    else:
        assert [bool(a[f"layers.{i}.use_sliding"]) for i in range(2)] == \
            [True, False]
        assert [blk.window for blk in port.layers] == [WINDOW, 0]
        assert "layers.1.post_ffn_norm_w" in a
    # sqrt(256) = 16, exact in bf16
    assert port.embed_scale == 16.0


def _close(out, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(out, np.float32), ref, rtol=0,
                               atol=REL_TOL * np.abs(ref).max())


def _prompt():
    return np.random.default_rng(1).integers(3, VOCAB, T_PROMPT).tolist()


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_forward_logits(pair, kv):
    """Every row of a 20-token prompt, then 5 decode steps fed the same
    tokens, over bf16 and int8 caches."""
    _, jm, pm, _ = pair
    ids, S = _prompt(), T_PROMPT + 8
    jc = jinit_cache(jm.cfg, 1, S, "int8" if kv == "int8" else jnp.bfloat16)
    pc = init_cache(pm.cfg, 1, S, torch.int8 if kv == "int8"
                    else torch.bfloat16, device="cpu")
    jl, jc = jmodel_step(jm.params, jnp.asarray([ids], jnp.int32),
                         jnp.zeros((1,), jnp.int32), jc, jm.cfg)
    pl = model_step(pm.params, torch.tensor([ids]),
                    torch.zeros(1, dtype=torch.long), pc)
    assert pl.shape == (1, T_PROMPT, VOCAB)
    _close(pl.numpy(), jl)
    tok = int(np.argmax(np.asarray(jl)[0, -1]))
    for s in range(5):
        jl, jc = jmodel_step(jm.params, jnp.asarray([[tok]], jnp.int32),
                             jnp.asarray([T_PROMPT + s], jnp.int32), jc,
                             jm.cfg)
        pl = model_step(pm.params, torch.tensor([[tok]]),
                        torch.tensor([T_PROMPT + s]), pc)
        _close(pl.numpy(), jl)
        tok = int(np.argmax(np.asarray(jl)[0, -1]))


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_generate_greedy_ids_match_jax(pair, kv):
    _, jm, pm, _ = pair
    ids, n_new = _prompt(), 8
    jout = jm.generate(ids, max_new_tokens=n_new, do_sample=False,
                       stop_at_eos=False, kv_dtype=kv)[0]
    pout = pm.generate(ids, max_new_tokens=n_new, do_sample=False,
                       stop_at_eos=False, kv_dtype=kv)[0]
    assert pout[:T_PROMPT] == ids and len(pout) == T_PROMPT + n_new
    jnew, pnew = jout[T_PROMPT:], pout[T_PROMPT:]
    margins = (_jax_margins_i8 if kv == "int8" else _jax_margins)(
        jm, ids, jnew)
    safe = next((i for i, (m, scale) in enumerate(margins)
                 if m < REL_TOL * scale), len(margins))
    assert safe >= 2, margins
    assert pnew[:safe] == jnew[:safe], (pnew, jnew, margins)


GEMMA2_KW = dict(arch="gemma2", vocab_size=128, hidden_size=128, n_layers=3,
                 n_heads=2, n_kv_heads=1, head_dim=256,
                 intermediate_size=256, norm_eps=1e-6, norm_offset=1.0,
                 act="gelu_tanh", post_attn_norm=True, post_ffn_norm=True,
                 attn_softcap=50.0, logit_softcap=30.0, attn_scale=1 / 16,
                 sliding_window=WINDOW, embed_scale=float(np.sqrt(128)),
                 tie_word_embeddings=True, max_seq_len=256,
                 eos_token_id=999)


def test_bridge_stacked_and_per_layer_gemma2_trees():
    """A JAX Gemma-2 tree crosses the bridge with its ``use_sliding`` leaf,
    stacked [L] or per layer, and both build the same model."""
    jparams = jinit_random(JMC(**GEMMA2_KW), seed=3, quant="q4_j")
    assert np.asarray(jparams["layers"]["use_sliding"]).tolist() == \
        [True, False, True]
    stacked = jax_tree_to_numpy(jparams)
    per_layer = dict(stacked)
    per_layer["layers"] = [
        jax_tree_to_numpy(jax.tree.map(lambda a: a[i], jparams["layers"]))
        for i in range(3)]
    cfg = ModelConfig(**GEMMA2_KW)
    ma = params_from_numpy(stacked, cfg, "cpu")
    mb = params_from_numpy(per_layer, cfg, "cpu")
    a, b = ma.state_dict(), mb.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k
    assert a["layers.0.use_sliding"].dtype == torch.bool
    assert [blk.window for blk in ma.layers] == [WINDOW, 0, WINDOW]


def test_init_random_gemma2():
    """The port's random Gemma-2: norm weights with w + 1 = 1, the post
    norms, the sliding flags, no lm_head; a prompt past the window runs to
    finite logits under the final softcap."""
    cfg = ModelConfig(**GEMMA2_KW)
    model = init_random(cfg, seed=0, quant="q4_j", device="cpu")
    sd = model.state_dict()
    assert model.lm_head is None and "lm_head" not in "".join(sd)
    for name in ("attn_norm_w", "post_attn_norm_w", "ffn_norm_w",
                 "post_ffn_norm_w"):
        assert torch.equal(sd[f"layers.2.{name}"],
                           torch.zeros(128, dtype=torch.bfloat16)), name
    assert torch.equal(sd["final_norm_w"], torch.zeros(128))
    assert [blk.window for blk in model.layers] == [WINDOW, 0, WINDOW]
    ids = list(range(3, 3 + 2 * WINDOW))
    out = Model().init_params(model, cfg).generate(
        ids, max_new_tokens=3, do_sample=False, stop_at_eos=False)[0]
    assert len(out) == len(ids) + 3
    cache = init_cache(cfg, 1, 32, device="cpu")
    logits = model_step(model, torch.tensor([ids]),
                        torch.zeros(1, dtype=torch.long), cache)
    assert torch.isfinite(logits).all()
    assert logits.abs().max() <= 30.0
