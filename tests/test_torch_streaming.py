"""StreamingLLM in the port against the JAX package: the compact-and-shift of
a full cache (``shift_cache``) against ``shift_cache_impl`` on the same
numpy cache, over the RoPE styles "neox", "gptj" (the cases of
``tests/test_streaming.py``) and "none" (ALiBi, no rotation), bf16 and int8;
then greedy ``stream_generate`` (a cache of 24, 4 sinks, 40 new tokens:
three shifts) on a tiny q4_j Llama carried over by the bridge.

Tolerances: the sinks, the moved values and their scales and the zeroed
tail are equal exactly. Moved keys are rotated in f32 by cos/sin of the
same f32 angles, which torch and XLA may round an ulp apart, so a bf16 key
may land one bf16 step (at most 2^-7 relative) away; int8 codes one step,
their bf16 scales one bf16 step. Each stream step's logits (both packages
teacher-forced on JAX's ids) within 3e-2·max|logit|, the model tolerance
of ``tests/test_torch_model.py``; greedy ids equal step by step, parting
only at a step whose JAX margin does not exceed twice that step's logit
difference (38 of the 40 steps are proven on this model).
"""
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax.numpy as jnp

from neural_tpu.api import Model as JModel
from neural_tpu.models.config import ModelConfig as JMC
from neural_tpu.runtime.generate import model_step as jmodel_step
from neural_tpu.runtime.generate import params_to_native as jparams_to_native
from neural_tpu.runtime.kvcache import KVCache as JKV
from neural_tpu.runtime.kvcache import init_cache as jinit_cache
from neural_tpu.runtime.streaming import shift_cache as jshift_cache
from neural_tpu.runtime.streaming import shift_cache_impl
from neural_tpu.runtime.streaming import stream_generate as jstream_generate

from neural_tpu_torch.api import Model
from neural_tpu_torch.convert.from_jax import params_from_numpy
from neural_tpu_torch.convert.hf import from_hf_model
from neural_tpu_torch.models.config import ModelConfig
from neural_tpu_torch.ops.rope import rope_freqs
from neural_tpu_torch.runtime.generate import model_step
from neural_tpu_torch.runtime.kvcache import KVCache, init_cache
from neural_tpu_torch.runtime.streaming import shift_cache, stream_generate
from test_torch_bridge import jax_tree_to_numpy

REL_TOL = 3e-2
L, H, S, DH = 2, 2, 16, 16
N_KEEP, N_DISCARD = 4, 6


def _cfgs(style):
    kw = dict(arch="llama", vocab_size=128, hidden_size=64, n_layers=L,
              n_heads=4, n_kv_heads=H, head_dim=DH, intermediate_size=128,
              max_seq_len=256, rope_style=style, eos_token_id=999)
    return JMC(**kw), ModelConfig(**kw)


def _cache(int8, seed):
    rng = np.random.default_rng(seed)
    shape = (L, 1, H, S, DH)
    if int8:
        k, v = (rng.integers(-127, 128, shape).astype(np.int8)
                for _ in range(2))
        ks, vs = ((rng.random(shape[:-1]) * 0.05 + 0.01).astype(np.float32)
                  for _ in range(2))
        j = JKV(jnp.asarray(k), jnp.asarray(v), jnp.asarray(ks, jnp.bfloat16),
                jnp.asarray(vs, jnp.bfloat16))
        p = KVCache(torch.from_numpy(k), torch.from_numpy(v),
                    torch.from_numpy(ks).bfloat16(),
                    torch.from_numpy(vs).bfloat16())
        return j, p
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    j = JKV(jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
            None, None)
    p = KVCache(torch.from_numpy(k).bfloat16(),
                torch.from_numpy(v).bfloat16())
    return j, p


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("style", ["neox", "gptj", "none"])
def test_shift_cache_matches_jax(style, int8):
    jcfg, cfg = _cfgs(style)
    inv = rope_freqs(DH, None, 10000.0)
    jc, pc = _cache(int8, seed=hash(style) % 1000)
    ref = shift_cache_impl(jc, jnp.asarray(inv), jcfg, N_KEEP, N_DISCARD)
    ptrs = [t.data_ptr() for t in (pc.k, pc.v)]
    out = shift_cache(pc, torch.from_numpy(inv), cfg, N_KEEP, N_DISCARD)
    # in place: the same storage, as a captured decode graph needs
    assert [t.data_ptr() for t in (out.k, out.v)] == ptrs
    k, rk = _f32(out.k), _f32(ref.k)
    moved = slice(N_KEEP, S - N_DISCARD)
    np.testing.assert_array_equal(k[..., :N_KEEP, :], rk[..., :N_KEEP, :])
    np.testing.assert_array_equal(k[..., S - N_DISCARD:, :], 0)
    np.testing.assert_array_equal(_f32(out.v), _f32(ref.v))
    if int8:
        np.testing.assert_array_equal(_f32(out.v_scale), _f32(ref.v_scale))
        assert np.abs(k - rk).max() <= 1
        ks, rks = _f32(out.k_scale), _f32(ref.k_scale)
        np.testing.assert_allclose(ks, rks, rtol=2 ** -7, atol=0)
        if style == "none":
            np.testing.assert_array_equal(k, rk)
            np.testing.assert_array_equal(ks, rks)
    else:
        np.testing.assert_allclose(k[..., moved, :], rk[..., moved, :],
                                   rtol=2 ** -7, atol=1e-6)
        if style == "none":
            np.testing.assert_array_equal(k, rk)


@pytest.fixture(scope="module")
def pair():
    hc = transformers.LlamaConfig(
        vocab_size=256, hidden_size=128, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
        max_position_embeddings=256, rms_norm_eps=1e-5, eos_token_id=999)
    torch.manual_seed(3)
    hf = transformers.LlamaForCausalLM(hc).eval()
    jm = JModel().init_from_hf_model(hf, "q4_j")
    jm.params = jparams_to_native(jm.params, force=True, min_elems=0)
    _, cfg = from_hf_model(hf, "q4_j", device="cpu")
    pm = Model().init_params(
        params_from_numpy(jax_tree_to_numpy(jm.params), cfg, "cpu"), cfg)
    return jm, pm


MAX_LEN, N_NEW = 24, 40
PROMPT = list(range(7, 15))


def _stream_rows(step, shift, ids, new, n_discard):
    """The logits row [V] (f32) at each step of a greedy stream fed ``new``
    after ``ids``: ``step(tokens, pos)`` evaluates, ``shift()`` compacts
    the full cache, as ``stream_generate`` orders them."""
    rows = [step(ids, 0)]
    pos = len(ids)
    for tok in new[:-1]:
        if pos >= MAX_LEN:
            shift()
            pos -= n_discard
        rows.append(step([tok], pos))
        pos += 1
    return rows


def _jax_rows(jm, ids, new, n_discard):
    cfg, params = jm.cfg, jm.params
    st = {"cache": jinit_cache(cfg, 1, MAX_LEN)}

    def step(toks, pos):
        logits, st["cache"] = jmodel_step(
            params, jnp.asarray([toks], jnp.int32),
            jnp.asarray([pos], jnp.int32), st["cache"], cfg)
        return np.asarray(logits[0, -1], np.float32)

    def shift():
        st["cache"] = jshift_cache(st["cache"], params["rope_inv_freqs"],
                                   cfg, 4, n_discard)
    return _stream_rows(step, shift, ids, new, n_discard)


def _port_rows(pm, ids, new, n_discard):
    cache = init_cache(pm.cfg, 1, MAX_LEN, device="cpu")

    def step(toks, pos):
        logits = model_step(pm.params, torch.tensor([toks]),
                            torch.tensor([pos]), cache)
        return logits[0, -1].numpy()

    def shift():
        shift_cache(cache, pm.params.rope_inv_freqs, pm.cfg, 4, n_discard)
    return _stream_rows(step, shift, ids, new, n_discard)


def test_stream_generate_greedy_matches_jax(pair):
    """bf16 KV. Each step's logits, both packages teacher-forced on JAX's
    ids through the same shifts, within the model tolerance; where JAX's
    top-1/top-2 margin exceeds twice the step's largest logit difference
    the argmax is proven the same. The ids must agree step by step; they
    may part only at a step not proven, and the comparison stops there."""
    jm, pm = pair
    n_discard = (MAX_LEN - 4) // 2
    jout = jstream_generate(jm.params, jm.cfg, PROMPT, N_NEW, MAX_LEN,
                            n_keep=4)
    pout = stream_generate(pm.params, pm.cfg, PROMPT, N_NEW, MAX_LEN,
                           n_keep=4)
    assert len(pout) == len(jout) == len(PROMPT) + N_NEW
    jnew, pnew = jout[len(PROMPT):], pout[len(PROMPT):]
    jrows = _jax_rows(jm, PROMPT, jnew, n_discard)
    prows = _port_rows(pm, PROMPT, jnew, n_discard)
    compared = proven = 0
    for t, (j, p) in enumerate(zip(jrows, prows)):
        np.testing.assert_allclose(p, j, rtol=0,
                                   atol=REL_TOL * np.abs(j).max())
        top = np.sort(j)
        sure = top[-1] - top[-2] > 2 * np.abs(p - j).max()
        if pnew[t] != jnew[t]:
            assert not sure, (t, pnew, jnew)
            break
        compared += 1
        proven += sure
    # past the second shift (before the 27th new token), most steps proven
    assert compared > MAX_LEN - len(PROMPT) + n_discard, (compared, pnew,
                                                          jnew)
    assert proven >= compared * 3 // 4, (proven, compared)


def test_stream_generate_int8_matches_jax_until_the_first_shift(pair):
    """int8 KV: the ids up to the first shift equal JAX's, and the run
    goes on through its shifts to the full length."""
    jm, pm = pair
    jout = jstream_generate(jm.params, jm.cfg, PROMPT, N_NEW, MAX_LEN,
                            n_keep=4, kv_dtype="int8")
    pout = stream_generate(pm.params, pm.cfg, PROMPT, N_NEW, MAX_LEN,
                           n_keep=4, kv_dtype=torch.int8)
    assert len(pout) == len(jout) == len(PROMPT) + N_NEW
    first = MAX_LEN - len(PROMPT)
    assert pout[:len(PROMPT) + first] == jout[:len(PROMPT) + first]
