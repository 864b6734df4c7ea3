"""The port's cache-less forward and its gradients against the JAX package:
the twins of ``tests/test_parallel_axes.py``'s ``test_nocache_*``, one
device's autograd against ``jax.grad``, and the refusals that keep the
training graph off the kernels.

The JAX side runs ``forward(params, tokens, start, None, cfg)`` on tiny f32
models from its ``init_random``; the same weights cross to the port through
``convert.from_jax``. Activations are bf16 in both.

Tolerances: logits within 2e-2 (atol and rtol), as the JAX test holds its
cache-less forward to its cached one; the port's cache-less forward equals
its own cached prefill exactly on the CPU (the plain attention there is the
same f32 softmax over the same keys). Gradients within ``GRAD_TOL`` =
2e-2·max|grad| of each leaf: both packages round the activations to bf16 at
the same places, but the f32 sums of the backward run in other orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_tpu.convert import init_random as jinit_random
from neural_tpu.models.config import ModelConfig as JModelConfig
from neural_tpu.models.transformer import forward as jforward

from neural_tpu_torch.convert.from_jax import params_from_numpy
from neural_tpu_torch.core.dtypes import PRESETS
from neural_tpu_torch.core.qtensor import quantize, to_native
from neural_tpu_torch.models.config import ModelConfig
from neural_tpu_torch.models.transformer import Transformer
from neural_tpu_torch.ops import attention as A
from neural_tpu_torch.ops import norms as N
from neural_tpu_torch.ops import paged_attention as PA
from neural_tpu_torch.ops import qmatmul as Q
from neural_tpu_torch.parallel import (make_mesh, make_moe_train_step,
                                       make_pp_train_step)
from neural_tpu_torch.parallel.pp import cross_entropy
from neural_tpu_torch.runtime.kvcache import init_cache

from test_torch_bridge import jax_tree_to_numpy

GRAD_TOL = 2e-2
TOKENS = [[5, 9, 2, 7, 33, 1, 8, 20]] * 2


def tiny_cfg(**kw):
    base = dict(arch="llama", vocab_size=256, hidden_size=128, n_layers=2,
                n_heads=8, n_kv_heads=4, head_dim=16, intermediate_size=256,
                max_seq_len=64)
    base.update(kw)
    return JModelConfig(**base)


CFGS = {
    "llama": tiny_cfg(),
    # test_parallel_axes.py:49's MPT: ALiBi, no RoPE, LayerNorm, GELU
    "mpt_alibi": tiny_cfg(arch="mpt", use_alibi=True, rope_style="none",
                          mlp_gated=False, act="gelu",
                          norm_type="layernorm"),
    "llama_window": tiny_cfg(sliding_window=3),
}


def _pair(key):
    cfg = CFGS[key]
    params = jinit_random(cfg, quant=None, dtype=jnp.float32)
    pcfg = ModelConfig(**dataclasses.asdict(cfg))
    return cfg, params, pcfg, params_from_numpy(jax_tree_to_numpy(params),
                                                pcfg, "cpu")


@pytest.mark.parametrize("key", list(CFGS))
def test_nocache_forward_matches_cached_and_jax(key):
    cfg, params, pcfg, model = _pair(key)
    B = 1 if key == "mpt_alibi" else 2
    toks = np.asarray(TOKENS[:B], np.int32)
    jt = jnp.asarray(toks)
    ref, cache = jforward(params, jt, jnp.zeros((B,), jnp.int32), None, cfg)
    assert cache is None
    t = torch.tensor(toks)
    st = torch.zeros(B, dtype=torch.long)
    with torch.no_grad():
        got = model(t, st, None)
        cached = model(t, st, init_cache(pcfg, B, 32, device="cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-2,
                               rtol=2e-2)
    np.testing.assert_array_equal(got.numpy(), cached.numpy())


def test_nocache_window_masks_far_keys():
    """The window cuts keys more than ``sliding_window`` back: with a window
    of 3 the logits differ from the full causal ones past position 3 and
    equal them before."""
    _, _, pcfg, model = _pair("llama_window")
    full = Transformer(dataclasses.replace(pcfg, sliding_window=0),
                       model.param_dict())
    t = torch.tensor(TOKENS)
    st = torch.zeros(2, dtype=torch.long)
    with torch.no_grad():
        a, b = model(t, st, None), full(t, st, None)
    np.testing.assert_array_equal(a[:, :3].numpy(), b[:, :3].numpy())
    assert (a[:, 3:] - b[:, 3:]).abs().max() > 1e-3


@pytest.fixture(scope="module")
def grads():
    """jax.grad and the port's autograd of the cross-entropy of the
    cache-less forward of the tiny f32 Llama, on the same weights and
    tokens."""
    cfg, params, pcfg, model = _pair("llama")
    toks = np.random.default_rng(3).integers(0, 256, (2, 9), np.int32)
    jt = jnp.asarray(toks)

    def jloss(p):
        logits, _ = jforward(p, jt[:, :-1], jnp.zeros((2,), jnp.int32), None,
                             cfg)
        lp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        return -jnp.take_along_axis(lp, jt[:, 1:, None], axis=-1).mean()

    jval, jg = jax.value_and_grad(jloss)(params)
    pd = model.param_dict()
    leaves = {"embed": pd["embed"], "lm_head": pd["lm_head"],
              "final_norm_w": pd["final_norm_w"]}
    for l, lp in enumerate(pd["layers"]):
        for n in ("wq", "attn_norm_w", "ffn_norm_w"):
            leaves[f"{n}{l}"] = lp[n]
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in leaves.items()}
    for l, lp in enumerate(pd["layers"]):
        for n in ("wq", "attn_norm_w", "ffn_norm_w"):
            lp[n] = leaves[f"{n}{l}"]
    for n in ("embed", "lm_head", "final_norm_w"):
        pd[n] = leaves[n]
    t = torch.tensor(toks)
    loss = cross_entropy(Transformer(pcfg, pd)(
        t[:, :-1], torch.zeros(2, dtype=torch.long), None), t[:, 1:])
    got = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    want = {"embed": jg["embed"], "lm_head": jg["lm_head"],
            "final_norm_w": jg["final_norm_w"]}
    for l in range(cfg.n_layers):
        for n in ("wq", "attn_norm_w", "ffn_norm_w"):
            want[f"{n}{l}"] = jg["layers"][n][l]
    return dict(loss=(float(loss.detach()), float(jval)),
                got={k: v.numpy() for k, v in got.items()},
                want={k: np.asarray(v, np.float32) for k, v in want.items()})


def test_nocache_loss_matches_jax(grads):
    got, want = grads["loss"]
    assert abs(got - want) < 1e-3 * want, (got, want)


@pytest.mark.parametrize("leaf", ["embed", "lm_head", "final_norm_w", "wq0",
                                  "wq1", "attn_norm_w0", "attn_norm_w1",
                                  "ffn_norm_w0", "ffn_norm_w1"])
def test_nocache_grads_match_jax(grads, leaf):
    got, want = grads["got"][leaf], grads["want"][leaf]
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=GRAD_TOL * np.abs(want).max())


# ---------------------------------------------------------------------------
# the training graph keeps off the kernels


def _qt(K=256, N=128, preset="q4_j"):
    w = torch.randn(K, N, generator=torch.Generator().manual_seed(0)) * 0.02
    return to_native(quantize(w, PRESETS[preset]))


def _entries():
    """Each kernel entry, called on CPU tensors one of which requires grad."""
    g = lambda *s: torch.randn(*s).requires_grad_(True)
    qt = _qt()
    x16 = lambda M: g(M, 256).to(torch.bfloat16)
    kv = torch.zeros(1, 2, 16, 128, dtype=torch.bfloat16)
    k8 = torch.zeros(1, 2, 16, 128, dtype=torch.int8)
    sc = torch.ones(1, 2, 16, dtype=torch.bfloat16)
    table = torch.zeros(1, 1, dtype=torch.int32)
    ln = torch.ones(1, dtype=torch.int32)
    q1 = lambda: g(1, 4, 128).to(torch.bfloat16)
    qT = lambda: g(1, 2, 4, 128).to(torch.bfloat16)
    z = torch.zeros(1, dtype=torch.int32)
    return {
        "rms_norm_bf16": lambda: N.rms_norm(x16(2), torch.ones(256)),
        "quantize_act_i8": lambda: Q.act_quant_i8(x16(2), 128),
        "qmm_native (K1)": lambda: Q.qmm_native(
            x16(1), qt.planes[0], qt.scales, None, 128, 4, torch.float32),
        "qmm_native_fused (K1)": lambda: Q.qmm_native_fused(
            x16(1), qt.planes[0], qt.scales, 128, 4, torch.float32,
            norm=(torch.ones(256).requires_grad_(True), 1e-5, 0.0)),
        "qmm_a8 (K2)": lambda: Q.qmm_a8(x16(256), qt.planes[0], qt.scales,
                                        128, 128, torch.float32),
        "qmm_general (K5)": lambda: Q.qmm_general(x16(32), _qt(
            preset="nf4"), torch.float32),
        "flash_prefill (K3)": lambda: A.flash_prefill(qT(), kv, kv, z, 0.1),
        "flash_prefill_i8 (K3)": lambda: A.flash_prefill_i8(
            qT(), k8, k8, sc, sc, z, 0.1),
        "flash_decode (K4)": lambda: A.flash_decode(q1(), kv, kv, ln, 0.1),
        "flash_decode_i8 (K4)": lambda: A.flash_decode_i8(
            q1(), k8, k8, sc, sc, ln, 0.1),
        "paged_decode (K6)": lambda: PA.paged_decode(q1(), kv, kv, table, ln,
                                                     0.1),
        "paged_decode_i8 (K6)": lambda: PA.paged_decode_i8(
            q1(), k8, k8, sc, sc, table, ln, 0.1),
    }


@pytest.mark.parametrize("entry", list(_entries()))
def test_kernel_entry_refuses_a_tensor_that_requires_grad(entry):
    """Every kernel entry raises, naming itself, before it launches or runs
    its plain version: its kernel has no backward, and its output would
    carry no ``grad_fn``."""
    with pytest.raises(ValueError, match="requires grad") as e:
        _entries()[entry]()
    assert str(e.value).startswith(entry)


def test_kernel_entries_run_without_grad():
    """The same calls under ``torch.no_grad`` take the plain version (no
    tensor records a gradient there)."""
    with torch.no_grad():
        for entry, call in _entries().items():
            assert call() is not None, entry


@pytest.mark.parametrize("maker", ["pp", "moe"])
def test_train_steps_refuse_quantized_params(maker):
    """A train step takes DENSE params, as the JAX steps say: a QTensor leaf
    raises ValueError naming it."""
    cfg = ModelConfig(**dataclasses.asdict(CFGS["llama"]))
    model = params_from_numpy(jax_tree_to_numpy(jinit_random(
        CFGS["llama"], quant="q4_0")), cfg, "cpu")
    if maker == "pp":
        mesh = make_mesh(dp=1, pp=1, tp=1, device="cpu")
        make = lambda: make_pp_train_step(model, cfg, mesh, 2)
    else:
        mesh = make_mesh(dp=1, sp=1, ep=1, tp=1, device="cpu")
        make = lambda: make_moe_train_step(model, cfg, mesh)
    with pytest.raises(ValueError, match="DENSE.*layers\\[0\\]\\.wq is a "
                                         "QTensor"):
        make()


def test_one_rank_pp_step_equals_plain_sgd():
    """``make_pp_train_step`` on a one-rank mesh (pp = tp = dp = 1, two
    microbatches) is plain autograd and SGD over the whole batch."""
    from neural_tpu_torch.parallel import pp_shard_params
    _, _, pcfg, model = _pair("llama")
    pcfg4 = pcfg
    params = model.param_dict()
    mesh = make_mesh(dp=1, pp=1, tp=1, device="cpu")
    toks = torch.tensor(np.random.default_rng(4).integers(0, 256, (4, 9)))
    loss, new = make_pp_train_step(params, pcfg4, mesh, 2, lr=1e-2)(
        pp_shard_params(params, pcfg4, mesh), toks)
    leaves = {k: params[k].detach().clone().requires_grad_(True)
              for k in ("embed", "lm_head")}
    pd = dict(params, **leaves)
    ref = cross_entropy(Transformer(pcfg4, pd)(
        toks[:, :-1], torch.zeros(4, dtype=torch.long), None), toks[:, 1:])
    ge, gl = torch.autograd.grad(ref, [leaves["embed"], leaves["lm_head"]])
    ref = ref.detach()
    assert abs(float(loss) - float(ref)) < 1e-5 * float(ref)
    torch.testing.assert_close(new["embed"], params["embed"] - 1e-2 * ge,
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(new["lm_head"], params["lm_head"] - 1e-2 * gl,
                               rtol=0, atol=1e-6)
