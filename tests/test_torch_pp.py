"""The pipeline training step of the port against the JAX package: the twin
of ``tests/test_parallel_axes.py::test_pp_train_matches_single_device``.

One gloo world of 8 ranks on the CPU, started once for the module
(``torch_parallel_worker.py``), runs ``make_pp_train_step`` at (pp, tp, dp)
= (2, 2, 2) and (4, 1, 2) over all 8 ranks and at (2, 1, 1) over ranks
0-1, on a tiny 4-layer Llama with f32 params from the JAX ``init_random``.
The JAX side is one device: ``jax.value_and_grad`` of the cross-entropy of
``forward(cache=None)``, and its SGD update at lr 1e-2.

Tolerances, those of the JAX test: the loss within 3e-2 relative; the
updated ``embed``, every layer's ``wq`` and the ``lm_head`` within atol
5e-3, rtol 5e-2. Every dp rank of a stage holds the same update, and every
stage the same ``embed`` and ``lm_head``, bit for bit. At lr 1e-2 an update
moves a leaf by some 3e-4 here, far inside those bounds, so the gradient
each leaf moved by, (old - new) / lr, is also held against ``jax.grad``
within ``GRAD_TOL`` = 2e-2·max|grad| (``test_torch_nocache``'s bound):
``embed`` and every layer's ``attn_norm_w`` are replicated, so their
gradients are what ``fix_replicated_grads`` summed over tp and dp.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from neural_tpu.convert import init_random as jinit_random
from neural_tpu.models.config import ModelConfig as JModelConfig
from neural_tpu.models.transformer import forward as jforward

from test_torch_bridge import jax_tree_to_numpy
from torch_parallel_worker import join_world, start_world

LR = 1e-2
GRAD_TOL = 2e-2
T = 8
# case -> (pp, tp, dp), as the JAX test's parameters
CASES = {"pp2_tp2_dp2": (2, 2, 2), "pp4_tp1_dp2": (4, 1, 2),
         "pp2_tp1_dp1": (2, 1, 1)}


def tiny_cfg(**kw):
    base = dict(arch="llama", vocab_size=256, hidden_size=128, n_layers=4,
                n_heads=8, n_kv_heads=4, head_dim=16, intermediate_size=256,
                max_seq_len=64)
    base.update(kw)
    return JModelConfig(**base)


def _tokens(dp):
    B = max(2, dp * 2)
    return np.random.default_rng(0).integers(0, 256, (B, T + 1), np.int32)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    cfg = tiny_cfg()
    params = jinit_random(cfg, quant=None, dtype=jnp.float32)
    toks = {k: _tokens(dp).tolist() for k, (_, _, dp) in CASES.items()}
    handle = start_world(
        str(tmp_path_factory.mktemp("pp")),
        dict(suite="pp", cfg=dataclasses.asdict(cfg),
             params=jax_tree_to_numpy(params), cases=CASES, tokens=toks,
             lr=LR), 8)
    ref = {}
    for B in sorted({len(t) for t in toks.values()}):
        tk = jnp.asarray(_tokens(B // 2))

        def loss(p):
            logits, _ = jforward(p, tk[:, :-1], jnp.zeros((B,), jnp.int32),
                                 None, cfg)
            lp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
            return -jnp.take_along_axis(lp, tk[:, 1:, None], axis=-1).mean()

        val, g = jax.value_and_grad(loss)(params)
        ref[B] = dict(
            loss=float(val),
            embed=np.asarray(params["embed"] - LR * g["embed"]),
            wq=np.asarray(params["layers"]["wq"] - LR * g["layers"]["wq"]),
            lm_head=np.asarray(params["lm_head"] - LR * g["lm_head"]),
            grad={"embed": g["embed"], "wq": g["layers"]["wq"],
                  "attn_norm": g["layers"]["attn_norm_w"],
                  "lm_head": g["lm_head"]})
    old = {"embed": params["embed"], "wq": params["layers"]["wq"],
           "attn_norm": params["layers"]["attn_norm_w"],
           "lm_head": params["lm_head"]}
    return dict(ref=ref, outs=join_world(handle), cfg=cfg,
                old={k: np.asarray(v) for k, v in old.items()})


def _assemble(run, key):
    """The updated leaves from the ranks' shards: each stage's layers, wq's
    columns over tp and the lm_head's vocabulary over tp, from dp rank 0;
    every other copy checked equal to it."""
    pp, tp, dp = CASES[key]
    recs = [o[key] for o in run["outs"] if key in o]
    assert len(recs) == pp * tp * dp
    at = {(r["coords"]["dp"], r["coords"]["pp"], r["coords"]["tp"]): r
          for r in recs}
    for (d, s, t), r in at.items():
        r0 = at[(0, s, t)]
        for name in ("embed", "lm_head"):
            np.testing.assert_array_equal(r[name], at[(0, 0, t)][name])
        for a, b in zip(r["wq"] + r["attn_norm"], r0["wq"] + r0["attn_norm"]):
            np.testing.assert_array_equal(a, b)
        assert r["loss"] == recs[0]["loss"]
    wq = [np.concatenate([at[(0, s, t)]["wq"][i] for t in range(tp)], -1)
          for s in range(pp) for i in range(len(at[(0, s, 0)]["wq"]))]
    lm = np.concatenate([at[(0, 0, t)]["lm_head"] for t in range(tp)], -1)
    norm = [w for s in range(pp) for w in at[(0, s, 0)]["attn_norm"]]
    return dict(loss=recs[0]["loss"], embed=at[(0, 0, 0)]["embed"],
                wq=np.stack(wq), lm_head=lm, attn_norm=np.stack(norm),
                routes=[r["routes"] for r in recs])


@pytest.mark.parametrize("key", list(CASES))
def test_pp_train_matches_single_device(run, key):
    got = _assemble(run, key)
    ref = run["ref"][len(_tokens(CASES[key][2]))]
    assert abs(got["loss"] - ref["loss"]) < 3e-2 * max(1.0, ref["loss"])
    for name in ("embed", "wq", "lm_head"):
        np.testing.assert_allclose(got[name], ref[name], atol=5e-3,
                                   rtol=5e-2, err_msg=name)


@pytest.mark.parametrize("key", list(CASES))
@pytest.mark.parametrize("leaf", ["embed", "wq", "attn_norm", "lm_head"])
def test_pp_grads_match_jax_grad(run, key, leaf):
    """The gradient the step moved each leaf by, (old - new) / lr, against
    JAX's single-device ``jax.grad`` within 2e-2·max|grad|: a step that
    left a leaf as it was, or a replicated leaf's gradient summed over the
    wrong axes (dp or tp counted twice, or not at all), fails here."""
    got = _assemble(run, key)[leaf]
    want = np.asarray(run["ref"][len(_tokens(CASES[key][2]))]["grad"][leaf],
                      np.float32)
    moved = (run["old"][leaf] - got) / LR
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(moved, want, rtol=0,
                               atol=GRAD_TOL * np.abs(want).max(),
                               err_msg=f"{key} {leaf}")


@pytest.mark.parametrize("key", list(CASES))
def test_pp_step_collectives(run, key):
    """A step's collectives as the schedule makes them, and no kernel: M +
    pp - 2 = pp activation sends a forward (M = 2), the last stage's
    outputs summed over pp; at tp = 2 two sums a layer and the lm_head's
    gather; the gradients of replicated leaves summed over the axes they
    lack."""
    pp, tp, dp = CASES[key]
    for routes in _assemble(run, key)["routes"]:
        assert routes.get("pp_ppermute", 0) == (pp if pp > 1 else 0), routes
        assert routes.get("attend_nocache") == 4 // pp * (2 + pp - 1), routes
        assert routes.get("tp_all_gather", 0) == (1 if tp > 1 else 0)
        kernels = {k: n for k, n in routes.items()
                   if not (k.split("_")[0] in ("dp", "tp", "ep", "sp", "pp")
                           or k.startswith("attend_nocache"))}
        assert not kernels, kernels


# ---------------------------------------------------------------------------
# the reference's pipeline loss leaves out what its forward applies


FAULT_CFGS = {
    "logit_softcap": tiny_cfg(n_layers=2, logit_softcap=1.0),
    "bloom_embed_norm": tiny_cfg(arch="bloom", n_layers=2, n_kv_heads=8,
                                 use_alibi=True, rope_style="none",
                                 mlp_gated=False, act="gelu",
                                 norm_type="layernorm"),
}


@pytest.mark.parametrize("key", list(FAULT_CFGS))
def test_reference_pp_loss_drops_what_its_forward_applies(key):
    """The JAX ``make_pp_train_step``'s loss_fn (``neural_tpu/parallel/
    pp.py:153-193``) applies neither ``cfg.logit_softcap`` nor Bloom's
    embedding LayerNorm, both of which its ``forward`` applies: at pp = 2
    its loss parts from the cross-entropy of its own cache-less forward on
    the same weights by more than 1e-4 relative. The port's step runs the port's forward's embedding and head: on one
    rank its loss equals that forward's cross-entropy within 1e-6, which is
    the JAX forward's within 1e-3."""
    import torch
    from jax.sharding import NamedSharding, PartitionSpec as P
    from neural_tpu.parallel.pp import (make_pp_train_step as jstep,
                                        pp_param_specs as jspecs)
    from neural_tpu.parallel.sharding import make_mesh as jmake_mesh
    from neural_tpu_torch.convert.from_jax import params_from_numpy
    from neural_tpu_torch.models.config import ModelConfig
    from neural_tpu_torch.parallel import (make_mesh, make_pp_train_step,
                                           pp_shard_params)
    from neural_tpu_torch.parallel.pp import cross_entropy
    cfg = FAULT_CFGS[key]
    params = jinit_random(cfg, quant=None, dtype=jnp.float32)
    toks = np.random.default_rng(0).integers(0, 256, (2, T + 1), np.int32)
    jt = jnp.asarray(toks)
    logits, _ = jforward(params, jt[:, :-1], jnp.zeros((2,), jnp.int32),
                         None, cfg)
    lp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    ref = float(-jnp.take_along_axis(lp, jt[:, 1:, None], axis=-1).mean())
    jm = jmake_mesh(dp=1, pp=2, tp=1)
    sp = jspecs(params, cfg, tp=False)
    sharded = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(jm, s))
        if isinstance(s, P) else x, params, sp,
        is_leaf=lambda x: isinstance(x, P))
    jloss, _ = jstep(params, cfg, jm, n_microbatches=2, lr=LR)(sharded, jt)
    assert abs(float(jloss) - ref) > 1e-4 * ref, (float(jloss), ref)

    pcfg = ModelConfig(**dataclasses.asdict(cfg))
    model = params_from_numpy(jax_tree_to_numpy(params), pcfg, "cpu")
    pd = model.param_dict()
    mesh = make_mesh(dp=1, pp=1, tp=1, device="cpu")
    t = torch.tensor(toks, dtype=torch.long)
    loss, _ = make_pp_train_step(pd, pcfg, mesh, 2, lr=LR)(
        pp_shard_params(pd, pcfg, mesh), t)
    with torch.no_grad():
        fwd = float(cross_entropy(model(t[:, :-1], torch.zeros(
            2, dtype=torch.long), None), t[:, 1:]))
    assert abs(float(loss) - fwd) <= 1e-6 * fwd, (float(loss), fwd)
    assert abs(fwd - ref) <= 1e-3 * ref, (fwd, ref)
