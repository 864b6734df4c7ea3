"""Expert parallelism of the port against the JAX package: the twins of
``tests/test_parallel_axes.py``'s ``test_ep_*`` at ep = 2 (a world of 2
ranks) and ep = 2 × tp = 2 (a world of 4), each a gloo process group on the
CPU started once for the module (``torch_parallel_worker.py``), both at
once, every rank with a deadline.

- ``ep_moe`` at capacity E (no assignment dropped) against the JAX
  single-device ``_moe_mlp``, with bf16 (f32 at rest) and q4_0 experts;
- at capacity 1.0 (top-1 of 4 experts, some assignments dropped): finite,
  and equal to the JAX ``ep_moe`` at the same capacity and ep;
- a whole tiny Mixtral's forward with bf16 and with q4_0 weights, its
  experts split over ep (and over tp inside each expert), against the JAX
  single-device ``model_step``.

Tolerance: 3e-2·max|out| (the JAX tests' 3e-2, relative to the output's
scale as the port's single-device tests hold it).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from neural_tpu.convert import init_random as jinit_random
from neural_tpu.core.dtypes import PRESETS as JPRESETS
from neural_tpu.core.qtensor import quantize as jquantize
from neural_tpu.models.config import ModelConfig as JModelConfig
from neural_tpu.models.transformer import _moe_mlp
from neural_tpu.parallel.ep import ep_moe as jep_moe
from neural_tpu.parallel.sharding import make_mesh as jmake_mesh
from neural_tpu.runtime import init_cache as jinit_cache
from neural_tpu.runtime import model_step as jmodel_step

from test_torch_bridge import jax_array_to_numpy, jax_tree_to_numpy
from torch_parallel_worker import join_world, start_world

REL_TOL = 3e-2
WORLDS = (2, 4)
TOKENS = [[5, 9, 2, 7, 33, 1, 8, 20]]


def tiny_cfg(**kw):
    base = dict(arch="mixtral", vocab_size=256, hidden_size=128, n_layers=2,
                n_heads=8, n_kv_heads=4, head_dim=16, intermediate_size=128,
                max_seq_len=64, n_experts=4, n_experts_active=2)
    base.update(kw)
    return JModelConfig(**base)


def _dense_lp(cfg, seed, quant=None):
    """The JAX tests' router and expert stacks: f32 normals (0.05 for the
    experts, 0.1 for the router), q4_0 per expert with ``quant``."""
    rng = np.random.default_rng(seed)
    D, I_, E = cfg.hidden_size, cfg.intermediate_size, cfg.n_experts
    dense = {"w_gate": rng.standard_normal((E, D, I_)) * .05,
             "w_up": rng.standard_normal((E, D, I_)) * .05,
             "w_down": rng.standard_normal((E, I_, D)) * .05}
    dense = {k: v.astype(np.float32) for k, v in dense.items()}
    if quant:
        ex = {k: jax.tree.map(lambda *xs: jnp.stack(xs),
                              *[jquantize(jnp.asarray(w[e]), JPRESETS[quant])
                                for e in range(E)])
              for k, w in dense.items()}
    else:
        ex = {k: jnp.asarray(v) for k, v in dense.items()}
    router = jnp.asarray(rng.standard_normal((D, E)).astype(np.float32)) * .1
    return {"router": router, "experts": ex}, rng


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    cases, refs = {}, {}
    cfg = tiny_cfg()
    for quant in (None, "q4_0"):
        lp, rng = _dense_lp(cfg, 0, quant)
        x = jnp.asarray(rng.standard_normal((2, 8, cfg.hidden_size)),
                        jnp.bfloat16)
        cases[f"dense_{quant}"] = dict(
            cfg=dataclasses.asdict(cfg), lp=jax_tree_to_numpy(lp),
            x=jax_array_to_numpy(x), capacity_factor=float(cfg.n_experts))
        refs[f"dense_{quant}"] = (_moe_mlp, lp, x, cfg)
    dcfg = tiny_cfg(n_experts_active=1, intermediate_size=64)
    lp, rng = _dense_lp(dcfg, 2)
    x = jnp.asarray(rng.standard_normal((1, 32, dcfg.hidden_size)),
                    jnp.bfloat16)
    cases["drops"] = dict(cfg=dataclasses.asdict(dcfg),
                          lp=jax_tree_to_numpy(lp), x=jax_array_to_numpy(x),
                          capacity_factor=1.0)
    models = {}
    for quant in (None, "q4_0"):
        p = jinit_random(cfg, quant=quant)
        models[quant] = p
    inputs = dict(suite="ep", moe=cases, model={
        q: dict(cfg=dataclasses.asdict(cfg), params=jax_tree_to_numpy(p),
                tokens=TOKENS) for q, p in models.items()})
    base = tmp_path_factory.mktemp("ep")
    handles = {w: start_world(str(base / f"world{w}"), inputs, w)
               for w in WORLDS}

    # the JAX side, while the ranks run
    ref = {k: np.asarray(f(x, lp, c), np.float32)
           for k, (f, lp, x, c) in refs.items()}
    mesh = jmake_mesh(dp=1, ep=2)
    ref["drops"] = np.asarray(jax.jit(jax.shard_map(
        lambda lp_, x_: jep_moe(x_, lp_, dcfg, "ep", capacity_factor=1.0),
        mesh=mesh, in_specs=({"router": P(), "experts": {
            k: P("ep") for k in lp["experts"]}}, P()),
        out_specs=P(), check_vma=False))(lp, x), np.float32)
    tokens = jnp.asarray(TOKENS, jnp.int32)
    for q, p in models.items():
        ref[("model", q)] = np.asarray(jmodel_step(
            p, tokens, jnp.zeros((1,), jnp.int32), jinit_cache(cfg, 1, 16),
            cfg)[0])
    outs = {w: join_world(h) for w, h in handles.items()}
    return dict(ref=ref, outs=outs)


def _close(out, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(out, np.float32), ref, rtol=0,
                               atol=REL_TOL * np.abs(ref).max())


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("quant", [None, "q4_0"])
def test_ep_moe_matches_dense_mixture(run, world, quant):
    """Capacity E keeps every assignment: the dispatch, the local experts
    (over tp too in the world of 4) and the combine equal the dense
    mixture."""
    key = f"dense_{quant}"
    for out in run["outs"][world]:
        _close(out["moe"][key], run["ref"][key])


@pytest.mark.parametrize("world", WORLDS)
def test_ep_capacity_drops_are_bounded(run, world):
    """Capacity 1.0 drops assignments: the output stays finite and equals
    the JAX ``ep_moe`` at that capacity."""
    got = run["outs"][world][0]["moe"]["drops"]
    assert np.isfinite(got).all()
    _close(got, run["ref"]["drops"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("quant", [None, "q4_0"])
def test_ep_full_model_forward(run, world, quant):
    """A whole tiny Mixtral through ``ep_moe`` inside the graph (the mesh's
    ep axis), its attention split over tp in the world of 4."""
    for out in run["outs"][world]:
        _close(out["model"][quant], run["ref"][("model", quant)])


@pytest.mark.parametrize("world", WORLDS)
def test_ep_rank_holds_its_experts(run, world):
    """Each rank keeps E/ep experts, each split over tp in the world of 4;
    two all-to-alls a layer; the q4_0 experts' capacity buffers (16 rows
    at capacity E) go through the quantized product."""
    tp = world // 2
    for r, out in enumerate(run["outs"][world]):
        assert out["mesh"] == ({"dp": 1, "ep": 2, "tp": tp},
                               {"dp": 0, "ep": r // tp, "tp": r % tp})
        kind, shape = out["local_experts"]["q4_0"]
        assert kind == "QTensor" and shape[0] == 2
        assert shape[-1] == 128 // tp          # w_up's N over tp
        routes = out["moe_routes"]["dense_q4_0"]
        assert routes["ep_all_to_all"] == 2
        assert routes.get("tp_all_reduce", 0) == (1 if tp > 1 else 0)
