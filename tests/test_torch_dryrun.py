"""The port's twin of ``__graft_entry__.dryrun_multichip`` at 8 ranks.

One gloo world of 8 ranks on the CPU (``torch_parallel_worker.py``) runs
``python -m neural_tpu_torch.parallel.run_tp --dryrun --device cpu``'s
entry, ``parallel.dryrun.dryrun_multichip``: inference at dp × tp = 2 × 4
(q4_0), the sampled TP decode loop, the dp × pp × tp = 2 × 2 × 2 pipeline
training step, the sp × ep = 2 × 4 MoE training step and quantized-MoE
inference at ep = 4 over ranks 0-3, each on a tiny random model (the
port's ``init_random``: its draws are not the JAX package's, so the losses
are held finite, as the JAX dry run holds its own, and near ln(512), the
loss of a near-uniform prediction over the 512-token vocabulary).

The same world then runs the sp × ep MoE training step,
``make_moe_train_step``, at (sp, ep) = (2, 4) over the 8 ranks and (2, 1)
over ranks 0-1, on a tiny f32 Mixtral from the JAX ``init_random`` with a
capacity factor of E (no assignment dropped). The JAX side is one device:
``jax.value_and_grad`` of the cross-entropy of ``forward(cache=None)`` over
the whole sequence, which the step's shards split over sp. Tolerances: the
loss within 1e-3 relative, and the gradient each leaf moved by, (old - new)
/ lr, within ``GRAD_TOL`` = 2e-2·max|grad| of ``jax.grad``'s for
``embed``, every layer's ``wq``, ``router`` and experts' ``w_up``
(``test_torch_nocache``'s bounds: activations are bf16 in both packages,
and the f32 sums of the backward run in other orders). That holds the
ring's backward through its sends, ``ep_moe``'s two all-to-all transposes
and the sums over sp and ep of the replicated leaves' gradients.
"""
import dataclasses
import math

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
# case -> (sp, ep)
MOE_CASES = {"sp2_ep4": (2, 4), "sp2_ep1": (2, 1)}
MOE_CFG = JModelConfig(arch="mixtral", vocab_size=256, hidden_size=64,
                       n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
                       intermediate_size=128, max_seq_len=64, n_experts=8,
                       n_experts_active=2)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cfg = MOE_CFG
    params = jinit_random(cfg, quant=None, dtype=jnp.float32)
    toks = np.random.default_rng(1).integers(0, 256, (2, 17), np.int32)
    handle = start_world(
        str(tmp_path_factory.mktemp("dryrun")),
        dict(suite="dryrun", moe_train=dict(
            cfg=dataclasses.asdict(cfg), params=jax_tree_to_numpy(params),
            cases=MOE_CASES, tokens=toks.tolist(), lr=LR)), 8)
    jt = jnp.asarray(toks)

    def loss(p):
        logits, _ = jforward(p, jt[:, :-1], jnp.zeros((2,), jnp.int32), None,
                             cfg)
        lp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        return -jnp.take_along_axis(lp, jt[:, 1:, None], axis=-1).mean()

    val, g = jax.value_and_grad(loss)(params)
    lay = params["layers"]
    old = {"embed": params["embed"], "wq": lay["wq"], "router": lay["router"],
           "w_up": lay["experts"]["w_up"]}
    grad = {"embed": g["embed"], "wq": g["layers"]["wq"],
            "router": g["layers"]["router"],
            "w_up": g["layers"]["experts"]["w_up"]}
    return dict(outs=join_world(handle), loss=float(val),
                old={k: np.asarray(v) for k, v in old.items()},
                grad={k: np.asarray(v, np.float32) for k, v in grad.items()})


@pytest.fixture(scope="module")
def outs(world):
    return world["outs"]


def test_every_part_ran_on_its_mesh(outs):
    want = {"inference": {"dp": 2, "tp": 4},
            "pp": {"dp": 2, "pp": 2, "tp": 2},
            "moe": {"dp": 1, "sp": 2, "ep": 4, "tp": 1},
            "quantized_moe": {"dp": 1, "ep": 4, "tp": 1}}
    for r, o in enumerate(outs):
        for part, shape in want.items():
            if part == "quantized_moe" and r >= 4:
                assert part not in o
                continue
            assert o[part] == shape, (r, part, o.get(part))


@pytest.mark.parametrize("name", ["pp_loss", "moe_loss"])
def test_losses_finite_and_agreed(outs, name):
    """Every rank returns the same loss, counted once over the mesh."""
    losses = {o[name] for o in outs}
    assert len(losses) == 1, losses
    loss = losses.pop()
    assert math.isfinite(loss) and abs(loss - math.log(512)) < 0.5, loss


def test_collectives_ran(outs):
    """Each part's collectives: the tp sums and gathers, the pipeline's
    sends, the ring's hops and the experts' all-to-alls."""
    r0 = outs[0]["routes"]
    for name in ("tp_all_reduce", "tp_all_gather", "dp_all_gather",
                 "pp_ppermute", "sp_ppermute", "ep_all_to_all",
                 "ring_attend", "attend_nocache"):
        assert r0.get(name, 0) > 0, (name, r0)


def _moe_assemble(world, key):
    """The updated leaves from the ranks' shards: the experts' ``w_up`` over
    ep from sp rank 0, every other leaf from rank 0; every sp rank's copy
    checked equal to sp rank 0's, and every ep rank's replicated leaves to
    ep rank 0's, bit for bit."""
    sp, ep = MOE_CASES[key]
    recs = [o["moe_train"][key] for o in world["outs"]
            if key in o["moe_train"]]
    assert len(recs) == sp * ep
    at = {(r["coords"]["sp"], r["coords"]["ep"]): r for r in recs}
    for (s, e), r in at.items():
        assert r["loss"] == recs[0]["loss"]
        for a, b in zip(r["w_up"], at[(0, e)]["w_up"]):
            np.testing.assert_array_equal(a, b)
        for name in ("wq", "router"):
            for a, b in zip(r[name], at[(0, 0)][name]):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(r["embed"], at[(0, 0)]["embed"])
    r0 = at[(0, 0)]
    w_up = np.stack([np.concatenate([at[(0, e)]["w_up"][l]
                                     for e in range(ep)], 0)
                     for l in range(len(r0["w_up"]))])
    return dict(loss=r0["loss"], embed=r0["embed"], wq=np.stack(r0["wq"]),
                router=np.stack(r0["router"]), w_up=w_up)


@pytest.mark.parametrize("key", list(MOE_CASES))
def test_moe_train_loss_matches_jax(world, key):
    got, want = _moe_assemble(world, key)["loss"], world["loss"]
    assert abs(got - want) < 1e-3 * want, (got, want)


@pytest.mark.parametrize("key", list(MOE_CASES))
@pytest.mark.parametrize("leaf", ["embed", "wq", "router", "w_up"])
def test_moe_train_grads_match_jax(world, key, leaf):
    """The gradient the MoE step moved each leaf by, (old - new) / lr,
    against the JAX single-device ``jax.grad`` within 2e-2·max|grad|."""
    got = _moe_assemble(world, key)[leaf]
    want = world["grad"][leaf]
    moved = (world["old"][leaf] - got) / LR
    assert moved.shape == want.shape
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(moved, want, rtol=0,
                               atol=GRAD_TOL * np.abs(want).max(),
                               err_msg=f"{key} {leaf}")
