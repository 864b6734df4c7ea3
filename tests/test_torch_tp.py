"""Tensor and data parallelism of the port against the JAX package: the
twins of ``tests/test_tp.py`` and of ``tests/test_multihost.py``'s two
process steps.

The JAX side runs its ``parallel.tp`` functions on the 8-device virtual CPU
mesh, in bf16. The port runs in real processes: one world of 2 ranks (dp = 1
× tp = 2) and one of 4 (dp = 2 × tp = 2), each a gloo process group on the
CPU, started once for the module (``torch_parallel_worker.py``), both at
once; every rank has a deadline and the ranks are killed past it. The same
weights cross to the port through ``convert.from_jax``.

Tolerances: logits within ``REL_TOL`` = 3e-2·max|logit|, the port's
single-device tolerance (``tests/test_torch_model.py``). The JAX package
sums the row-split products' bf16 partials over tp; the port sums them in
f32 and rounds once, as one device rounds its whole product, so the two TP
runs differ by what the single-device runs differ by and one bf16 rounding
at each row-split product. Greedy ids equal wherever the JAX single-device
logits (teacher-forced on the JAX ids) prove them: up to the first step
whose top-1/top-2 margin falls below that tolerance.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from neural_tpu.convert import init_random as jinit_random
from neural_tpu.models.config import ModelConfig as JModelConfig
from neural_tpu.parallel.sharding import (make_mesh as jmake_mesh,
                                          shard_cache as jshard_cache,
                                          shard_params as jshard_params)
from neural_tpu.parallel.tp import (make_tp_decode_loop as jmake_tp_loop,
                                    make_tp_prefill as jmake_tp_prefill,
                                    make_tp_step as jmake_tp_step,
                                    tp_generate as jtp_generate)
from neural_tpu.runtime import init_cache as jinit_cache
from neural_tpu.runtime import model_step as jmodel_step
from neural_tpu.runtime.sampling import SamplingParams as JSP

from test_torch_bridge import jax_tree_to_numpy
from torch_parallel_worker import join_world, start_world

REL_TOL = 3e-2
N_STEPS = 8
TOKENS = [[5, 9, 2, 7, 33, 1, 8, 20]] * 2
CONT = [[3, 14, 15, 9]] * 2      # two rows: one a dp rank at dp = 2
LOOP_ROWS = [[3, 14, 15, 9], [7, 1, 2, 5]]
GEN_ROWS = [[3, 14, 15, 9], [7, 1, 2], [11, 6, 8, 2, 4]]
WORLDS = (2, 4)


def tiny_cfg(**kw):
    base = dict(arch="llama", vocab_size=256, hidden_size=128, n_layers=2,
                n_heads=8, n_kv_heads=4, head_dim=16, intermediate_size=256,
                max_seq_len=64)
    base.update(kw)
    return JModelConfig(**base)


def _mh_cfg(world):
    # tests/multihost_worker.py's model; kv heads split over tp up to 4
    return tiny_cfg(vocab_size=128, hidden_size=64, n_heads=4,
                    n_kv_heads=2 if world <= 2 else world,
                    intermediate_size=128)


def _write_ckpt(tree, cfg, path):
    from neural_tpu_torch.convert.checkpoint import save_checkpoint
    from neural_tpu_torch.convert.from_jax import params_from_numpy
    from neural_tpu_torch.models.config import ModelConfig
    pcfg = ModelConfig(**dataclasses.asdict(cfg))
    save_checkpoint(path, params_from_numpy(tree, pcfg, "cpu").param_dict(),
                    pcfg)


def _margins_proven(params, cfg, seqs, n_prompt, n_new):
    """Per row: how many of the ``n_new`` ids after its ``n_prompt[b]``
    prompt ids the JAX single-device logits prove (teacher-forced on
    ``seqs[b]``, right-padded into one call: causal, so the pad changes no
    earlier row)."""
    L = max(len(s) for s in seqs)
    toks = np.zeros((len(seqs), L), np.int32)
    for b, s in enumerate(seqs):
        toks[b, :len(s)] = s
    logits, _ = jmodel_step(params, jnp.asarray(toks),
                            jnp.zeros((len(seqs),), jnp.int32),
                            jinit_cache(cfg, len(seqs), L), cfg)
    logits = np.asarray(logits, np.float32)
    proven = []
    for b in range(len(seqs)):
        k = 0
        for i in range(n_new):
            row = logits[b, n_prompt[b] - 1 + i]
            top = np.sort(row)
            if top[-1] - top[-2] < REL_TOL * np.abs(row).max():
                break
            k += 1
        proven.append(k)
    return proven


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    cfg = tiny_cfg()
    mcfg = tiny_cfg(arch="mixtral", n_experts=4, n_experts_active=2,
                    intermediate_size=128)
    params = {q: jinit_random(cfg, quant=q) for q in (None, "q4_0")}
    mparams = jinit_random(mcfg, quant=None)
    base = tmp_path_factory.mktemp("tp")
    ckpt = str(base / "tiny_q4_0.ntpu")
    _write_ckpt(jax_tree_to_numpy(params["q4_0"]), cfg, ckpt)
    handles = {}
    for world in WORLDS:
        mh = _mh_cfg(world)
        rng = np.random.default_rng(0)
        inputs = dict(
            suite="tp", cfg=dataclasses.asdict(cfg),
            params={q: jax_tree_to_numpy(p) for q, p in params.items()},
            moe_cfg=dataclasses.asdict(mcfg),
            moe_params=jax_tree_to_numpy(mparams),
            tokens=TOKENS, cont={"toks": CONT}, loop_rows=LOOP_ROWS,
            n_steps=N_STEPS, gen_rows=GEN_ROWS, ckpt=ckpt,
            mh_cfg=dataclasses.asdict(mh),
            mh_params=jax_tree_to_numpy(jinit_random(mh, seed=0)),
            mh_tokens=rng.integers(1, 128, (world, 5)).tolist())
        handles[world] = start_world(
            str(base / f"world{world}"), inputs, world,
            env={"LOCAL_WORLD_SIZE": str(world // 2)})

    # the JAX side, while the ranks run
    ref = {}
    jm = jmake_mesh(dp=1, tp=2)
    tokens = jnp.asarray(TOKENS, jnp.int32)
    start = jnp.zeros((2,), jnp.int32)
    for q, p in params.items():
        step = jmake_tp_step(p, cfg, jm)
        ref[("step", q)] = np.asarray(step(
            jshard_params(p, cfg, jm), tokens, start,
            jshard_cache(jinit_cache(cfg, 2, 32), jm))[0])
    mstep = jmake_tp_step(mparams, mcfg, jm)
    msp = jshard_params(mparams, mcfg, jm)
    for T in (4, 8):
        ref[("moe", T)] = np.asarray(mstep(
            msp, tokens[:, :T], start,
            jshard_cache(jinit_cache(mcfg, 2, 16), jm))[0])
    p = params["q4_0"]
    sp = jshard_params(p, cfg, jm)
    rows = jnp.asarray(LOOP_ROWS, jnp.int32)
    lens = jnp.asarray([4, 4], jnp.int32)
    tl, sc = jmake_tp_prefill(p, cfg, jm)(
        sp, rows, lens, jshard_cache(jinit_cache(cfg, 2, 32), jm))
    tok0 = jnp.argmax(tl, axis=-1).astype(jnp.int32)
    loop, _ = jmake_tp_loop(p, cfg, jm, N_STEPS)(sp, tok0[:, None], lens, sc)
    ref["loop"] = np.concatenate([np.asarray(tok0)[None], np.asarray(loop)])
    ref["gen"] = jtp_generate(p, cfg, jmake_mesh(dp=2, tp=2), GEN_ROWS,
                              JSP(greedy=True, repeat_last_n=0),
                              max_new_tokens=6, stop_at_eos=False)
    # the margins that prove the JAX ids: the loop's rows, the generated rows
    seqs = [LOOP_ROWS[b] + ref["loop"][:-1, b].tolist() for b in range(2)]
    ref["loop_proven"] = _margins_proven(p, cfg, seqs, [4, 4], N_STEPS + 1)
    ref["gen_proven"] = _margins_proven(
        p, cfg, [o[:-1] for o in ref["gen"]], [len(r) for r in GEN_ROWS], 6)
    outs = {w: join_world(h) for w, h in handles.items()}

    # the decode continuing needs the port's next id: JAX's single device
    # on the same prompt, then one step on it
    cache = jinit_cache(cfg, 2, 32)
    c0, cache = jmodel_step(p, jnp.asarray(CONT, jnp.int32),
                            jnp.zeros((2,), jnp.int32), cache, cfg)
    nxt = int(jnp.argmax(c0[0, -1]))
    c1, _ = jmodel_step(p, jnp.asarray([[nxt]] * 2, jnp.int32),
                        jnp.asarray([len(CONT[0])] * 2, jnp.int32), cache,
                        cfg)
    ref["cont"] = (nxt, np.asarray(c0), np.asarray(c1))
    return dict(ref=ref, outs=outs, cfg=cfg)


def _close(out, ref, tol=REL_TOL):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(out, np.float32), ref, rtol=0,
                               atol=tol * np.abs(ref).max())


def _ids_proven(port, jax_ids, proven, what):
    """``port`` equals ``jax_ids`` over the first ``proven`` ids."""
    assert list(port[:proven]) == list(jax_ids[:proven]), (what, port,
                                                           jax_ids, proven)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("quant", [None, "q4_0"])
def test_tp_matches_single_device(run, world, quant):
    """The sharded step's logits: against the JAX TP step on the same
    weights, and against the port on one device."""
    out = run["outs"][world][0]
    _close(out["step"][quant], run["ref"][("step", quant)])
    _close(out["step"][quant], out["step_single"][quant])


@pytest.mark.parametrize("world", WORLDS)
def test_tp_decode_continues(run, world):
    """A prompt, then one step on the next id: the port's TP argmax is
    JAX's single-device one, and both steps' logits agree with it."""
    nxt, c0, c1 = run["ref"]["cont"]
    first, second = run["outs"][world][0]["cont"]
    assert int(np.argmax(first[0, -1])) == nxt
    _close(first, c0)
    _close(second, c1)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("T", [4, 8])
def test_moe_tp(run, world, T):
    """Mixtral under tp: T = 4 takes the dense mixture (the sum deferred
    until after it, in f32), T = 8 the grouped path; against the JAX TP
    step."""
    _close(run["outs"][world][0]["moe_step"][T], run["ref"][("moe", T)])


@pytest.mark.parametrize("world", WORLDS)
def test_auto_mesh_layout(run, world):
    """tp within a host (``LOCAL_WORLD_SIZE`` ranks), dp across hosts;
    consecutive ranks share a tp group; only rank 0 is primary."""
    local = world // 2
    for r, out in enumerate(run["outs"][world]):
        shape, coords, primary = out["auto_mesh"]
        assert shape == {"dp": world // local, "tp": local}
        assert coords == {"dp": r // local, "tp": r % local}
        assert primary == (r == 0)
        assert out["auto_mesh_tp4"] == {"dp": 1, "tp": world}
        assert out["mesh"] == ({"dp": world // 2, "tp": 2},
                               {"dp": r // 2, "tp": r % 2})


@pytest.mark.parametrize("world", WORLDS)
def test_tp_decode_loop_greedy_matches_jax(run, world):
    """The sharded prefill's argmax and the greedy decode loop against the
    JAX TP loop, id for id wherever the margins prove them."""
    out, ref = run["outs"][world][0], run["ref"]
    port = np.concatenate([np.asarray(out["loop_tok0"])[None],
                           out["loop_greedy"]])
    assert port.shape == (N_STEPS + 1, 2)
    for b, k in enumerate(ref["loop_proven"]):
        _ids_proven(port[:, b].tolist(), ref["loop"][:, b].tolist(), k,
                    f"row {b}")
    assert sum(ref["loop_proven"]) >= 4, ref["loop_proven"]


@pytest.mark.parametrize("world", WORLDS)
def test_tp_sample_loop(run, world):
    """The sampled loop: the same draws from the same seed, ids in range,
    and temperature → 0 with top-1 equal to the greedy loop."""
    out = run["outs"][world][0]
    a, b = out["sampled"]
    np.testing.assert_array_equal(a, b)
    assert a.shape == (N_STEPS, 2)
    assert ((a >= 0) & (a < 256)).all()
    np.testing.assert_array_equal(out["cold"], out["greedy"])


@pytest.mark.parametrize("world", WORLDS)
def test_tp_generate_end_to_end(run, world):
    """tp_generate over ragged rows (3, padded to a multiple of dp): greedy
    ids against the JAX ``tp_generate`` at dp = 2 × tp = 2 by the margins;
    every row's length; the sampled path's lengths; at dp = 1 the sampled
    ids equal the single-device ``batched_generate`` with the same seed."""
    out, ref = run["outs"][world][0], run["ref"]
    outs = out["gen_greedy"]
    assert [len(o) for o in outs] == [len(r) + 6 for r in GEN_ROWS]
    for b, (o, j, r) in enumerate(zip(outs, ref["gen"], GEN_ROWS)):
        assert o[:len(r)] == r
        _ids_proven(o[len(r):], j[len(r):], ref["gen_proven"][b], f"row {b}")
    assert sum(ref["gen_proven"]) >= 4, ref["gen_proven"]
    assert [len(o) for o in out["gen_sampled"]] == \
        [len(r) + 6 for r in GEN_ROWS]
    if world == 2:
        assert out["gen_sampled"] == out["gen_single_sampled"]


@pytest.mark.parametrize("world", WORLDS)
def test_model_generate_mesh(run, world):
    """``Model.generate(mesh=...)`` is ``tp_generate`` over shards kept on
    the Model: greedy (a repetition penalty of 1) equals its ids, and a
    second call (``ignore_prompt``) reuses the shards."""
    out = run["outs"][world][0]
    assert out["model_generate"] == out["gen_greedy"]
    assert out["model_generate_again"] == [
        o[len(r):] for o, r in zip(out["gen_greedy"], GEN_ROWS)]


@pytest.mark.parametrize("world", WORLDS)
def test_run_tp_launcher(run, world):
    """``python -m neural_tpu_torch.parallel.run_tp`` on an NTPU file of
    the same weights, in the same world: its ids against JAX's by the
    margins of the first row."""
    out, ref = run["outs"][world][0], run["ref"]
    r = GEN_ROWS[0]
    assert len(out["run_tp"]) == 6
    _ids_proven(out["run_tp"], ref["gen"][0][len(r):], ref["gen_proven"][0],
                "run_tp")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode", ["dp", "tp"])
def test_two_process_sharded_step(run, world, mode):
    """``tests/test_multihost.py``'s twins: "dp" across the processes' hosts
    (tp within each), "tp" across every rank, so that every per-layer sum
    crosses a process boundary. Each rank's global logits against its own
    unsharded reference; every rank loaded the same weights (checksum)."""
    shapes, sums = [], []
    for out in run["outs"][world]:
        shape, ck, got, ref = out["multihost"][mode]
        _close(got, ref)
        shapes.append(shape)
        sums.append(ck)
    assert len(set(sums)) == 1
    tp = world if mode == "tp" else world // 2
    assert shapes[0] == {"dp": world // tp, "tp": tp}


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_agree(run, world):
    """Every rank held the same weights and returned the same ids."""
    outs = run["outs"][world]
    for key in ("gen_greedy", "gen_sampled", "model_generate", "run_tp"):
        assert all(o[key] == outs[0][key] for o in outs), key
    for q in (None, "q4_0"):
        assert len({o["checksum"][q] for o in outs}) == 1


@pytest.mark.parametrize("world", WORLDS)
def test_collectives_counted(run, world):
    """Two steps (bf16 and q4_0 weights) of 2 layers: a sum over tp after
    wo and after w_down each layer, one vocabulary gather a step, one dp
    gather a step under dp > 1."""
    routes = run["outs"][world][0]["routes"]
    assert routes.get("tp_all_reduce") == 2 * 2 * 2
    assert routes.get("tp_all_gather") == 2
    assert routes.get("dp_all_gather", 0) == (2 if world == 4 else 0)


@pytest.mark.parametrize("world", WORLDS)
def test_int8_kv_under_tp(run, world):
    """An int8 KV cache split by heads, scales with them: the sharded step
    against the single-device step over int8 KV."""
    got, ref = run["outs"][world][0]["int8"]
    _close(got, ref)
