"""Sequence parallelism of the port against the JAX package: the twins of
``tests/test_parallel_axes.py``'s ring tests, and each differentiable
collective's backward against its JAX transpose.

One gloo world of 8 ranks on the CPU, started once for the module
(``torch_parallel_worker.py``): ranks 0-3 run the ring at (sp, tp) =
(4, 1), ranks 4-7 at (2, 2), at once; then the collectives' suite on a
(dp, sp, tp) = (2, 2, 2) mesh of all 8, in the same world. The JAX side runs
``sequence_sharded_forward`` on its virtual mesh and the cache-less
``forward`` on one device, f32 params, bf16 activations.

Tolerances: the ring's logits against the JAX ring and the JAX one-device
cache-less forward within 2e-2 (atol and rtol, as the JAX test); against
the port's own one-device cache-less forward within 1e-5·max|logit| (the
same masked scores, the softmax taken over sp blocks: only the order of
f32 sums differs), and at tp = 2 within ``TP_TOL`` = 4e-3·max|logit|,
one bf16 step: a row-split product's two f32 partials are summed and
rounded to bf16 once, where one device rounds its whole product once, so
a few activations round the other way. The collectives' values and gradients exactly (sums of
two or four f32 numbers in one order on every rank, compared within 1e-6
of the value).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from neural_tpu.convert import init_random as jinit_random
from neural_tpu.models.config import ModelConfig as JModelConfig
from neural_tpu.models.transformer import forward as jforward
from neural_tpu.parallel.sharding import (make_mesh as jmake_mesh,
                                          shard_params as jshard_params)
from neural_tpu.parallel.sp import sequence_sharded_forward as jssf

from test_torch_bridge import jax_tree_to_numpy
from torch_parallel_worker import join_world, start_world


def tiny_cfg(**kw):
    base = dict(arch="llama", vocab_size=256, hidden_size=128, n_layers=2,
                n_heads=8, n_kv_heads=4, head_dim=16, intermediate_size=256,
                max_seq_len=64)
    base.update(kw)
    return JModelConfig(**base)


T = 16
TP_TOL = 4e-3
# case -> (mesh of the port's ranks "sp,tp", config overrides, batch, seed)
CASES = {"sp4_tp1": ("4,1", {}, 2, 0), "sp2_tp2": ("2,2", {}, 2, 0),
         "gqa_window_sp4": ("4,1", {"sliding_window": 6}, 1, 1)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    base = tmp_path_factory.mktemp("sp")
    cases, jax_in = {}, {}
    for key, (mesh, over, B, seed) in CASES.items():
        cfg = tiny_cfg(**over)
        params = jinit_random(cfg, quant=None, dtype=jnp.float32)
        toks = np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (B, T), np.int32)
        cases[key] = dict(mesh=mesh, cfg=dataclasses.asdict(cfg),
                          params=jax_tree_to_numpy(params),
                          tokens=toks.tolist())
        jax_in[key] = (cfg, params, toks)
    handle = start_world(str(base / "sp"), dict(suite="sp", cases=cases), 8)
    ref = {}
    for key, (cfg, params, toks) in jax_in.items():
        t = jnp.asarray(toks)
        one, _ = jforward(params, t, jnp.zeros((t.shape[0],), jnp.int32),
                          None, cfg)
        sp, tp = map(int, CASES[key][0].split(","))
        jm = jmake_mesh(dp=1, sp=sp, tp=tp)
        ring = jssf(jshard_params(params, cfg, jm), t, cfg, jm,
                    tp_axis="tp" if tp > 1 else None)
        ref[key] = (np.asarray(one), np.asarray(ring))
    outs = join_world(handle)
    return dict(ref=ref, sp=outs, coll=[o["coll"] for o in outs])


def _port(run, key):
    ranks = range(4) if CASES[key][0] == "4,1" else range(4, 8)
    outs = [run["sp"][r][key] for r in ranks]
    for o in outs[1:]:          # every rank gathers the same logits
        np.testing.assert_array_equal(o["got"], outs[0]["got"])
    return outs[0]


@pytest.mark.parametrize("key", list(CASES))
def test_ring_attention_matches_single_device(run, key):
    """The port's ring at (sp, tp) against the JAX one-device cache-less
    forward and the JAX ring, within 2e-2."""
    got = _port(run, key)["got"]
    one, ring = run["ref"][key]
    np.testing.assert_allclose(got, one, atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(got, ring, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("key", list(CASES))
def test_ring_matches_the_ports_oracle(run, key):
    """The ring against the port's own one-device cache-less forward on the
    same weights: the same masked scores, only the f32 sums reordered."""
    out = _port(run, key)
    tol = 1e-5 if CASES[key][0].endswith(",1") else TP_TOL
    np.testing.assert_allclose(out["got"], out["one"], rtol=0,
                               atol=tol * np.abs(out["one"]).max())


def test_ring_counts_its_hops(run):
    """sp - 1 hops a layer, each passing K, V and the positions: 3 × 3 × 2
    layers at sp = 4, 1 × 3 × 2 at sp = 2 (the last hop's blocks would go
    unread, so they are not sent); tp = 2 adds its sums and gather."""
    r4 = _port(run, "sp4_tp1")["routes"]
    r2 = _port(run, "sp2_tp2")["routes"]
    assert r4.get("sp_ppermute") == 18, r4
    assert r2.get("sp_ppermute") == 6, r2
    assert r2.get("tp_all_reduce") == 4 and r2.get("tp_all_gather") == 1, r2
    # the sequence gather of the logits
    assert r4.get("sp_all_gather") == 1, r4


def _by_coords(outs, name):
    """rank coordinates (dp, sp, tp) -> that rank's case record."""
    return {(o["coords"]["dp"], o["coords"]["sp"], o["coords"]["tp"]):
            o[name] for o in outs}


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * max(
        1.0, float(np.abs(b).max())))


@pytest.mark.parametrize("name", ["psum_tp", "psum_sp_tp", "all_gather_tp",
                                  "all_to_all_sp", "ppermute_ring_sp",
                                  "ppermute_one_sp"])
def test_collective_backward_is_its_transpose(run, name):
    """Each collective's forward as JAX defines it, its in-place form (no
    grad) equal to it, and its gradient the JAX transpose's under
    ``check_vma=False``: psum → psum; tiled all_gather → psum, then this
    rank's slice; all_to_all → all_to_all; ppermute → the reverse
    permutation (zeros where no cotangent comes back)."""
    recs = _by_coords(run["coll"], name)
    for (d, s, t), r in recs.items():
        tp_line = [recs[(d, s, j)] for j in range(2)]
        sp_line = [recs[(d, j, t)] for j in range(2)]
        x, c = r["x"], r["c"]
        if name == "psum_tp":
            y = sum(o["x"] for o in tp_line)
            g = sum(o["c"] for o in tp_line)
        elif name == "psum_sp_tp":
            group = [recs[(d, i, j)] for i in range(2) for j in range(2)]
            y = sum(o["x"] for o in group)
            g = sum(o["c"] for o in group)
        elif name == "all_gather_tp":
            y = np.concatenate([o["x"] for o in tp_line], axis=1)
            g = sum(o["c"] for o in tp_line)[:, 3 * t:3 * t + 3]
        elif name == "all_to_all_sp":
            y = np.stack([sp_line[i]["x"][s] for i in range(2)])
            g = np.stack([sp_line[j]["c"][s] for j in range(2)])
        elif name == "ppermute_ring_sp":
            y = sp_line[1 - s]["x"]
            g = sp_line[1 - s]["c"]
        else:                                # only 0 -> 1
            y = sp_line[0]["x"] if s == 1 else np.zeros_like(x)
            g = sp_line[1]["c"] if s == 0 else np.zeros_like(x)
        _close(r["y"], y)
        _close(r["y_nograd"], y)
        _close(r["g"], g)
        assert r["g"].shape == x.shape and c.shape == r["y"].shape
