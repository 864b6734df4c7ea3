"""The ranks of the port's parallel tests, and the parent's launcher.

``run_worlds([(tmp_dir, inputs, world, env), ...])`` (parent side) pickles
each ``inputs`` into its ``tmp_dir``, starts ``world`` processes of this
file, one a rank, for every world at once,
which join one gloo process group over 127.0.0.1 and run the suite
``inputs["suite"]`` on the CPU, each writing its results back as a pickle.
The parent waits for all of them within ``deadline`` seconds and kills
them when it passes: a rank that hangs fails the test instead of the run.

A rank imports torch and ``neural_tpu_torch`` only (never JAX), takes one
torch thread, as ``tests/test_torch_bridge.py`` sets for the other port
tests, and reads the JAX side's weights through ``convert.from_jax``.

Usage (what ``start_world`` runs): ``python torch_parallel_worker.py <dir>
<rank> <world> <port>``.
"""
import os
import pickle
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

# seconds the rendezvous and every collective may wait inside a rank, and
# the parent's whole wait for a world
RANK_TIMEOUT = 30.0
DEADLINE = 60.0


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def start_world(tmp_dir, inputs, world, env=None):
    """Start ``world`` ranks on ``inputs``; → the handle :func:`join_world`
    takes."""
    os.makedirs(tmp_dir, exist_ok=True)
    with open(os.path.join(tmp_dir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    port = _free_port()
    penv = dict(os.environ, OMP_NUM_THREADS="1", **(env or {}))
    penv.pop("WORLD_SIZE", None)
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(tmp_dir, f"rank{r}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(tmp_dir), str(r),
             str(world), str(port)], stdout=log, stderr=subprocess.STDOUT,
            env=penv, cwd=REPO))
    return tmp_dir, procs, logs, time.time()


def join_world(handle, deadline=DEADLINE):
    """Wait for the ranks of :func:`start_world` until ``deadline``
    seconds after their start, killing any still running then; → each
    rank's results, in rank order. Raises with the failing ranks' output
    when a rank exits non-zero or passes the deadline."""
    tmp_dir, procs, logs, t0 = handle
    try:
        for p in procs:
            p.wait(timeout=max(0.1, t0 + deadline - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        late = [r for r, p in enumerate(procs) if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for log in logs:
        log.seek(0)
        texts.append(log.read())
        log.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if late or bad:
        raise AssertionError(
            f"ranks past the {deadline:.0f} s deadline: {late}; failed: "
            f"{bad}\n" + "\n".join(f"--- rank {r}\n{texts[r][-4000:]}"
                                   for r in sorted(set(late + bad))))
    outs = []
    for r in range(len(procs)):
        with open(os.path.join(tmp_dir, f"out_{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return outs


def run_worlds(specs, deadline=DEADLINE):
    """Start every ``(tmp_dir, inputs, world, env)`` of ``specs`` at once
    and join them all; → their results, in order."""
    handles = [start_world(*spec) for spec in specs]
    outs, err = [], None
    for h in handles:
        try:
            outs.append(join_world(h, deadline))
        except AssertionError as e:        # join the rest before raising
            err = err or e
    if err:
        raise err
    return outs


# ---------------------------------------------------------------------------
# rank side


def _np(t):
    import torch
    return t.detach().to(torch.float32).cpu().numpy()


def _model(tree, cfg):
    from neural_tpu_torch.convert.from_jax import params_from_numpy
    return params_from_numpy(tree, cfg, "cpu")


def _cfg(d):
    from neural_tpu_torch.models.config import ModelConfig
    return ModelConfig(**d)


def suite_tp(inp, rank, world):
    """The twins of ``tests/test_tp.py`` and ``tests/test_multihost.py`` at
    tp = 2 (world 2) or dp = 2 × tp = 2 (world 4)."""
    import torch
    from neural_tpu_torch.api import Model
    from neural_tpu_torch.parallel import (agree, auto_mesh, checksum,
                                           is_primary, make_mesh,
                                           make_tp_decode_loop,
                                           make_tp_prefill, make_tp_step,
                                           shard_model, tp_generate)
    from neural_tpu_torch.parallel.sharding import init_cache as pinit
    from neural_tpu_torch.runtime.generate import batched_generate, model_step
    from neural_tpu_torch.runtime.kvcache import init_cache
    from neural_tpu_torch.runtime.sampling import SamplingParams
    from neural_tpu_torch.ops import _cuda

    out = {}
    dp, tp = world // 2, 2
    mesh = make_mesh(dp=dp, tp=tp, device="cpu")
    out["mesh"] = (mesh.shape, mesh.coords)
    am = auto_mesh(device="cpu")
    out["auto_mesh"] = (am.shape, am.coords, is_primary())
    out["auto_mesh_tp4"] = auto_mesh(tp=world, device="cpu").shape
    cfg = _cfg(inp["cfg"])
    B = len(inp["tokens"])
    tokens = torch.tensor(inp["tokens"])
    start = torch.zeros(B, dtype=torch.long)

    models = {}
    for quant, tree in inp["params"].items():
        whole = _model(tree, cfg)
        out.setdefault("checksum", {})[quant] = checksum(whole.param_dict())
        # every rank loaded the same weights before any keeps its shards
        agree(out["checksum"][quant], f"the {quant} weights")
        models[quant] = (whole, shard_model(whole, cfg, mesh))

    _cuda.reset_launches()
    for quant, (whole, sm) in models.items():
        step = make_tp_step(sm)
        out.setdefault("step", {})[quant] = _np(
            step(tokens, start, pinit(cfg, mesh, B, 32)))
        out.setdefault("step_single", {})[quant] = _np(model_step(
            whole, tokens, start, init_cache(cfg, B, 32, device="cpu")))
    out["routes"] = {k: v for k, v in _cuda.launch_counts().items() if v}

    # the decode continuing: a prompt, then one step on its argmax
    whole, sm = models["q4_0"]
    toks = torch.tensor(inp["cont"]["toks"])
    cache = pinit(cfg, mesh, toks.shape[0], 32)
    step = make_tp_step(sm)
    first = step(toks, torch.zeros(toks.shape[0], dtype=torch.long), cache)
    nxt = torch.argmax(first[:, -1], -1)[:, None]
    pos = torch.full((toks.shape[0],), toks.shape[1])
    out["cont"] = (_np(first), _np(step(nxt, pos, cache)))

    # int8 KV: the sharded cache's scales follow its heads
    c8 = pinit(cfg, mesh, B, 32, torch.int8)
    out["int8"] = (_np(step(tokens, start, c8)), _np(model_step(
        whole, tokens, start, init_cache(cfg, B, 32, torch.int8,
                                          device="cpu"))))

    # the mixture of experts under tp: the deferred sum (T = 4: the dense
    # mixture; T = 8: the grouped path)
    mcfg = _cfg(inp["moe_cfg"])
    mwhole = _model(inp["moe_params"], mcfg)
    msm = shard_model(mwhole, mcfg, mesh)
    for T in (4, 8):
        t = tokens[:, :T]
        out.setdefault("moe_step", {})[T] = _np(make_tp_step(msm)(
            t, start, pinit(mcfg, mesh, B, 16)))

    # the greedy and sampled decode loops
    rows = torch.tensor(inp["loop_rows"])
    lens = torch.tensor([rows.shape[1]] * rows.shape[0])
    n = inp["n_steps"]

    def prefill():
        cache = pinit(cfg, mesh, rows.shape[0], 32)
        logits = make_tp_prefill(sm)(rows, lens, cache)
        return torch.argmax(logits, -1), cache

    tok0, cache = prefill()
    out["loop_tok0"] = tok0.tolist()
    out["loop_greedy"] = make_tp_decode_loop(sm, n)(
        tok0[:, None], lens, cache).numpy()

    def sampled(sp, seed=0):
        from neural_tpu_torch.parallel import rank_generator
        tok0, cache = prefill()
        hist = torch.cat([rows, tok0[:, None]], 1)
        return make_tp_decode_loop(sm, n, sp)(
            tok0[:, None], lens, cache, rank_generator(mesh, seed, "cpu"),
            hist, torch.ones(hist.shape, dtype=torch.bool)).numpy()

    samp = SamplingParams(temperature=0.9, top_k=20, repeat_last_n=5)
    out["sampled"] = (sampled(samp), sampled(samp))
    out["cold"] = sampled(SamplingParams(temperature=1e-6, top_k=1,
                                         repeat_last_n=0, repeat_penalty=1.0))
    out["greedy"] = sampled(SamplingParams(greedy=True, repeat_last_n=0,
                                           repeat_penalty=1.0))

    # tp_generate end to end: ragged rows (3, padded to a multiple of dp),
    # greedy and sampled; at dp = 1 the sampled ids against the
    # single-device batched_generate with the same seed
    grows = inp["gen_rows"]
    g = SamplingParams(greedy=True, repeat_last_n=0)
    s = SamplingParams(temperature=0.8, top_k=30)
    out["gen_greedy"] = tp_generate(sm, cfg, mesh, grows, g, max_new_tokens=6,
                                    stop_at_eos=False, sharded=True)
    out["gen_sampled"] = tp_generate(whole, cfg, mesh, grows, s,
                                     max_new_tokens=6, stop_at_eos=False,
                                     seed=5)
    out["gen_single_sampled"] = batched_generate(
        whole, cfg, grows, s, max_new_tokens=6, stop_at_eos=False, seed=5)
    m = Model().init_params(whole, cfg)
    out["model_generate"] = m.generate(grows, max_new_tokens=6,
                                       repetition_penalty=1.0,
                                       stop_at_eos=False, mesh=mesh)
    out["model_generate_again"] = m.generate(
        grows, max_new_tokens=6, repetition_penalty=1.0, stop_at_eos=False,
        ignore_prompt=True, mesh=mesh)

    # the launcher, on a checkpoint file, in this world
    from neural_tpu_torch.parallel import run_tp
    out["run_tp"] = run_tp.main(
        ["--model", inp["ckpt"], "--prompt", " ".join(map(str, grows[0])),
         "--max-new-tokens", "6", "--max-len", "32", "--repeat-penalty",
         "1.0", "--tp", "2", "--device", "cpu"], out=lambda *a: None)

    # test_multihost's twins: "dp" (dp across the ranks' hosts, tp within:
    # LOCAL_WORLD_SIZE ranks a host) and "tp" (tp across every rank); each
    # rank checks its rows against an unsharded local reference
    for mode in ("dp", "tp"):
        mm = auto_mesh(tp=None if mode == "dp" else world, device="cpu")
        mcfg2 = _cfg(inp["mh_cfg"])
        mw = _model(inp["mh_params"], mcfg2)
        ck = checksum(mw.param_dict())
        agree(ck, "the multihost weights")
        t = torch.tensor(inp["mh_tokens"])
        st = torch.zeros(t.shape[0], dtype=torch.long)
        got = make_tp_step(shard_model(mw, mcfg2, mm))(
            t, st, pinit(mcfg2, mm, t.shape[0], 32))
        ref = model_step(mw, t, st, init_cache(mcfg2, t.shape[0], 32,
                                               device="cpu"))
        out.setdefault("multihost", {})[mode] = (
            mm.shape, ck, _np(got), _np(ref))
    return out


def _experts_block(tree, cfg, mesh, tp_in_experts: bool):
    """A stand-in for a MoE layer that holds this rank's slice of the
    ``router`` and ``experts`` of ``tree`` (a JAX per-layer dict as numpy),
    split by ``ep_param_specs``: what ``ep_moe`` reads of a Block."""
    import types
    from neural_tpu_torch.convert.from_jax import (qtensor_from_numpy,
                                                   tensor_from_numpy)
    from neural_tpu_torch.models.transformer import Experts, QLinear
    from neural_tpu_torch.ops.qmatmul import ACTS
    from neural_tpu_torch.parallel.ep import ep_param_specs
    from neural_tpu_torch.parallel.sharding import shard_params
    from neural_tpu_torch.runtime.generate import params_to_native
    lp = {"router": tensor_from_numpy(tree["router"], "cpu"), "experts": {
        k: params_to_native(qtensor_from_numpy(v, "cpu"))
        if isinstance(v, dict) else tensor_from_numpy(v, "cpu")
        for k, v in tree["experts"].items()}}
    params = {"layers": [lp]}
    lp = shard_params(params, cfg, mesh, ep_param_specs(
        params, cfg, tp=tp_in_experts))["layers"][0]
    return types.SimpleNamespace(router=QLinear(lp["router"]),
                                 experts=Experts(lp["experts"]),
                                 act=ACTS[cfg.act])


def suite_ep(inp, rank, world):
    """The twins of ``tests/test_parallel_axes.py``'s ``test_ep_*`` at ep = 2
    (world 2) and ep = 2 × tp = 2 (world 4)."""
    import torch
    from neural_tpu_torch.parallel import (ep_moe, make_mesh, make_tp_step,
                                           shard_model)
    from neural_tpu_torch.parallel.ep import ep_param_specs
    from neural_tpu_torch.parallel.sharding import init_cache as pinit
    from neural_tpu_torch.convert.from_jax import tensor_from_numpy
    from neural_tpu_torch.ops import _cuda

    out = {}
    tp = world // 2
    mesh = make_mesh(dp=1, ep=2, tp=tp, device="cpu")
    out["mesh"] = (mesh.shape, mesh.coords)
    for key, case in inp["moe"].items():
        cfg = _cfg(case["cfg"])
        blk = _experts_block(case["lp"], cfg, mesh, tp > 1)
        x = tensor_from_numpy(case["x"], "cpu")
        _cuda.reset_launches()
        y = ep_moe(x, blk, cfg, mesh, case["capacity_factor"])
        out.setdefault("moe", {})[key] = _np(y)
        out.setdefault("moe_routes", {})[key] = {
            k: v for k, v in _cuda.launch_counts().items() if v}
    for key, case in inp["model"].items():
        cfg = _cfg(case["cfg"])
        whole = _model(case["params"], cfg)
        specs = ep_param_specs(whole, cfg, tp=tp > 1)
        sm = shard_model(whole, cfg, mesh, specs)
        t = torch.tensor(case["tokens"])
        st = torch.zeros(t.shape[0], dtype=torch.long)
        out.setdefault("model", {})[key] = _np(make_tp_step(sm)(
            t, st, pinit(cfg, mesh, t.shape[0], 16)))
        out.setdefault("local_experts", {})[key] = \
            sm.layers[0].experts.w_up.param.__class__.__name__, tuple(
                (sm.layers[0].experts.w_up.param.planes[0]
                 if hasattr(sm.layers[0].experts.w_up.param, "planes")
                 else sm.layers[0].experts.w_up.param).shape)
    return out


def _dense(tree, cfg):
    """The param dict of a JAX f32 tree, on the CPU (f32 leaves kept)."""
    return _model(tree, cfg).param_dict()


def suite_collectives(inp, rank, world):
    """Each differentiable collective of the mesh, forward and backward, on
    a (dp, sp, tp) = (2, 2, 2) mesh: x and the upstream cotangent c are
    drawn from the rank's seed, the loss is sum(y · c); the parent holds the
    gradients against the JAX transposes."""
    import torch
    from neural_tpu_torch.parallel import make_mesh
    mesh = make_mesh(dp=2, sp=2, tp=2, device="cpu")
    gen = torch.Generator().manual_seed(100 + rank)
    out = {"coords": mesh.coords}
    cases = {
        "psum_tp": lambda x: mesh.psum(x, "tp"),
        "psum_sp_tp": lambda x: mesh.psum(x, ("sp", "tp")),
        "all_gather_tp": lambda x: mesh.all_gather(x, "tp", dim=1),
        "all_to_all_sp": lambda x: mesh.all_to_all(x, "sp"),
        "ppermute_ring_sp": lambda x: mesh.ppermute(x, "sp", [(0, 1),
                                                               (1, 0)]),
        "ppermute_one_sp": lambda x: mesh.ppermute(x, "sp", [(0, 1)]),
    }
    for name, fn in cases.items():
        x = torch.randn(2, 3, generator=gen, requires_grad=True)
        y = fn(x)
        c = torch.randn(y.shape, generator=gen)
        (g,) = torch.autograd.grad((y * c).sum(), x)
        with torch.no_grad():
            y0 = fn(x.detach().clone())         # the in-place forms
        out[name] = dict(x=_np(x), y=_np(y), c=_np(c), g=_np(g),
                         y_nograd=_np(y0))
    return out


def suite_sp(inp, rank, world):
    """Ring attention: (sp, tp) = (4, 1) on ranks 0-3 and (2, 2) on ranks
    4-7, at once, plus GQA with a sliding window at sp = 4; each rank also
    runs the one-device cache-less forward. Then the collectives' suite
    over all 8 ranks."""
    import torch
    from neural_tpu_torch.parallel import (make_mesh,
                                           sequence_sharded_forward,
                                           shard_model)
    from neural_tpu_torch.ops import _cuda
    out = {}
    m41 = make_mesh(dp=1, sp=4, tp=1, device="cpu", ranks=[0, 1, 2, 3])
    m22 = make_mesh(dp=1, sp=2, tp=2, device="cpu", ranks=[4, 5, 6, 7])
    mesh = m41 or m22
    for key, case in inp["cases"].items():
        if (case["mesh"] == "4,1") != (m41 is not None):
            continue
        cfg = _cfg(case["cfg"])
        whole = _model(case["params"], cfg)
        t = torch.tensor(case["tokens"])
        _cuda.reset_launches()
        with torch.no_grad():
            got = sequence_sharded_forward(shard_model(whole, cfg, mesh), t,
                                           gather=True)
            one = whole(t, torch.zeros(t.shape[0], dtype=torch.long), None)
        out[key] = dict(got=_np(got), one=_np(one), routes={
            k: v for k, v in _cuda.launch_counts().items() if v})
    out["coll"] = suite_collectives(inp, rank, world)
    return out


def suite_pp(inp, rank, world):
    """``make_pp_train_step`` at (pp, tp, dp) = (2, 2, 2) and (4, 1, 2) over
    the 8 ranks and (2, 1, 1) over ranks 0-1: each rank's loss, and its
    shards of the updated ``embed``, ``layers[*].wq`` and ``lm_head``."""
    import torch
    from neural_tpu_torch.parallel import (make_mesh, make_pp_train_step,
                                           pp_shard_params)
    from neural_tpu_torch.ops import _cuda
    out = {}
    cfg = _cfg(inp["cfg"])
    params = _dense(inp["params"], cfg)
    for key, (pp, tp, dp) in inp["cases"].items():
        mesh = make_mesh(dp=dp, pp=pp, tp=tp, device="cpu",
                         ranks=list(range(pp * tp * dp)))
        if mesh is None:
            continue
        step = make_pp_train_step(params, cfg, mesh, n_microbatches=2,
                                  lr=inp["lr"])
        local = pp_shard_params(params, cfg, mesh)
        _cuda.reset_launches()
        loss, new = step(local, torch.tensor(inp["tokens"][key]))
        out[key] = dict(coords=mesh.coords, loss=float(loss),
                        embed=_np(new["embed"]),
                        wq=[_np(lp["wq"]) for lp in new["layers"]],
                        lm_head=_np(new["lm_head"]),
                        attn_norm=[_np(lp["attn_norm_w"])
                                   for lp in new["layers"]],
                        routes={k: v for k, v in
                                _cuda.launch_counts().items() if v})
    return out


def suite_moe_train(inp, rank, world):
    """``make_moe_train_step`` at each (sp, ep) of ``inp["cases"]``, over
    the first sp · ep ranks, on the JAX tree's f32 Mixtral, with a capacity
    factor of E (nothing dropped): each rank's loss, and its shards of the
    updated ``embed``, every layer's ``wq``, ``router`` and experts'
    ``w_up`` (this rank's experts)."""
    import torch
    from neural_tpu_torch.parallel import (make_mesh, make_moe_train_step,
                                           shard_params)
    from neural_tpu_torch.parallel.ep import ep_param_specs
    out = {}
    cfg = _cfg(inp["cfg"])
    params = _dense(inp["params"], cfg)
    for key, (sp, ep) in inp["cases"].items():
        mesh = make_mesh(dp=1, sp=sp, ep=ep, tp=1, device="cpu",
                         ranks=list(range(sp * ep)))
        if mesh is None:
            continue
        local = shard_params(params, cfg, mesh,
                             ep_param_specs(params, cfg, tp=False))
        step = make_moe_train_step(params, cfg, mesh, lr=inp["lr"],
                                   capacity_factor=float(cfg.n_experts))
        loss, new = step(local, torch.tensor(inp["tokens"]))
        out[key] = dict(coords=mesh.coords, loss=float(loss),
                        embed=_np(new["embed"]),
                        **{n: [_np(lp[n]) for lp in new["layers"]]
                           for n in ("wq", "router")},
                        w_up=[_np(lp["experts"]["w_up"])
                              for lp in new["layers"]])
    return out


def suite_dryrun(inp, rank, world):
    """The port's dry run over every rank, through the launcher; then the
    MoE training step's twins (:func:`suite_moe_train`)."""
    from neural_tpu_torch.ops import _cuda
    from neural_tpu_torch.parallel import run_tp
    _cuda.reset_launches()
    out = run_tp.main(["--dryrun", "--device", "cpu"])
    out["routes"] = {k: v for k, v in _cuda.launch_counts().items() if v}
    out["moe_train"] = suite_moe_train(inp["moe_train"], rank, world)
    return out


SUITES = {"tp": suite_tp, "ep": suite_ep, "sp": suite_sp, "pp": suite_pp,
          "dryrun": suite_dryrun}


def main():
    d, rank, world, port = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
        sys.argv[4]
    sys.path.insert(0, REPO)
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from neural_tpu_torch.parallel import init_distributed
    with open(os.path.join(d, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    init_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo",
                     timeout=RANK_TIMEOUT)
    out = SUITES[inp["suite"]](inp, rank, world)
    with open(os.path.join(d, f"out_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
