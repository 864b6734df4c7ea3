"""Tensor-parallel inference launcher (the port of ``scripts/run_tp.py``).

Run the same command on every rank; only the primary rank prints. Every
rank loads the whole checkpoint and keeps its shards.

Under ``torchrun``, one process a card (NCCL; the rendezvous from
torchrun's environment):

    torchrun --nproc-per-node 8 -m neural_tpu_torch.parallel.run_tp \\
        --model m.gguf --tp 8 --prompt "Once upon a time"

By hand (rank i of N, any backend):

    python -m neural_tpu_torch.parallel.run_tp --model m.gguf \\
        --coordinator host0:8476 --num-processes N --process-id i \\
        --backend gloo --tp 2

``--device cpu`` runs the plain PyTorch path on the CPU (gloo); by default
every rank runs on the card (its own under NCCL; the one card, shared,
under gloo). ``--dryrun`` runs ``parallel.dryrun.dryrun_multichip`` over
the ranks instead of a model: inference at dp × tp, the sampled TP decode
loop, the pipeline and the sp × ep MoE training steps and quantized-MoE
inference, on tiny random models.
"""
from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", help="HF dir, .gguf, or .ntpu checkpoint "
                    "(required unless --dryrun)")
    ap.add_argument("--dryrun", action="store_true",
                    help="run the multi-rank dry run of every parallel axis "
                    "(tiny random models) instead of a model")
    ap.add_argument("--weight-dtype", default="q4_0")
    ap.add_argument("--prompt", default="Once upon a time")
    ap.add_argument("--max-new-tokens", type=int, default=64)
    ap.add_argument("--max-len", type=int, default=2048)
    ap.add_argument("--do-sample", action="store_true",
                    help="sampled decode (the whole sampling pipeline)")
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--top-p", type=float, default=0.95)
    ap.add_argument("--repeat-penalty", type=float, default=1.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tp", type=int, help="tensor-parallel size "
                    "(default: the ranks of this host)")
    ap.add_argument("--dp", type=int, help="data-parallel size")
    ap.add_argument("--coordinator", help="host:port of rank 0")
    ap.add_argument("--num-processes", type=int)
    ap.add_argument("--process-id", type=int)
    ap.add_argument("--backend", choices=("gloo", "nccl"),
                    help="default: nccl with a card, else gloo")
    ap.add_argument("--device", help="'cpu' for the plain path; default "
                    "the card")
    ap.add_argument("--timeout", type=float, default=60.0,
                    help="seconds a rendezvous or collective may wait")
    return ap.parse_args(argv)


def main(argv=None, out=print):
    """Run the launcher with ``argv``; ``out`` prints on the primary rank.
    Joins the process group unless one is already up. Returns the new
    ids."""
    import torch.distributed as dist

    from ..api import Model
    from ..runtime.sampling import SamplingParams
    from .multihost import auto_mesh, init_distributed, is_primary, world
    from .sharding import shard_model
    from .tp import tp_generate

    args = parse_args(argv)
    if not args.dryrun and not args.model:
        raise SystemExit("run_tp: --model is required (or --dryrun)")
    if not dist.is_initialized() and (args.coordinator or args.num_processes
                                      or "WORLD_SIZE" in os.environ):
        init_distributed(args.coordinator, args.num_processes,
                         args.process_id, backend=args.backend,
                         timeout=args.timeout)
    if args.dryrun:
        from .dryrun import dryrun_multichip
        return dryrun_multichip(device=args.device)
    mesh = auto_mesh(tp=args.tp, dp=args.dp, device=args.device)
    log = out if is_primary() else (lambda *a, **k: None)
    log(f"mesh: {mesh.shape} over {world()} ranks "
        f"({mesh.backend or 'no process group'}, {mesh.device})")

    m = Model()
    if os.path.isfile(args.model):
        m.init_from_bin(args.model, device=mesh.device)
    else:
        m.init(args.model, weight_dtype=args.weight_dtype,
               device=mesh.device)
    model = shard_model(m.params, m.cfg, mesh)
    del m.params

    ids = m.tokenizer.encode(args.prompt) if m.tokenizer else \
        [int(x) for x in args.prompt.split()]
    sp = SamplingParams(greedy=not args.do_sample,
                        temperature=args.temperature, top_k=args.top_k,
                        top_p=args.top_p,
                        repeat_penalty=args.repeat_penalty)
    t0 = time.time()
    outs = tp_generate(model, m.cfg, mesh, [ids] * mesh.dp, sampling=sp,
                       max_new_tokens=args.max_new_tokens,
                       max_len=args.max_len, seed=args.seed, sharded=True)
    dt = time.time() - t0
    new = outs[0][len(ids):]
    log(f"generate: {len(new)} tokens in {dt:.2f}s "
        f"({len(new) / max(dt, 1e-9):.1f} tok/s, host clock)")
    if m.tokenizer:
        log(args.prompt + m.tokenizer.decode(new))
    else:
        log("output ids:", new)
    return new


if __name__ == "__main__":
    main()
