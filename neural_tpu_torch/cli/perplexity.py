"""Sliding-window perplexity over a text file or a token file, the port's
``scripts/perplexity.py`` (its flags, plus ``--device``):

    python -m neural_tpu_torch.cli.perplexity --model m.gguf --ids t.npy \
        --ctx_size 256 --stride 128

``--text`` needs the model's tokenizer (a GGUF file's vocabulary).
"""
from __future__ import annotations

import argparse

from ._common import add_device, load, tokenizer


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m neural_tpu_torch.cli."
                                 "perplexity")
    ap.add_argument("--model", required=True)
    ap.add_argument("--text", help="plain text file")
    ap.add_argument("--ids", help=".npy int32 token file")
    ap.add_argument("--ctx_size", type=int, default=256)
    ap.add_argument("--stride", type=int, default=0,
                    help="window stride (default ctx_size/2)")
    add_device(ap)
    return ap.parse_args(argv)


def main(argv=None, out=print):
    import numpy as np
    from ..eval.perplexity import perplexity
    args = parse_args(argv)
    m = load(args.model, args.device)
    if args.ids:
        ids = np.load(args.ids).astype(np.int32).tolist()
    else:
        with open(args.text) as f:
            ids = tokenizer(m, "--text").encode(f.read())
    r = perplexity(m.params, m.cfg, ids, ctx_size=args.ctx_size,
                   stride=args.stride or None)
    out(f"perplexity: {r['ppl']:.4f} over {r['n_tokens']} tokens "
        f"(ctx {args.ctx_size})")
    return r


if __name__ == "__main__":
    main()
