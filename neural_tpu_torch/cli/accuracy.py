"""Task accuracy through the lm-eval harness, the port's
``scripts/accuracy.py`` (its flags, plus ``--device``):

    python -m neural_tpu_torch.cli.accuracy --model m.gguf --tasks piqa

Needs the optional lm-eval package, as ``eval.make_lm_eval_model`` does
(without it this raises, naming it; ``eval.harness.loglikelihood`` and
``score_choices`` score without it), and the model's tokenizer.
"""
from __future__ import annotations

import argparse

from ._common import add_device, load, tokenizer


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m neural_tpu_torch.cli."
                                 "accuracy")
    ap.add_argument("--model", required=True)
    ap.add_argument("--tasks", default="lambada_openai")
    ap.add_argument("--batch_size", type=int, default=1)
    ap.add_argument("--limit", type=int, default=None)
    add_device(ap)
    return ap.parse_args(argv)


def main(argv=None, out=print):
    from ..eval.harness import make_lm_eval_model
    args = parse_args(argv)
    m = load(args.model, args.device)
    lm = make_lm_eval_model(m, batch_size=args.batch_size)
    tokenizer(m, "--tasks")
    import lm_eval
    res = lm_eval.simple_evaluate(model=lm, tasks=args.tasks.split(","),
                                  limit=args.limit)
    out(res["results"])
    return res["results"]


if __name__ == "__main__":
    main()
