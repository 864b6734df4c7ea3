"""Generation from a converted checkpoint, the port's ``scripts/inference.py``
(its gpt_params-style flags, plus ``--device``):

    python -m neural_tpu_torch.cli.inference --model m.ntpu --ids 1,2,3 -n 32

Prints the decoded text when the model has a tokenizer (a GGUF file's
vocabulary), else the ids. ``--memory_dtype`` is read as the JAX script
reads it: its generate call passes no KV dtype, so the cache is bf16.
"""
from __future__ import annotations

import argparse

from ._common import add_device, load, tokenizer


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m neural_tpu_torch.cli."
                                 "inference")
    ap.add_argument("--model", "-m", required=True,
                    help=".ntpu/.gguf file or HF dir")
    ap.add_argument("--prompt", "-p", default="Once upon a time")
    ap.add_argument("--ids", help="comma-separated token ids (skips "
                                  "tokenizer)")
    ap.add_argument("--n_predict", "-n", type=int, default=32)
    ap.add_argument("--ctx_size", "-c", type=int, default=0)
    ap.add_argument("--seed", "-s", type=int, default=0)
    ap.add_argument("--repeat_penalty", type=float, default=1.1)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--top_k", type=int, default=40)
    ap.add_argument("--top_p", type=float, default=0.95)
    ap.add_argument("--do_sample", action="store_true")
    ap.add_argument("--num_beams", type=int, default=1)
    ap.add_argument("--shift_roped_k", action="store_true",
                    help="StreamingLLM ring-KV infinite inference")
    ap.add_argument("--memory_dtype", default="bfloat16",
                    choices=["bfloat16", "int8", "f16", "auto"],
                    help="KV cache dtype (f16/auto map to bfloat16)")
    add_device(ap)
    return ap.parse_args(argv)


def main(argv=None, out=print):
    args = parse_args(argv)
    m = load(args.model, args.device)
    if args.ids:
        ids = [int(x) for x in args.ids.split(",")]
    else:
        ids = tokenizer(m, "--prompt").encode(args.prompt)
    res = m.generate(
        [ids], max_new_tokens=args.n_predict, do_sample=args.do_sample,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        repetition_penalty=args.repeat_penalty, num_beams=args.num_beams,
        seed=args.seed, streaming=args.shift_roped_k,
        max_len=args.ctx_size or None)[0]
    out(m.tokenizer.decode(res) if m.tokenizer is not None else res)
    return res


if __name__ == "__main__":
    main()
