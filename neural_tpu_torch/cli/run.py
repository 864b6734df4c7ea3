"""One command to convert, quantize and generate: the port's
``scripts/run.py`` (the README's CLI; its flags, plus ``--device``):

    python -m neural_tpu_torch.cli.run --model m.gguf --prompt "Once" -n 64

``--model`` is a GGUF or NTPU file or a local HF directory (converted at
``--weight-dtype``; 'none' keeps bf16 projections). Text prompts, ``--chat``
and ``--prompt-file`` need the model's tokenizer (a GGUF file's
vocabulary); otherwise they raise, naming why.
"""
from __future__ import annotations

import argparse

from ._common import add_device, load, tokenizer


def chat_console(m, args, read=input, out=print):
    """The interactive console: multi-round chat over one KV session; GLM
    architectures get their [Round i] prompt format (``utils.prompts``)."""
    from ..utils.prompts import build_prompt
    tok = tokenizer(m, "--chat")
    arch = m.cfg.arch
    history = []
    out("== neural-tpu chat (empty line or Ctrl-D to exit) ==")
    while True:
        try:
            q = read("> ").strip()
        except EOFError:
            break
        if not q:
            break
        history.append(q)
        common = dict(max_new_tokens=args.max_new_tokens,
                      do_sample=args.do_sample,
                      temperature=args.temperature, top_k=args.top_k,
                      top_p=args.top_p, kv_dtype=args.kv_dtype,
                      max_len=args.ctx_size, ignore_prompt=True)
        if arch.startswith("chatglm"):
            m.reset_kv_cache()
            ids = tok.encode(build_prompt(arch, history))
            res = m.generate(ids, interactive=False, **common)[0]
        elif not history[:-1]:
            res = m.generate(tok.encode(q), interactive=True, **common)[0]
        else:
            res = m.generate(tok.encode("\n" + q + "\n"), interactive=True,
                             **common)[0]
        text = tok.decode(res)
        history.append(text)
        out(text)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m neural_tpu_torch.cli.run")
    ap.add_argument("--model", required=True,
                    help="HF checkpoint dir or .gguf/.ntpu file")
    ap.add_argument("--weight-dtype", default="q4_0",
                    help="quant preset (q4_0, int8, nf4, ...; 'none'=bf16)")
    ap.add_argument("--prompt", default="Once upon a time")
    ap.add_argument("--prompt-file",
                    help="file with one prompt per line → batched generate")
    ap.add_argument("--max-new-tokens", "-n", type=int, default=64)
    ap.add_argument("--ctx-size", "-c", type=int, default=None,
                    help="KV cache length (reference n_ctx)")
    ap.add_argument("--batch", "-b", type=int, default=1,
                    help="replicate --prompt into a batch of this size")
    ap.add_argument("--do-sample", action="store_true")
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--top-p", type=float, default=0.95)
    ap.add_argument("--repeat-penalty", type=float, default=1.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num-beams", type=int, default=1)
    ap.add_argument("--kv-dtype", default="bf16", choices=["bf16", "int8"],
                    help="KV cache dtype (reference memory_type)")
    ap.add_argument("--streaming-llm", action="store_true",
                    help="StreamingLLM shift-RoPE infinite inference "
                    "(reference shift_roped_k)")
    ap.add_argument("--n-keep", type=int, default=4,
                    help="StreamingLLM sink tokens (reference n_keep)")
    ap.add_argument("--n-discard", type=int, default=-1,
                    help="tokens dropped per shift; -1 = half the window "
                    "(reference n_discard)")
    ap.add_argument("--chat", action="store_true",
                    help="interactive console (ChatGLM archs get their "
                    "[Round i] prompt format)")
    ap.add_argument("--save", help="save converted model to .ntpu")
    ap.add_argument("--session", help="prompt-keyed KV session file "
                    "(reuse a matching prompt prefix)")
    add_device(ap)
    return ap.parse_args(argv)


def main(argv=None, out=print, read=input):
    args = parse_args(argv)
    wd = None if args.weight_dtype == "none" else args.weight_dtype
    m = load(args.model, args.device, wd)
    if args.save:
        m.save(args.save)
        out(f"saved to {args.save}")
    if args.chat:
        return chat_console(m, args, read, out)
    common = dict(max_new_tokens=args.max_new_tokens,
                  do_sample=args.do_sample, temperature=args.temperature,
                  top_k=args.top_k, top_p=args.top_p,
                  repetition_penalty=args.repeat_penalty,
                  num_beams=args.num_beams, seed=args.seed,
                  kv_dtype=args.kv_dtype, max_len=args.ctx_size,
                  streaming=args.streaming_llm, n_keep=args.n_keep,
                  n_discard=None if args.n_discard < 0 else args.n_discard)
    if args.prompt_file or args.batch > 1:
        tok = tokenizer(m, "--prompt-file" if args.prompt_file
                        else "--batch")
        if args.prompt_file:
            with open(args.prompt_file) as f:
                prompts = [ln.rstrip("\n") for ln in f if ln.strip()]
        else:
            prompts = [args.prompt] * args.batch
        outs = m.generate([tok.encode(p) for p in prompts],
                          ignore_prompt=True, **common)
        for p, o in zip(prompts, outs):
            out(p + tok.decode(o))
            out("---")
        return outs
    tokenizer(m, "--prompt")
    text = m.generate_text(args.prompt, session_file=args.session, **common)
    out(args.prompt + text)
    return text


if __name__ == "__main__":
    main()
