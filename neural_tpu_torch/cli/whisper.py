"""Whisper speech-to-text, the port's ``scripts/whisper_example.py`` (its
flags, plus ``--device`` and ``--weight_dtype``):

    python -m neural_tpu_torch.cli.whisper --model DIR --audio a.wav

``--model`` is a local Whisper directory (``config.json``,
``*.safetensors``; its ``tokenizer.json``, when there is one, decodes the
ids). Prints the text, or the ids without a tokenizer.
"""
from __future__ import annotations

import argparse

from ._common import add_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m neural_tpu_torch.cli."
                                 "whisper")
    ap.add_argument("--model", required=True, help="HF whisper directory")
    ap.add_argument("--audio", required=True, help="16-bit PCM WAV file")
    ap.add_argument("--max_new_tokens", type=int, default=224)
    ap.add_argument("--weight_dtype", default=None,
                    help="quantize the linears (q4_j, q4_0, int8, ...); "
                    "default f32")
    add_device(ap)
    return ap.parse_args(argv)


def main(argv=None, out=print):
    from ..api import Model
    args = parse_args(argv)
    m = Model().init_whisper(args.model, weight_dtype=args.weight_dtype,
                             device=args.device)
    ids = m.transcribe_file(args.audio, max_new_tokens=args.max_new_tokens)
    if m.tokenizer is not None:
        out(m.tokenizer.decode(ids))
    else:
        out(ids)
    return ids


if __name__ == "__main__":
    main()
