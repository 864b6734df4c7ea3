"""An HF checkpoint directory → a native ``.ntpu`` file (or a ``.gguf``),
the port's ``scripts/convert.py`` (its flags, plus ``--device``):

    python -m neural_tpu_torch.cli.convert --outtype q4_0 --outfile m.ntpu DIR

``--outtype`` f32 or bf16 keeps the projections unquantized, in that dtype
at rest (``Model.init(dtype=...)``); a preset name quantizes them. A
``.gguf`` output is written from the directory's tensors (``export_gguf``,
F32 or Q4_0 by ``--outtype``), read without transformers.
"""
from __future__ import annotations

import argparse

from ._common import add_device


class _Checkpoint:
    """A directory's ``config.json`` and tensors as ``export_gguf`` reads
    an HF model: ``.config`` attributes and ``.state_dict()``."""

    def __init__(self, path: str):
        from ..convert import files
        self.config = files.read_config(path)
        self._path = path

    def state_dict(self):
        from ..convert.stream import ShardedCheckpoint
        ck = ShardedCheckpoint(self._path)
        return {n: ck.tensor_on(n, "cpu") for n in ck.names()}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m neural_tpu_torch.cli."
                                 "convert")
    ap.add_argument("model", help="HF checkpoint directory")
    ap.add_argument("--outfile", required=True, help=".ntpu or .gguf path")
    ap.add_argument("--outtype", default="f32",
                    help="f32/bf16 (no quant) or a preset (q4_0, int8, ...)")
    ap.add_argument("--model_hub", default="huggingface")
    add_device(ap)
    return ap.parse_args(argv)


def main(argv=None, out=print):
    from ..api import Model
    args = parse_args(argv)
    if args.outfile.endswith(".gguf"):
        from ..convert.gguf_models import GGML_F32, GGML_Q4_0, export_gguf
        t = GGML_F32 if args.outtype in ("f32", "bf16") else GGML_Q4_0
        export_gguf(_Checkpoint(args.model), args.outfile, t)
    else:
        wd = None if args.outtype in ("f32", "bf16") else args.outtype
        m = Model().init(args.model, weight_dtype=wd, use_quant=wd is not None,
                         dtype="bfloat16" if args.outtype == "bf16"
                         else "float32" if args.outtype == "f32"
                         else "bfloat16",
                         model_hub=args.model_hub, device=args.device)
        m.save(args.outfile)
    out(f"wrote {args.outfile}")
    return args.outfile


if __name__ == "__main__":
    main()
