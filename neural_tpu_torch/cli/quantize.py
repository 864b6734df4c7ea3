"""File → file quantization, the port's ``scripts/quantize.py`` (its flags,
plus ``--device``):

    python -m neural_tpu_torch.cli.quantize --model_file m.gguf \
        --out_file m_q4.ntpu --weight_dtype int4 --group_size 32

Input: a GGUF or NTPU file, or an HF directory; output: an NTPU file
(``Model.quant_model``; a ``.gguf`` output raises, naming
``convert.gguf_models.export_gguf``).
"""
from __future__ import annotations

import argparse

from ._common import add_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m neural_tpu_torch.cli."
                                 "quantize")
    ap.add_argument("--model_file", required=True,
                    help="input GGUF/.ntpu file or HF dir")
    ap.add_argument("--out_file", required=True)
    ap.add_argument("--weight_dtype", default="int4")
    ap.add_argument("--alg", default="sym", choices=["sym", "asym"])
    ap.add_argument("--group_size", type=int, default=32)
    ap.add_argument("--scale_dtype", default="fp32",
                    choices=["fp32", "bf16"])
    ap.add_argument("--compute_dtype", default="int8",
                    choices=["int8", "bf16", "fp32"])
    ap.add_argument("--use_ggml", action="store_true")
    add_device(ap)
    return ap.parse_args(argv)


def main(argv=None, out=print):
    from ..api import Model
    args = parse_args(argv)
    Model.quant_model(args.model_file, args.out_file,
                      weight_dtype=args.weight_dtype, alg=args.alg,
                      group_size=args.group_size,
                      scale_dtype=args.scale_dtype,
                      compute_dtype=args.compute_dtype,
                      use_ggml=args.use_ggml, device=args.device)
    out(f"wrote {args.out_file}")
    return args.out_file


if __name__ == "__main__":
    main()
