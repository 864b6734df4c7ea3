"""What the port's command-line tools share: the ``--device`` flag, loading
a model file or directory, and the tokenizer a text flag needs."""
from __future__ import annotations

import os


def add_device(ap):
    ap.add_argument("--device", help="'cpu' for the plain path; default "
                    "the card")


def load(path: str, device=None, weight_dtype="q4_0"):
    """A ``.gguf`` / ``.ntpu`` file (``init_from_bin``) or a local HF
    directory converted at ``weight_dtype`` (``init``), onto ``device``."""
    from ..api import Model
    m = Model()
    if os.path.isfile(path):
        return m.init_from_bin(path, device=device)
    return m.init(path, weight_dtype=weight_dtype, device=device)


def tokenizer(m, flag: str):
    """The model's tokenizer, or a ValueError naming why there is none: the
    port reads the vocabulary of a GGUF file; an HF directory's tokenizer
    needs transformers, which the port does not import (pass ids)."""
    if m.tokenizer is None:
        raise ValueError(
            f"{flag} needs a tokenizer: the port has one for a GGUF file "
            "with a vocabulary; an HF directory's or an NTPU file's needs "
            "transformers' tokenizer, which the port does not use (pass "
            "token ids instead)")
    return m.tokenizer
