"""The port's tokenizers against the JAX package's on the same vocabularies
and strings: SPM (bigram merges by score, byte fallback) and byte-level
BPE (GPT-2 pretokenizer, merges by rank) ``encode``/``decode`` equal on a
fixed set of strings (unicode, byte fallback, contractions, spaces), and
``tokenizer_from_gguf``'s dispatch on a GGUF file's ``tokenizer.ggml.model``.
"""
import numpy as np
import pytest

from neural_tpu import tokenizer as J
from neural_tpu.convert.gguf import GGUFWriter as JWriter

from neural_tpu_torch import tokenizer as P
from neural_tpu_torch.convert.gguf import GGUFReader

STRINGS = [
    "hello world",
    "Hello, World! It's 3.14 o'clock",
    "naïve café — 日本語 🙂",
    "  leading spaces and trailing  ",
    "tabs\tand\nnewlines\n\n",
    "don't we'll they're I'm you've he'd she's",
    "",
    "hellohello worldworld wor ld",
]


def spm_vocab():
    pieces = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    words = ["▁", "h", "e", "l", "o", "w", "r", "d", "he", "ll", "llo",
             "hello", "▁hello", "▁w", "wor", "world", "▁world", "▁t", "'",
             "s", "▁I", "'m", "▁don", "'t", "ca", "fé", "▁caf", "é", "日本",
             "語", ",", "!", "▁It", "▁3", ".", "1", "4"]
    tokens = pieces + words
    rng = np.random.default_rng(0)
    scores = [0.0] * len(pieces) + list(-rng.random(len(words)) * 10)
    return tokens, scores


def bpe_vocab():
    b2u = J._bytes_to_unicode()
    base = [b2u[b] for b in range(256)]
    merges = ["h e", "l l", "ll o", "he llo", "Ġ w", "o r", "Ġw or",
              "Ġwor ld", "' s", "' t", "' re", "Ġ I", "' m", "Ġ t", "Ġt he",
              "Ġthe y", "d o", "n '", "Ã ©", "c a", "ca f", "caf Ã©"]
    tokens = base + ["<|endoftext|>"]
    for m in merges:
        a, b = m.split(" ")
        if a + b not in tokens:
            tokens.append(a + b)
    return tokens, merges


@pytest.mark.parametrize("text", STRINGS)
def test_spm_equals_jax(text):
    tokens, scores = spm_vocab()
    j = J.SPMTokenizer(tokens, scores)
    p = P.SPMTokenizer(tokens, scores)
    for bos in (True, False):
        ids = p.encode(text, add_bos=bos)
        assert ids == j.encode(text, add_bos=bos)
        assert p.decode(ids) == j.decode(ids)
    assert p.decode(p.encode(text)) == text


@pytest.mark.parametrize("text", STRINGS)
def test_bpe_equals_jax(text):
    tokens, merges = bpe_vocab()
    eos = tokens.index("<|endoftext|>")
    j = J.BPETokenizer(tokens, merges, bos_id=eos, eos_id=eos)
    p = P.BPETokenizer(tokens, merges, bos_id=eos, eos_id=eos)
    for bos in (True, False, None):
        ids = p.encode(text, add_bos=bos)
        assert ids == j.encode(text, add_bos=bos)
        assert p.decode(ids) == j.decode(ids)
    assert p.decode(p.encode(text)) == text
    assert P._gpt2_split(text) == J._gpt2_split(text)


@pytest.mark.parametrize("model,kind", [("llama", "SPMTokenizer"),
                                        ("gpt2", "BPETokenizer"),
                                        (None, "SPMTokenizer")])
def test_tokenizer_from_gguf(tmp_path, model, kind):
    """A GGUF file's vocab through the port's reader: the declared family
    (SPM when the file names none), its special ids, and the same ids as
    JAX's tokenizer on the same file."""
    from neural_tpu.convert.gguf import GGUFReader as JReader
    path = str(tmp_path / "v.gguf")
    w = JWriter(path)
    if model == "gpt2":
        tokens, merges = bpe_vocab()
        w.add_kv("tokenizer.ggml.merges", merges)
    else:
        tokens, scores = spm_vocab()
        w.add_kv("tokenizer.ggml.scores", np.asarray(scores, np.float32))
    if model is not None:
        w.add_kv("tokenizer.ggml.model", model)
    w.add_kv("tokenizer.ggml.tokens", tokens)
    w.add_kv("tokenizer.ggml.bos_token_id", 1)
    w.add_kv("tokenizer.ggml.eos_token_id", 2)
    w.add_tensor("x", np.zeros((1, 32), np.float32), 0)
    w.write()
    r, jr = GGUFReader(path), JReader(path)
    tok, jtok = P.tokenizer_from_gguf(r), J.tokenizer_from_gguf(jr)
    assert type(tok).__name__ == kind == type(jtok).__name__
    assert (tok.bos_id, tok.eos_id) == (1, 2)
    for text in STRINGS:
        assert tok.encode(text) == jtok.encode(text)
    r.close()
    jr.close()
