"""Tokenizers over a GGUF vocab (port of ``neural_tpu/tokenizer.py``, pure
Python, the port's own copy).

Reference: model_tokenize / model_tokenizer_t (model_utils.cpp:397-620) —
the llama.cpp SPM bigram-merge algorithm over the vocab+scores stored in
the model file, with byte fallback; and GPT-2's byte-level BPE over a
vocab and merges list. A GGUF file's ``tokenizer.ggml.model`` picks one
(:func:`tokenizer_from_gguf`). The port has no HF tokenizer class: a
decoder loaded from an HF directory has none (the JAX package asks
transformers for one); a Whisper directory's byte-level BPE
``tokenizer.json`` is read by :meth:`BPETokenizer.from_hf_json`.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence


class SPMTokenizer:
    def __init__(self, tokens: Sequence[str], scores: Sequence[float],
                 bos_id: int = 1, eos_id: int = 2, unk_id: int = 0,
                 add_space_prefix: bool = True):
        self.tokens = list(tokens)
        self.scores = list(scores)
        self.bos_id, self.eos_id, self.unk_id = bos_id, eos_id, unk_id
        self.add_space_prefix = add_space_prefix
        self.t2i: Dict[str, int] = {t: i for i, t in enumerate(self.tokens)}
        self.byte_ids: Dict[int, int] = {}
        for b in range(256):
            tok = f"<0x{b:02X}>"
            if tok in self.t2i:
                self.byte_ids[b] = self.t2i[tok]

    @classmethod
    def from_gguf(cls, reader) -> "SPMTokenizer":
        kv = reader.kv
        return cls(kv["tokenizer.ggml.tokens"],
                   list(kv.get("tokenizer.ggml.scores",
                               [0.0] * len(kv["tokenizer.ggml.tokens"]))),
                   bos_id=int(kv.get("tokenizer.ggml.bos_token_id", 1)),
                   eos_id=int(kv.get("tokenizer.ggml.eos_token_id", 2)),
                   unk_id=int(kv.get("tokenizer.ggml.unknown_token_id", 0)))

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        """Greedy bigram merge by score (llama.cpp llm_tokenizer_spm)."""
        if self.add_space_prefix:
            text = " " + text
        text = text.replace(" ", "▁")
        # initial symbols: utf-8 characters
        symbols: List[str] = list(text)

        # merge loop: repeatedly merge the adjacent pair with best score
        def pair_score(a: str, b: str):
            tid = self.t2i.get(a + b)
            return None if tid is None else self.scores[tid]

        heap = []
        alive = list(range(len(symbols)))
        prev = [i - 1 for i in range(len(symbols))]
        nxt = [i + 1 if i + 1 < len(symbols) else -1
               for i in range(len(symbols))]
        text_at = {i: s for i, s in enumerate(symbols)}
        counter = 0
        for i in range(len(symbols) - 1):
            sc = pair_score(symbols[i], symbols[i + 1])
            if sc is not None:
                heapq.heappush(heap, (-sc, counter, i, i + 1,
                                      symbols[i] + symbols[i + 1]))
                counter += 1
        while heap:
            negsc, _, li, ri, merged = heapq.heappop(heap)
            if li not in text_at or ri not in text_at:
                continue
            if text_at[li] + text_at[ri] != merged:
                continue
            text_at[li] = merged
            del text_at[ri]
            rn = nxt[ri]
            nxt[li] = rn
            if rn != -1:
                prev[rn] = li
            ln = prev[li]
            if ln != -1 and ln in text_at:
                sc = pair_score(text_at[ln], text_at[li])
                if sc is not None:
                    heapq.heappush(heap, (-sc, counter, ln, li,
                                          text_at[ln] + text_at[li]))
                    counter += 1
            if rn != -1 and rn in text_at:
                sc = pair_score(text_at[li], text_at[rn])
                if sc is not None:
                    heapq.heappush(heap, (-sc, counter, li, rn,
                                          text_at[li] + text_at[rn]))
                    counter += 1

        ids: List[int] = [self.bos_id] if add_bos else []
        for i in sorted(text_at):
            piece = text_at[i]
            tid = self.t2i.get(piece)
            if tid is not None:
                ids.append(tid)
            else:  # byte fallback (model_utils.cpp unk/byte path)
                for b in piece.encode("utf-8"):
                    ids.append(self.byte_ids.get(b, self.unk_id))
        return ids

    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        out = []
        byte_buf = bytearray()

        def flush():
            if byte_buf:
                out.append(byte_buf.decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            if skip_special and i in (self.bos_id, self.eos_id):
                continue
            t = self.tokens[i]
            if t.startswith("<0x") and t.endswith(">") and len(t) == 6:
                byte_buf.append(int(t[3:5], 16))
                continue
            flush()
            out.append(t)
        flush()
        s = "".join(out).replace("▁", " ")
        return s[1:] if self.add_space_prefix and s.startswith(" ") else s


# ---------------------------------------------------------------------------
# Byte-level BPE (GPT-2 style) — for GGUF checkpoints whose vocab is
# `tokenizer.ggml.model == "gpt2"` (qwen, starcoder, falcon, bloom, gptneox,
# mpt...). Reference: the NE vocab loader keeps merges implicit in token
# order; HF-side tokenization otherwise (neural_speed __init__.py picks the
# HF tokenizer). We implement the classic byte-level BPE so GGUF-only
# checkpoints tokenize with no HF assets present.
# ---------------------------------------------------------------------------

def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte→printable-unicode map."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _is_letter(c: str) -> bool:
    import unicodedata
    return unicodedata.category(c).startswith("L")


def _is_number(c: str) -> bool:
    import unicodedata
    return unicodedata.category(c).startswith("N")


def _gpt2_split(text: str) -> List[str]:
    """The GPT-2 pretokenizer regex
    ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``
    implemented as a scanner (no `regex` dependency at runtime)."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        for c in _CONTRACTIONS:
            if text.startswith(c, i):
                out.append(c)
                i += len(c)
                break
        else:
            c0 = text[i]
            k = i + 1 if (c0 == " " and i + 1 < n) else i
            c = text[k] if k < n else ""
            if c and _is_letter(c):
                j = k + 1
                while j < n and _is_letter(text[j]):
                    j += 1
            elif c and _is_number(c):
                j = k + 1
                while j < n and _is_number(text[j]):
                    j += 1
            elif c and not c.isspace():
                j = k + 1
                while j < n and not (text[j].isspace() or _is_letter(text[j])
                                     or _is_number(text[j])):
                    j += 1
            else:
                j = i + 1
                while j < n and text[j].isspace():
                    j += 1
                if j < n and j - i > 1:
                    j -= 1   # \s+(?!\S): leave one ws char for the next token
                out.append(text[i:j])
                i = j
                continue
            out.append(text[i:j])
            i = j
    return out


class BPETokenizer:
    """Byte-level BPE over a GGUF vocab + merges list."""

    def __init__(self, tokens: Sequence[str], merges: Sequence[str],
                 bos_id: int = -1, eos_id: int = -1, unk_id: int = -1,
                 add_bos: bool = False):
        self.tokens = list(tokens)
        self.t2i: Dict[str, int] = {t: i for i, t in enumerate(self.tokens)}
        self.ranks: Dict[tuple, int] = {}
        for r, m in enumerate(merges):
            a, _, b = m.partition(" ")
            self.ranks[(a, b)] = r
        self.bos_id, self.eos_id, self.unk_id = bos_id, eos_id, unk_id
        self.add_bos = add_bos
        self.b2u = _bytes_to_unicode()
        self.u2b = {u: b for b, u in self.b2u.items()}
        self._cache: Dict[str, List[str]] = {}

    @classmethod
    def from_gguf(cls, reader) -> "BPETokenizer":
        kv = reader.kv
        return cls(kv["tokenizer.ggml.tokens"],
                   kv.get("tokenizer.ggml.merges", []),
                   bos_id=int(kv.get("tokenizer.ggml.bos_token_id", -1)),
                   eos_id=int(kv.get("tokenizer.ggml.eos_token_id", -1)),
                   unk_id=int(kv.get("tokenizer.ggml.unknown_token_id", -1)),
                   add_bos=bool(kv.get("tokenizer.ggml.add_bos_token",
                                       False)))

    @classmethod
    def from_hf_json(cls, path: str) -> "BPETokenizer":
        """An HF ``tokenizer.json`` of a byte-level BPE model (Whisper's,
        GPT-2's): its ``model.vocab`` and ``model.merges`` (each "a b" or
        [a, b]) and its ``added_tokens`` (the special tokens, by id)."""
        import json
        with open(path, encoding="utf-8") as fh:
            d = json.load(fh)
        ids = dict(d["model"]["vocab"])
        for t in d.get("added_tokens", []):
            ids[t["content"]] = int(t["id"])
        tokens = [""] * (max(ids.values()) + 1)
        for t, i in ids.items():
            tokens[i] = t
        merges = [m if isinstance(m, str) else " ".join(m)
                  for m in d["model"].get("merges", [])]
        eos = ids.get("<|endoftext|>", -1)
        return cls(tokens, merges, eos_id=eos, unk_id=eos)

    def convert_tokens_to_ids(self, token: str) -> int:
        """The id of one vocab entry (``"<|en|>"``); a token the vocab
        lacks raises, where an HF tokenizer answers its unk id."""
        if token not in self.t2i:
            raise KeyError(f"{token!r} is not in the vocabulary")
        return self.t2i[token]

    def _bpe(self, word: str) -> List[str]:
        if word in self._cache:
            return self._cache[word]
        parts = list(word)
        while len(parts) > 1:
            pairs = [(self.ranks.get((parts[i], parts[i + 1]), 1 << 60), i)
                     for i in range(len(parts) - 1)]
            rank, at = min(pairs)
            if rank >= 1 << 60:
                break
            merged = parts[at] + parts[at + 1]
            # merge every occurrence of this pair (left to right)
            out, i = [], 0
            while i < len(parts):
                if (i < len(parts) - 1 and parts[i] == parts[at]
                        and parts[i + 1] == parts[at + 1]):
                    out.append(merged)
                    i += 2
                else:
                    out.append(parts[i])
                    i += 1
            parts = out
        self._cache[word] = parts
        return parts

    def encode(self, text: str, add_bos: Optional[bool] = None) -> List[int]:
        ids: List[int] = []
        if (self.add_bos if add_bos is None else add_bos) \
                and self.bos_id >= 0:
            ids.append(self.bos_id)
        for tok in _gpt2_split(text):
            mapped = "".join(self.b2u[b] for b in tok.encode("utf-8"))
            for piece in self._bpe(mapped):
                tid = self.t2i.get(piece)
                if tid is not None:
                    ids.append(tid)
                else:   # decompose unknown pieces to byte tokens
                    for ch in piece:
                        ids.append(self.t2i.get(ch, self.unk_id))
        return ids

    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        chars = []
        for i in ids:
            if skip_special and i in (self.bos_id, self.eos_id):
                continue
            chars.append(self.tokens[i])
        data = bytes(self.u2b.get(c, ord("?")) for c in "".join(chars))
        return data.decode("utf-8", errors="replace")


def tokenizer_from_gguf(reader):
    """Pick the tokenizer family a GGUF file declares
    (``tokenizer.ggml.model``: "llama"/"spm" → SPM bigram-merge,
    "gpt2"/"bpe" → byte-level BPE)."""
    model = reader.kv.get("tokenizer.ggml.model", "llama")
    if model in ("gpt2", "bpe"):
        return BPETokenizer.from_gguf(reader)
    return SPMTokenizer.from_gguf(reader)
