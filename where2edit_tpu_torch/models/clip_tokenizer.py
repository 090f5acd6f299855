"""CLIP BPE tokenizer (OpenAI ``SimpleTokenizer`` algorithm), a pure-Python
copy of where2edit_tpu/models/clip_tokenizer.py for the port.

With the ``bpe_simple_vocab_16e6`` merges file (constructor path or
``$CLIP_BPE_PATH``) the ids are OpenAI's. Without one, the byte-level base
vocabulary applies (no merges): every byte of a word is one token, with the
ids of the real vocabulary's first 512 rows, and SOT/EOT keep their real
ids 49406/49407.
"""

from __future__ import annotations

import gzip
import html
import os
import re
import unicodedata
from functools import lru_cache

import numpy as np

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408

# OpenAI's pattern uses the unicode \p{L}/\p{N} classes of the `regex`
# module; the stdlib-`re` ASCII approximation is the fallback without it.
try:
    import regex as _regex

    _PAT = _regex.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
        r"""|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _regex.IGNORECASE,
    )
except ImportError:  # pragma: no cover
    _regex = re
    _PAT = re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
        re.IGNORECASE,
    )


@lru_cache()
def bytes_to_unicode():
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    return {(a, b) for a, b in zip(word[:-1], word[1:])}


def _clean(text: str) -> str:
    """basic_clean + whitespace_clean; NFC stands in for ftfy.fix_text."""
    text = unicodedata.normalize("NFC", text)
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text)
    return text.strip().lower()


class SimpleTokenizer:
    def __init__(self, bpe_path: str | None = None):
        bpe_path = bpe_path or os.environ.get("CLIP_BPE_PATH")
        self.byte_encoder = bytes_to_unicode()
        base = list(self.byte_encoder.values())
        vocab = base + [v + "</w>" for v in base]
        merges = []
        if bpe_path and os.path.isfile(bpe_path):
            opener = gzip.open if bpe_path.endswith(".gz") else open
            with opener(bpe_path, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")[1: 49152 - 256 - 2 + 1]
            merges = [tuple(m.split()) for m in lines]
            vocab += ["".join(m) for m in merges]
            vocab += ["<|startoftext|>", "<|endoftext|>"]
            self.encoder = dict(zip(vocab, range(len(vocab))))
        else:
            self.encoder = dict(zip(vocab, range(len(vocab))))
            self.encoder["<|startoftext|>"] = VOCAB_SIZE - 2
            self.encoder["<|endoftext|>"] = VOCAB_SIZE - 1
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for token in _regex.findall(_PAT, _clean(text)):
            token_b = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token_b).split(" "))
        return ids


def tokenize(texts, context_length: int = CONTEXT_LENGTH, truncate: bool = True,
             tokenizer: SimpleTokenizer | None = None) -> np.ndarray:
    """clip.tokenize-compatible: (N, context_length) int32 with SOT/EOT
    framing."""
    tokenizer = tokenizer or SimpleTokenizer()
    if isinstance(texts, str):
        texts = [texts]
    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        toks = [tokenizer.sot] + tokenizer.encode(text) + [tokenizer.eot]
        if len(toks) > context_length:
            if not truncate:
                raise RuntimeError(f"input too long for context {context_length}")
            toks = toks[:context_length]
            toks[-1] = tokenizer.eot
        out[i, : len(toks)] = toks
    return out
