"""CLIP token ids of a prompt, OpenAI's byte-level base vocabulary without
merges: ``<|startoftext|>`` (49406), one id per byte of each lower-cased
word (the word's last byte in its ``</w>`` form), ``<|endoftext|>``
(49407), zero padding to 77. The ids fall in the real vocabulary's first
512 rows, so they index the CLIP text tower's embedding as real ids do."""

from __future__ import annotations

import re

SOT, EOT, CONTEXT = 49406, 49407, 77
_WORDS = re.compile(r"'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+")


def _byte_chars() -> list:
    """OpenAI's bytes_to_unicode order: the printable bytes first, then the
    others mapped above 255."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return [chr(c) for c in cs], bs


def tokenize(text: str) -> list:
    chars, order = _byte_chars()
    base = {ch: i for i, ch in enumerate(chars)}
    byte_char = dict(zip(order, chars))
    ids = [SOT]
    for word in _WORDS.findall(" ".join(text.split()).lower()):
        letters = [byte_char[b] for b in word.encode("utf-8")]
        ids += [base[c] for c in letters[:-1]] + [256 + base[letters[-1]]]
    ids = ids[:CONTEXT - 1] + [EOT]
    return ids + [0] * (CONTEXT - len(ids))
