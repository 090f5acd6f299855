"""The port's CLIP text tower and tokenizer against the JAX package's.

Text tower: 2 layers at the ViT-B/32 widths (512, 8 heads, context 77,
vocab 49408), same weights, tolerance 1e-4 (fp32; LayerNorm and softmax
keep the values O(1)). Tokenizer: the vendored goldens of
tests/data/clip_tokenizer_golden.json (the pattern of
tests/test_clip_tokenizer_golden.py).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from where2edit_tpu.models.clip_model import TextTransformer as JText
from where2edit_tpu_torch import convert
from where2edit_tpu_torch.models.clip_model import TextTransformer
from where2edit_tpu_torch.models.clip_tokenizer import (
    CONTEXT_LENGTH,
    VOCAB_SIZE,
    SimpleTokenizer,
    tokenize,
)

from torch_parity import close, np_tree

GOLDEN = json.load(open(os.path.join(os.path.dirname(__file__), "data",
                                     "clip_tokenizer_golden.json")))


def _merges_file(tmp_path, merges):
    path = tmp_path / "merges.txt"
    path.write_text("\n".join(["#version: 0.2"] + [" ".join(m) for m in merges]),
                    encoding="utf-8")
    return str(path)


def test_torch_clip_text_tower_matches_jax():
    jm = JText(layers=2)
    tokens = tokenize(["a face with grey hair", "purple hair", "",
                       "a man with a beard and big blue eyes"],
                      tokenizer=SimpleTokenizer(bpe_path=""))
    v = np_tree(jax.jit(lambda tk: jm.init(jax.random.PRNGKey(0), tk))(
        jnp.asarray(tokens)))
    want = jax.jit(jm.apply)(jax.tree.map(jnp.asarray, v), jnp.asarray(tokens))
    tm = TextTransformer(layers=2)
    tm.load_state_dict(convert.clip_text_state_dict(v))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(tokens))
    assert got.shape == (4, 512)
    close(got, want, 1e-4)


def test_torch_tokenizer_golden_without_merges(monkeypatch):
    """No merges file: the byte-level base vocabulary, whose ids equal
    OpenAI's first 512 rows (the goldens' empty-merges cases), while the
    special tokens keep their real ids (512/513 in an empty-merges file)."""
    monkeypatch.delenv("CLIP_BPE_PATH", raising=False)
    tok = SimpleTokenizer()
    assert (tok.sot, tok.eot) == (VOCAB_SIZE - 2, VOCAB_SIZE - 1)
    special = {512: tok.sot, 513: tok.eot}
    for prompt, want in GOLDEN["empty"].items():
        assert tok.encode(prompt) == [special.get(i, i) for i in want], prompt


def test_torch_tokenizer_golden_merges(tmp_path):
    tok = SimpleTokenizer(bpe_path=_merges_file(tmp_path, []))
    for prompt, want in GOLDEN["empty"].items():
        assert tok.encode(prompt) == want, prompt
    tok = SimpleTokenizer(bpe_path=_merges_file(tmp_path, GOLDEN["merges"]))
    for prompt, want in GOLDEN["syn"].items():
        assert tok.encode(prompt) == want, prompt


def test_torch_tokenize_framing(monkeypatch):
    monkeypatch.delenv("CLIP_BPE_PATH", raising=False)
    tok = SimpleTokenizer()
    arr = tokenize(["grey hair", "x " * 200], tokenizer=tok)
    assert arr.shape == (2, CONTEXT_LENGTH) and arr.dtype == np.int32
    n = len(tok.encode("grey hair"))
    assert arr[0, 0] == tok.sot and arr[0, n + 1] == tok.eot
    assert arr[0, n + 2] == 0 and arr[1, -1] == tok.eot
    with pytest.raises(RuntimeError):
        tokenize(["x " * 200], tokenizer=tok, truncate=False)
