"""Description corpus loading (a copy of where2edit_tpu/train/corpus.py,
which imports no JAX; reference utils.py:70-102).

Same parsing: per caption file sample 2 random lines, split each on [,.],
drop the trailing fragment, strip leading " and "/spaces. Missing sources
degrade gracefully (the reference hard-crashes on absent dirs).
"""

from __future__ import annotations

import json
import os
import re
import random
from dataclasses import dataclass, field


def _split_phrases(line: str) -> list[str]:
    parts = re.split(r"[,.]", line.rstrip("\n"))[:-1]
    return [p[5:] if p.startswith(" and") else p.lstrip(" ") for p in parts]


@dataclass
class Corpus:
    phrases_celeba: list = field(default_factory=list)
    phrases_face2text: list = field(default_factory=list)
    phrases_own: list = field(default_factory=list)
    sentences_celeba: list = field(default_factory=list)
    sentences_face2text: list = field(default_factory=list)

    @property
    def phrases(self) -> list:
        """The training pool (run_attention.py:970 uses celeba phrases)."""
        return self.phrases_celeba or self.phrases_own


# fixed region prompts used for the broadcast attention text
# (run_attention.py:1134) and the IoU eval (utils.py:677)
ATTENTION_PROMPTS = ["tanned skin", "narrow nose", "narrow eyes",
                     "thin eyebrows", "wearing a pair of earrings",
                     "pink lipsticks", "grey hair"]
IOU_PROMPTS = ["rosy cheeks", "big nose", "brown eyes", "bushy eyebrows",
               "large ears", "mouths are slightly open", "pink lipsticks",
               "blonde hair"]


def load_corpus(celeba_caption_dir: str | None = None,
                face2text_json: str | None = None,
                own_description_file: str | None = None,
                rng: random.Random | None = None) -> Corpus:
    rng = rng or random.Random(0)
    corpus = Corpus()

    if celeba_caption_dir and os.path.isdir(celeba_caption_dir):
        for root, _, files in os.walk(celeba_caption_dir):
            for fname in files:
                try:
                    with open(os.path.join(root, fname)) as f:
                        lines = f.readlines()
                except OSError:
                    continue
                if not lines:
                    continue
                for _ in range(2):
                    line = lines[rng.randrange(min(10, len(lines)))]
                    corpus.sentences_celeba.append(line.rstrip("\n"))
                    corpus.phrases_celeba.extend(_split_phrases(line))

    if face2text_json and os.path.isfile(face2text_json):
        with open(face2text_json) as f:
            entries = json.load(f)
        for e in entries:
            desc = e["description"].rstrip("\n")
            corpus.sentences_face2text.append(desc)
            corpus.phrases_face2text.extend(_split_phrases(desc))

    if own_description_file and os.path.isfile(own_description_file):
        with open(own_description_file) as f:
            corpus.phrases_own = [ln.rstrip("\n") for ln in f if ln.strip()]

    return corpus


def sample_training_texts(corpus: Corpus, batch: int,
                          rng: random.Random) -> list[str]:
    """Per-step text sampling (run_attention.py:1112-1123): each sample is a
    single phrase or a gaussian-gated 'A and B' pair. Powers the CLI's
    opt-in ``--text_condition`` bank (the reference computes these per step
    but discards them for image features, :1176 — see COMPONENTS.md)."""
    phrases = corpus.phrases
    singles = [phrases[rng.randrange(len(phrases))] for _ in range(batch)]
    pairs = [
        phrases[rng.randrange(len(phrases))] + " and "
        + phrases[rng.randrange(len(phrases))]
        for _ in range(batch)
    ]
    return [singles[i] if rng.gauss(0, 1) < 1 else pairs[i]
            for i in range(batch)]
