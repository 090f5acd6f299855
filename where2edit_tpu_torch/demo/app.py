"""Session construction for the demos and the CLI (counterpart of
where2edit_tpu/demo/app.py ``load_session``).

No checkpoint is loaded yet: every model is built from seeded random
weights, as the JAX package's smoke mode does when none is given.
"""

from __future__ import annotations

import torch

from where2edit_tpu_torch import resolve_device
from where2edit_tpu_torch.demo.api import EditSession
from where2edit_tpu_torch.editing.attention_mappers import (
    FullSpaceMapperFEATClusterLinStyle,
)
from where2edit_tpu_torch.models.clip_model import TextTransformer
from where2edit_tpu_torch.models.stylegan2 import Generator

# the demo's fixed attention-region prompts
REGION_PROMPTS = {
    "skin": "tanned skin",
    "nose": "narrow nose",
    "eyes": "narrow eyes",
    "eyebrows": "thin eyebrows",
    "ears": "wearing a pair of earrings",
    "mouth": "pink lipsticks",
    "hair": "grey hair",
}


def build_models(size: int = 1024, attention_layer: int = 13,
                 cluster_layer: int = 13, seed: int = 0):
    """(generator, mapper, ViT-B/32 text tower) with random weights drawn on
    the CPU from one seeded torch.Generator; the order of the draws is fixed,
    so a seed always gives the same weights."""
    rng = torch.Generator().manual_seed(seed)
    gen = Generator(size, rng=rng)
    mapper = FullSpaceMapperFEATClusterLinStyle(
        layers=gen.n_latent, attention_layer=attention_layer,
        cluster_layer=cluster_layer, generator_size=size, rng=rng)
    text = TextTransformer(rng=rng)
    return gen, mapper, text


def build_session(size: int = 1024, attention_layer: int = 13,
                  cluster_layer: int = 13, seed: int = 0,
                  device: str | torch.device | None = None) -> EditSession:
    """An S-space ``EditSession`` at ``size`` from seeded random weights, on
    ``device`` (CUDA unless the caller names another)."""
    dev = resolve_device(device)
    gen, mapper, text = build_models(size, attention_layer, cluster_layer,
                                     seed)
    gen, mapper, text = (m.to(dev).eval() for m in (gen, mapper, text))
    return EditSession(generator=gen, mapper=mapper, clip_encode_text=text,
                       attention_layer=attention_layer)
