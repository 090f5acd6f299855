"""The StyleCLIP latent mappers (counterpart of
where2edit_tpu/editing/latent_mappers.py).

W+ mappers predict per-row latent deltas (the coach applies them as
w + 0.1·Δ); the StyleSpace mappers one delta per style vector. Parameters
use the reference's keys: ``mapping.{1..4}.weight|bias`` under each
``Mapper`` (index 0 of its Sequential is the PixelNorm), so a reference
StyleCLIP checkpoint's ``mapper.*`` entries load as they are.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from where2edit_tpu_torch.nn.layers import EqualLinear, PixelNorm

# the 26 style-vector widths at 1024²
STYLESPACE_DIMENSIONS = [512] * 15 + [256] * 3 + [128] * 3 + [64] * 3 + [32] * 2
STYLESPACE_INDICES_WITHOUT_TORGB = [
    i for i in range(len(STYLESPACE_DIMENSIONS))
    if i not in list(range(1, len(STYLESPACE_DIMENSIONS), 3))
]


def stylespace_count(size: int) -> int:
    """The number of style vectors of a generator of ``size``: conv1 and
    to_rgb1, then three per octave above 4²."""
    return 3 * int(math.log2(size)) - 4


class Mapper(nn.Module):
    """PixelNorm(dim=1) + 4 × EqualLinear(C, C, lr_mul 0.01, fused lrelu).

    The reference's quirk is kept: on a (B, rows, 512) W+ input ``dim=1``
    normalises across the rows, not the features; on the StyleSpace
    mappers' (B, C) input it is the feature axis."""

    def __init__(self, latent_dim: int = 512, rng: torch.Generator | None = None):
        super().__init__()
        self.mapping = nn.Sequential(PixelNorm(dim=1), *[
            EqualLinear(latent_dim, latent_dim, lr_mul=0.01,
                        activation="fused_lrelu", rng=rng)
            for _ in range(4)])

    def forward(self, x):
        return self.mapping(x)


class SingleMapper(nn.Module):
    """One Mapper over every W+ row (keys ``mapping.mapping.*``)."""

    def __init__(self, rng: torch.Generator | None = None):
        super().__init__()
        self.mapping = Mapper(rng=rng)

    def forward(self, x):
        return self.mapping(x)


class LevelsMapper(nn.Module):
    """Coarse (rows 0:4), medium (4:8) and fine (8:) groups, each its own
    Mapper; a ``no_*`` flag gives zeros for its group and builds no module
    for it. ``course_mapping`` is the reference's spelling."""

    def __init__(self, no_coarse_mapper: bool = False,
                 no_medium_mapper: bool = False, no_fine_mapper: bool = False,
                 rng: torch.Generator | None = None):
        super().__init__()
        self.no_coarse_mapper = no_coarse_mapper
        self.no_medium_mapper = no_medium_mapper
        self.no_fine_mapper = no_fine_mapper
        if not no_coarse_mapper:
            self.course_mapping = Mapper(rng=rng)
        if not no_medium_mapper:
            self.medium_mapping = Mapper(rng=rng)
        if not no_fine_mapper:
            self.fine_mapping = Mapper(rng=rng)

    def forward(self, x):
        groups = ((x[:, :4], self.no_coarse_mapper, "course_mapping"),
                  (x[:, 4:8], self.no_medium_mapper, "medium_mapping"),
                  (x[:, 8:], self.no_fine_mapper, "fine_mapping"))
        return torch.cat([torch.zeros_like(part) if off else getattr(self, name)(part)
                          for part, off, name in groups], dim=1)


class FullStyleSpaceMapper(nn.Module):
    """One Mapper per style vector (``mapper_{c}``, width
    ``STYLESPACE_DIMENSIONS[c]``) for the first ``n_styles`` vectors (26 at
    1024²; ``stylespace_count(size)`` for a smaller generator)."""

    def __init__(self, n_styles: int = len(STYLESPACE_DIMENSIONS),
                 rng: torch.Generator | None = None):
        super().__init__()
        self.n_styles = n_styles
        for c in self.mapped():
            self.add_module(f"mapper_{c}",
                            Mapper(STYLESPACE_DIMENSIONS[c], rng=rng))

    def mapped(self) -> list:
        """The style indices that have a Mapper."""
        return list(range(self.n_styles))

    def forward(self, styles: Sequence[torch.Tensor]) -> list:
        mapped = set(self.mapped())
        out = []
        for c, s in enumerate(styles):
            if c in mapped:
                out.append(getattr(self, f"mapper_{c}")(
                    s.reshape(s.shape[0], -1)).reshape(s.shape))
            else:
                out.append(torch.zeros_like(s))
        return out


class WithoutToRGBStyleSpaceMapper(FullStyleSpaceMapper):
    """``FullStyleSpaceMapper`` without the ToRGB style vectors (indices 1,
    4, 7, …): zeros there, and no module."""

    def mapped(self) -> list:
        return [c for c in STYLESPACE_INDICES_WITHOUT_TORGB if c < self.n_styles]
