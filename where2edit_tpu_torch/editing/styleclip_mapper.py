"""The StyleCLIP mapper composite (counterpart of
where2edit_tpu/editing/styleclip_mapper.py): a latent mapper, the frozen
generator it edits through and the 256² face pool."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from where2edit_tpu_torch.editing import latent_mappers
from where2edit_tpu_torch.ops.interpolate import adaptive_avg_pool

MAPPER_TYPES = {
    "SingleMapper": latent_mappers.SingleMapper,
    "LevelsMapper": latent_mappers.LevelsMapper,
    "FullStyleSpaceMapper": latent_mappers.FullStyleSpaceMapper,
    "WithoutToRGBStyleSpaceMapper": latent_mappers.WithoutToRGBStyleSpaceMapper,
}
LEVELS_FLAGS = ("no_coarse_mapper", "no_medium_mapper", "no_fine_mapper")


def build_mapper(mapper_type: str, /, **kwargs) -> nn.Module:
    """The mapper ``mapper_type`` names. Of ``kwargs`` (an opts dict may be
    passed whole) it takes ``rng``, the ``no_*`` flags for ``LevelsMapper``
    and ``n_styles`` for the StyleSpace mappers; the rest is ignored."""
    cls = MAPPER_TYPES[mapper_type]
    accepted = {"rng"}
    if mapper_type == "LevelsMapper":
        accepted.update(LEVELS_FLAGS)
    elif issubclass(cls, latent_mappers.FullStyleSpaceMapper):
        accepted.add("n_styles")
    return cls(**{k: v for k, v in kwargs.items() if k in accepted})


class StyleCLIPMapper(nn.Module):
    """``edit(w)``: ``w + 0.1·mapper(w)`` (per style vector in S-space),
    decoded with the generator's fixed noise; returns (image, edited
    latent)."""

    def __init__(self, mapper: nn.Module, decoder: nn.Module,
                 latent_avg: Optional[torch.Tensor] = None,
                 work_in_stylespace: bool = False):
        super().__init__()
        self.mapper = mapper
        self.decoder = decoder
        self.latent_avg = latent_avg
        self.work_in_stylespace = work_in_stylespace

    def edit(self, w):
        if self.work_in_stylespace:
            delta = self.mapper(w)
            w_hat = [c + 0.1 * d for c, d in zip(w, delta)]
            out = self.decoder(w_hat, input_is_stylespace=True,
                               randomize_noise=False)
        else:
            w_hat = w + 0.1 * self.mapper(w)
            out = self.decoder([w_hat], input_is_latent=True,
                               randomize_noise=False)
        return out.image, w_hat

    def face_pool(self, images: torch.Tensor) -> torch.Tensor:
        return adaptive_avg_pool(images, 256)
