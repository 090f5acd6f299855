"""Models of the port (counterparts of where2edit_tpu/models)."""

from where2edit_tpu_torch.models.clip_model import TextTransformer
from where2edit_tpu_torch.models.stylegan2 import (
    Discriminator,
    Generator,
    GeneratorOutput,
    blend_tap_indices,
    channel_table,
)

__all__ = [
    "Discriminator",
    "Generator",
    "GeneratorOutput",
    "TextTransformer",
    "blend_tap_indices",
    "channel_table",
]
