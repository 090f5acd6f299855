"""StyleGAN2 building blocks (counterpart of where2edit_tpu/nn)."""

from where2edit_tpu_torch.nn.layers import (
    Blur,
    ConstantInput,
    EqualLinear,
    ModulatedConv2d,
    NoiseInjection,
    PixelNorm,
    StyledConv,
    ToRGB,
    Upsample,
    pixel_norm,
)

__all__ = [
    "Blur",
    "ConstantInput",
    "EqualLinear",
    "ModulatedConv2d",
    "NoiseInjection",
    "PixelNorm",
    "StyledConv",
    "ToRGB",
    "Upsample",
    "pixel_norm",
]
