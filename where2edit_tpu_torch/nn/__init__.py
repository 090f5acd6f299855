"""StyleGAN2 building blocks (counterpart of where2edit_tpu/nn)."""

from where2edit_tpu_torch.nn.layers import (
    Blur,
    ConstantInput,
    ConvLayer,
    Downsample,
    EqualConv2d,
    EqualLinear,
    ModulatedConv2d,
    NoiseInjection,
    PixelNorm,
    ResBlock,
    ScaledLeakyReLU,
    StyledConv,
    ToRGB,
    Upsample,
    pixel_norm,
)

__all__ = [
    "Blur",
    "ConstantInput",
    "ConvLayer",
    "Downsample",
    "EqualConv2d",
    "EqualLinear",
    "ModulatedConv2d",
    "NoiseInjection",
    "PixelNorm",
    "ResBlock",
    "ScaledLeakyReLU",
    "StyledConv",
    "ToRGB",
    "Upsample",
    "pixel_norm",
]
