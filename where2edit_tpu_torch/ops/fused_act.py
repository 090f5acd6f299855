"""Fused bias + LeakyReLU + sqrt(2) gain (counterpart of
where2edit_tpu/ops/fused_act.py): ``lrelu(x + b, 0.2) * sqrt(2)``, the bias
broadcast along the last (channel) axis."""

from __future__ import annotations

import math

import torch


def fused_leaky_relu(x: torch.Tensor, bias: torch.Tensor | None = None,
                     negative_slope: float = 0.2,
                     scale: float = math.sqrt(2.0)) -> torch.Tensor:
    if bias is not None:
        x = x + bias.to(x.dtype)
    return torch.where(x >= 0, x, x * negative_slope) * scale
