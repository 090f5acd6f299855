"""Attention-mask post-processing (counterpart of
where2edit_tpu/editing/masks.py)."""

from __future__ import annotations

import torch

from where2edit_tpu_torch.ops.gaussian_blur import gaussian_blur


def straight_through_threshold(m: torch.Tensor, threshold: float = 0.8) -> torch.Tensor:
    """Below-threshold entries become 0 in value but keep identity gradient."""
    return torch.where(m < threshold, m - m.detach(), m)


def finalize_attention_map(m: torch.Tensor, threshold: float = 0.8,
                           blur_ksize: int = 5) -> torch.Tensor:
    """Straight-through threshold, then gaussian blur. m: NHWC."""
    return gaussian_blur(straight_through_threshold(m, threshold), blur_ksize)


def demo_threshold(m: torch.Tensor, threshold: float) -> torch.Tensor:
    """Zero below threshold."""
    return torch.where(m < threshold, torch.zeros_like(m), m)


def binarize_for_iou(m: torch.Tensor) -> torch.Tensor:
    """Below 0.8 → 0, then above 0.7 → 1: a hard 0/1 step at 0.8."""
    m = torch.where(m < 0.8, torch.zeros_like(m), m)
    return torch.where(m > 0.7, torch.ones_like(m), m)
