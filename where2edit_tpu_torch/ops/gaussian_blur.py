"""Gaussian blur matching torchvision's ``gaussian_blur`` (counterpart of
where2edit_tpu/ops/gaussian_blur.py): default sigma
``0.3 * ((ksize - 1) * 0.5 - 1) + 0.8``, reflect padding, two separable
depthwise passes, NHWC."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _gaussian_kernel1d(ksize: int, sigma: float | None, like: torch.Tensor) -> torch.Tensor:
    """Normalised 1-D taps, built on ``like``'s device (no host copy)."""
    if sigma is None:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = torch.arange(ksize, dtype=torch.float32, device=like.device) - (ksize - 1) / 2
    k = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).to(like.dtype)


def gaussian_blur(x: torch.Tensor, ksize: int = 5,
                  sigma: float | None = None) -> torch.Tensor:
    c = x.shape[-1]
    k1 = _gaussian_kernel1d(ksize, sigma, x)
    pad = ksize // 2
    xc = F.pad(x.permute(0, 3, 1, 2), [pad, pad, pad, pad], mode="reflect")
    xc = F.conv2d(xc, k1.view(1, 1, ksize, 1).expand(c, 1, ksize, 1), groups=c)
    xc = F.conv2d(xc, k1.view(1, 1, 1, ksize).expand(c, 1, 1, ksize), groups=c)
    return xc.permute(0, 2, 3, 1)
