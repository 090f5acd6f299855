"""SSIM (counterpart of where2edit_tpu/eval/ssim.py; Wang et al. 2004
defaults: an 11×11 Gaussian window of σ 1.5, K1 = 0.01, K2 = 0.03), on
NHWC batches."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_window(ksize: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    k /= k.sum()
    return np.outer(k, k).astype(np.float32)


def _filter(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Depthwise VALID filter of NCHW ``x``."""
    c = x.shape[1]
    return F.conv2d(x, win[None, None].expand(c, 1, *win.shape), groups=c)


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 2.0) -> torch.Tensor:
    """Mean SSIM over an NHWC batch (the generator's [-1, 1] range is
    ``data_range`` 2)."""
    a = a.float().permute(0, 3, 1, 2)
    b = b.float().permute(0, 3, 1, 2)
    win = torch.from_numpy(_gaussian_window()).to(a.device)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a = _filter(a, win)
    mu_b = _filter(b, win)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sig_a = _filter(a * a, win) - mu_aa
    sig_b = _filter(b * b, win) - mu_bb
    sig_ab = _filter(a * b, win) - mu_ab
    num = (2 * mu_ab + c1) * (2 * sig_ab + c2)
    den = (mu_aa + mu_bb + c1) * (sig_a + sig_b + c2)
    return (num / den).mean()
