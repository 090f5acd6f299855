"""Resizes with torch ``F.interpolate`` / ``nn.AdaptiveAvgPool2d`` index
semantics (counterpart of where2edit_tpu/ops/interpolate.py), NHWC:

  * nearest: src = floor(dst · in / out);
  * bilinear, ``align_corners`` True (the e4e FPN merge) or False;
  * adaptive average pool: bin i averages [floor(i·in/out),
    ceil((i+1)·in/out)) (the pSp face pool);
  * ``avg_pool`` and ``upsample_repeat`` (nn.AvgPool2d, nn.Upsample with an
    integer scale).

Index and weight tables are built on the input's device (no host copy, so
no wait on the device's queue).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _nearest_indices(out_size: int, in_size: int, device) -> torch.Tensor:
    """floor(dst · in / out) in float64."""
    dst = torch.arange(out_size, dtype=torch.float64, device=device)
    return torch.floor(dst * (in_size / out_size)).long().clamp_(max=in_size - 1)


def interpolate_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """(N, H, W, C) -> (N, oh, ow, C). ``size``: int or (oh, ow). Integer
    down- and upscales take strided-slice and broadcast-repeat paths."""
    if isinstance(size, int):
        size = (size, size)
    oh, ow = size
    n, h, w, c = x.shape
    if (oh, ow) == (h, w):
        return x
    if h % oh == 0 and w % ow == 0:
        return x[:, :: h // oh, :: w // ow, :]
    if oh % h == 0 and ow % w == 0:
        ky, kx = oh // h, ow // w
        return x[:, :, None, :, None, :].expand(n, h, ky, w, kx, c).reshape(
            n, oh, ow, c)
    iy = _nearest_indices(oh, h, x.device)
    ix = _nearest_indices(ow, w, x.device)
    return x.index_select(1, iy).index_select(2, ix)


def _bilinear_coords(out_size: int, in_size: int, align_corners: bool, device):
    """(lo, hi, frac) source taps of each output index, computed in float64
    as torch does."""
    i = torch.arange(out_size, dtype=torch.float64, device=device)
    if align_corners:
        s = (i * (in_size - 1) / (out_size - 1) if out_size > 1
             else torch.zeros_like(i))
    else:
        s = (i + 0.5) * in_size / out_size - 0.5
    s = s.clamp(0.0, in_size - 1)
    lo = torch.floor(s)
    frac = (s - lo).float()
    lo = lo.long()
    return lo, (lo + 1).clamp_(max=in_size - 1), frac


def interpolate_bilinear(x: torch.Tensor, size,
                         align_corners: bool = True) -> torch.Tensor:
    """torch ``F.interpolate(mode='bilinear')`` on (N, H, W, C)."""
    if isinstance(size, int):
        size = (size, size)
    oh, ow = size
    _, h, w, _ = x.shape
    if (oh, ow) == (h, w):
        return x
    ylo, yhi, yf = _bilinear_coords(oh, h, align_corners, x.device)
    xlo, xhi, xf = _bilinear_coords(ow, w, align_corners, x.device)
    yf = yf[None, :, None, None]
    xf = xf[None, None, :, None]
    row = x.index_select(1, ylo) * (1 - yf) + x.index_select(1, yhi) * yf
    out = row.index_select(2, xlo) * (1 - xf) + row.index_select(2, xhi) * xf
    return out.to(x.dtype)


def _pool_matrix(out_size: int, in_size: int, device) -> torch.Tensor:
    """(out, in): row i averages [floor(i·in/out), ceil((i+1)·in/out))."""
    i = torch.arange(out_size, device=device)
    lo = (i * in_size) // out_size
    hi = -((-(i + 1) * in_size) // out_size)
    j = torch.arange(in_size, device=device)
    inside = (j[None] >= lo[:, None]) & (j[None] < hi[:, None])
    return inside.float() / (hi - lo).float()[:, None]


def adaptive_avg_pool(x: torch.Tensor, size) -> torch.Tensor:
    """torch ``nn.AdaptiveAvgPool2d`` on (N, H, W, C); also for an output
    larger than the input."""
    if isinstance(size, int):
        size = (size, size)
    oh, ow = size
    _, h, w, _ = x.shape
    if (oh, ow) == (h, w):
        return x
    if h % oh == 0 and w % ow == 0:  # equal bins: a plain mean pool
        return avg_pool(x, (h // oh, w // ow))
    mh = _pool_matrix(oh, h, x.device)
    mw = _pool_matrix(ow, w, x.device)
    out = torch.einsum("oh,nhwc->nowc", mh, x.float())
    return torch.einsum("pw,nowc->nopc", mw, out).to(x.dtype)


def avg_pool(x: torch.Tensor, kernel, stride=None) -> torch.Tensor:
    """torch ``nn.AvgPool2d(kernel, stride)`` (no padding) on (N, H, W, C);
    the stride defaults to the kernel."""
    out = F.avg_pool2d(x.permute(0, 3, 1, 2), kernel, stride or kernel)
    return out.permute(0, 2, 3, 1)


def upsample_repeat(x: torch.Tensor, scale: int) -> torch.Tensor:
    """torch ``nn.Upsample(scale_factor=scale)`` (nearest, integer scale) on
    (N, H, W, C)."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, scale, w, scale, c).reshape(
        n, h * scale, w * scale, c)
