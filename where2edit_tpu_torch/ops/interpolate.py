"""Nearest resize with torch ``F.interpolate(mode='nearest')`` index
semantics (counterpart of where2edit_tpu/ops/interpolate.py), NHWC:
src = floor(dst · in / out)."""

from __future__ import annotations

import torch


def _nearest_indices(out_size: int, in_size: int, device) -> torch.Tensor:
    """floor(dst · in / out) in float64, built on ``device`` (no host copy,
    so no wait on the device's queue)."""
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
