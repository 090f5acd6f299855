"""Host-side image grids (counterpart of where2edit_tpu/utils/images.py,
torchvision ``save_image``'s normalisation). Pillow is imported only to
write the file; without it nothing is written."""

from __future__ import annotations

import numpy as np
import torch


def to_uint8(img, value_range=(-1.0, 1.0), scale_each: bool = False) -> np.ndarray:
    """NHWC float (numpy or a tensor on any device) → uint8."""
    if isinstance(img, torch.Tensor):
        img = img.detach().float().cpu().numpy()
    img = np.asarray(img, dtype=np.float32)
    if scale_each:
        lo = img.reshape(img.shape[0], -1).min(axis=1)[:, None, None, None]
        hi = img.reshape(img.shape[0], -1).max(axis=1)[:, None, None, None]
    else:
        lo, hi = value_range
    img = (img - lo) / np.maximum(hi - lo, 1e-8)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def save_image_grid(images, path: str, nrow: int = 8, value_range=(-1.0, 1.0),
                    scale_each: bool = False, pad: int = 2) -> bool:
    """Save an NHWC batch as one grid image (jpg/png by the path's suffix).
    Returns False, writing nothing, when Pillow is missing."""
    try:
        from PIL import Image  # noqa: PLC0415
    except ImportError:
        return False
    arr = to_uint8(images, value_range, scale_each)
    n, h, w, c = arr.shape
    if c == 1:
        arr = np.repeat(arr, 3, axis=-1)
    ncol = min(nrow, n)
    nrows = (n + ncol - 1) // ncol
    grid = np.zeros((nrows * (h + pad) + pad, ncol * (w + pad) + pad, 3), np.uint8)
    for i in range(n):
        r, col = divmod(i, ncol)
        y0, x0 = pad + r * (h + pad), pad + col * (w + pad)
        grid[y0:y0 + h, x0:x0 + w] = arr[i]
    Image.fromarray(grid).save(path)
    return True
