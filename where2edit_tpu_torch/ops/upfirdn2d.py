"""upfirdn2d: upsample, FIR filter, downsample (counterpart of
where2edit_tpu/ops/upfirdn2d.py), NHWC.

Semantics of the reference: zero-stuff by ``up`` (a zero *after* every
sample, the last one included), pad by ``(pad0, pad1)`` on each spatial edge
(negative pads crop), convolve with the 2-D FIR ``kernel`` (a true
convolution, so the kernel is flipped for ``F.conv2d``'s cross-correlation)
and keep every ``down``-th sample. One depthwise convolution
(``ops.conv.conv2d``: its gradient of a gradient stays one depthwise call).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from where2edit_tpu_torch.ops.conv import conv2d


def make_kernel(k) -> np.ndarray:
    """2-D FIR kernel from a 1-D/2-D spec, normalised to sum 1."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    return (k / k.sum()).astype(np.float32)


def upfirdn2d(x: torch.Tensor, kernel, up: int = 1, down: int = 1,
              pad=(0, 0)) -> torch.Tensor:
    """(N, H, W, C) -> (N, H', W', C), H' = (H·up + pad0 + pad1 - kh)//down + 1.

    ``kernel``: (kh, kw) numpy array or tensor.
    """
    n, h, w, c = x.shape
    k = torch.as_tensor(kernel, dtype=x.dtype, device=x.device)
    kh, kw = k.shape
    xc = x.permute(0, 3, 1, 2)  # NCHW view (channels_last in memory)
    if up > 1:
        stuffed = xc.new_zeros((n, c, h * up, w * up))
        stuffed[:, :, ::up, ::up] = xc
        xc = stuffed
    pad0, pad1 = pad
    xc = F.pad(xc, [pad0, pad1, pad0, pad1])  # negative entries crop
    weight = torch.flip(k, (0, 1))[None, None].expand(c, 1, kh, kw)
    out = conv2d(xc, weight, down, 0, c)
    return out.permute(0, 2, 3, 1)
