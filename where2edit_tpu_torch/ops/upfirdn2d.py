"""upfirdn2d: upsample, FIR filter, downsample (counterpart of
where2edit_tpu/ops/upfirdn2d.py), NHWC.

Semantics of the reference: zero-stuff by ``up`` (a zero *after* every
sample, the last one included), pad by ``(pad0, pad1)`` on each spatial edge
(negative pads crop), convolve with the 2-D FIR ``kernel`` (a true
convolution, so the kernel is flipped for ``F.conv2d``'s cross-correlation)
and keep every ``down``-th sample.

On a CUDA tensor ``upfirdn2d`` is the autograd Function ``UpFirDn2d``,
whose forward launches K5 (``kernels/upfirdn2d.py``, fp32 or bf16) or
raises. Its input gradient is upfirdn2d through the same Function, with
``up`` and ``down`` swapped, the FIR flipped and the pads that return the
input's size, so every order of differentiation runs the same kernel. It
saves no tensor: the FIR is read to the host once per tensor version
(``host_taps``) and passed by value. On a CPU tensor ``upfirdn2d`` is
``upfirdn2d_plain``: one depthwise convolution (``ops.conv.conv2d``: its
gradient of a gradient stays one depthwise call), differentiated by
autograd; ``UpFirDn2d`` on a CPU tensor runs it too, which the CPU tests
use to hold the backward formula.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from where2edit_tpu_torch.kernels import upfirdn2d as k5
from where2edit_tpu_torch.ops.conv import conv2d
from where2edit_tpu_torch.utils import profiling

_host_taps = WeakIdKeyDictionary()  # FIR tensor -> (its version, host array)


def make_kernel(k) -> np.ndarray:
    """2-D FIR kernel from a 1-D/2-D spec, normalised to sum 1."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    return (k / k.sum()).astype(np.float32)


def host_taps(kernel) -> np.ndarray:
    """``kernel`` (numpy array or tensor, (kh, kw)) as a contiguous float64
    host array; a tensor (a layer's FIR buffer, maybe on the card) is copied
    to the host once per version."""
    if not isinstance(kernel, torch.Tensor):
        return np.ascontiguousarray(kernel, dtype=np.float64)
    cached = _host_taps.get(kernel)
    if cached is None or cached[0] != kernel._version:
        cached = _host_taps[kernel] = (
            kernel._version, kernel.detach().to("cpu", torch.float64, copy=True).numpy())
    return cached[1]


def upfirdn2d_plain(x: torch.Tensor, kernel, up: int, down: int,
                    pads: tuple) -> torch.Tensor:
    """The plain version; ``pads`` (pad_y0, pad_y1, pad_x0, pad_x1),
    ``kernel`` cast to x's dtype."""
    n, h, w, c = x.shape
    k = torch.as_tensor(kernel, dtype=x.dtype, device=x.device)
    kh, kw = k.shape
    xc = x.permute(0, 3, 1, 2)  # NCHW view (channels_last in memory)
    if up > 1:
        stuffed = xc.new_zeros((n, c, h * up, w * up))
        stuffed[:, :, ::up, ::up] = xc
        xc = stuffed
    py0, py1, px0, px1 = pads
    xc = F.pad(xc, [px0, px1, py0, py1])  # negative entries crop
    weight = torch.flip(k, (0, 1))[None, None].expand(c, 1, kh, kw)
    out = conv2d(xc, weight, down, 0, c)
    return out.permute(0, 2, 3, 1)


class UpFirDn2d(torch.autograd.Function):
    """``apply(x, taps, up, down, pads)``: ``taps`` a host array
    (``host_taps``), ``pads`` (pad_y0, pad_y1, pad_x0, pad_x1)."""

    @staticmethod
    def forward(ctx, x, taps, up, down, pads):
        ctx.conf = (taps, up, down, pads, x.shape[1], x.shape[2])
        if x.is_cuda:
            return k5.upfirdn2d_cuda(x, taps, up, down, pads)
        return upfirdn2d_plain(x, taps, up, down, pads)

    @staticmethod
    def backward(ctx, dy):
        taps, up, down, (py0, _, px0, _), h, w = ctx.conf
        kh, kw = taps.shape
        ho, wo = dy.shape[1], dy.shape[2]
        # dx[i] = Σ_s k[s]·dy↑down[i·up + s - (k - 1 - p0)]: the same op on
        # dy with the FIR flipped, cropped to the input's size
        pads = (kh - py0 - 1, h * up - ho * down + py0 - up + 1,
                kw - px0 - 1, w * up - wo * down + px0 - up + 1)
        dx = UpFirDn2d.apply(dy, np.ascontiguousarray(taps[::-1, ::-1]), down, up, pads)
        return dx, None, None, None, None


@profiling.spanned_layer("ops.upfirdn2d")
def upfirdn2d(x: torch.Tensor, kernel, up: int = 1, down: int = 1,
              pad=(0, 0)) -> torch.Tensor:
    """(N, H, W, C) -> (N, H', W', C), H' = (H·up + pad0 + pad1 - kh)//down + 1.

    ``kernel``: (kh, kw) numpy array or tensor.
    """
    pads = (pad[0], pad[1], pad[0], pad[1])
    if x.is_cuda:
        return UpFirDn2d.apply(x, host_taps(kernel), up, down, pads)
    return upfirdn2d_plain(x, kernel, up, down, pads)
