"""Plain PyTorch operations of the reference, NCHW, float32.

``conv2d`` and ``conv_transpose2d`` are autograd Functions whose input
gradient is the other one and whose weight gradient is cuDNN's weight
gradient kernel, so a gradient of a gradient (R1, the path length penalty)
runs ordinary convolutions again. PyTorch's own double backward of a
strided convolution takes its weight term as one convolution per call whose
kernel is the whole output gradient, which costs seconds at 1024².
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


class _Conv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, groups)
        return F.conv2d(x, w, stride=stride, padding=padding, groups=groups)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        stride, padding, groups = ctx.conf
        dx = dw = None
        if ctx.needs_input_grad[0]:
            extra = [x.shape[i] - ((dy.shape[i] - 1) * stride - 2 * padding + w.shape[i])
                     for i in (2, 3)]
            dx = conv_transpose2d(dy, w, stride, padding, extra, groups)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(x, w.shape, dy, stride=stride,
                                             padding=padding, groups=groups)
        return dx, dw, None, None, None


class _ConvTranspose2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding, output_padding, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, groups)
        return F.conv_transpose2d(x, w, stride=stride, padding=padding,
                                  output_padding=output_padding, groups=groups)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        stride, padding, groups = ctx.conf
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv2d(dy, w, stride, padding, groups)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(dy, w.shape, x, stride=stride,
                                             padding=padding, groups=groups)
        return dx, dw, None, None, None, None


def conv2d(x, w, stride: int = 1, padding: int = 0, groups: int = 1):
    return _Conv2d.apply(x, w, stride, padding, groups)


def conv_transpose2d(x, w, stride: int = 1, padding: int = 0,
                     output_padding=(0, 0), groups: int = 1):
    return _ConvTranspose2d.apply(x, w, stride, padding, tuple(output_padding), groups)


def fir_kernel(taps=(1, 3, 3, 1), gain: float = 1.0) -> torch.Tensor:
    k = torch.tensor(taps, dtype=torch.float32)
    k = torch.outer(k, k)
    return k / k.sum() * gain


def upfirdn2d(x, kernel, up: int = 1, down: int = 1, pad=(0, 0)):
    """Zero-stuff by ``up``, pad (negative crops), convolve with the FIR
    ``kernel`` (a true convolution) and keep every ``down``-th sample. Each
    channel is filtered alone: the channels are folded into the batch and
    one single-channel convolution runs over them."""
    n, c, h, w = x.shape
    kh, kw = kernel.shape
    x = x.reshape(n * c, 1, h, w)
    if up > 1:
        x = torch.stack([x] + [torch.zeros_like(x)] * (up - 1), -1)
        x = x.reshape(n * c, 1, h, w * up)
        x = torch.stack([x] + [torch.zeros_like(x)] * (up - 1), -2)
        x = x.reshape(n * c, 1, h * up, w * up)
    x = F.pad(x, [pad[0], pad[1], pad[0], pad[1]])
    k = torch.flip(kernel, (0, 1)).to(x)[None, None]
    out = conv2d(x, k, down, 0)
    return out.reshape(n, c, out.shape[2], out.shape[3])


def lrelu(x, bias=None):
    """leaky ReLU (0.2) of x + bias, times √2; ``bias`` per channel (dim 1)."""
    if bias is not None:
        x = x + bias.reshape((1, -1) + (1,) * (x.dim() - 2))
    return F.leaky_relu(x, 0.2) * math.sqrt(2.0)


def equal_linear(x, weight, bias, lr_mul: float = 1.0, act: bool = False):
    """Equalised-lr linear: weight scaled by lr_mul/√in, bias by lr_mul."""
    out = F.linear(x, weight * (lr_mul / math.sqrt(weight.shape[1])))
    b = None if bias is None else bias * lr_mul
    if act:
        return lrelu(out, b)
    return out if b is None else out + b


def pixel_norm(x):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-8)


def nearest(x, size: int):
    """Nearest resize (N, C, H, W) → (N, C, size, size), source index
    floor(dst · in / out)."""
    h = x.shape[-1]
    if h == size:
        return x
    idx = torch.floor(torch.arange(size, dtype=torch.float64, device=x.device)
                      * (h / size)).long().clamp(max=h - 1)
    return x.index_select(2, idx).index_select(3, idx)


def gaussian_blur(x, ksize: int = 5):
    """torchvision's gaussian_blur: sigma 0.3·((k−1)/2 − 1) + 0.8, reflect
    padding, two separable passes."""
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    t = torch.arange(ksize, dtype=torch.float32, device=x.device) - (ksize - 1) / 2
    k = torch.exp(-t.square() / (2 * sigma ** 2))
    k = k / k.sum()
    n, c, h, w = x.shape
    p = ksize // 2
    y = F.pad(x.reshape(n * c, 1, h, w), [p, p, p, p], mode="reflect")
    y = F.conv2d(y, k.view(1, 1, ksize, 1))
    y = F.conv2d(y, k.view(1, 1, 1, ksize))
    return y.reshape(n, c, h, w)
