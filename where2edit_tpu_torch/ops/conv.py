"""2-D convolution and its transpose as a pair of autograd Functions whose
gradients can be differentiated again cheaply (plain PyTorch; NCHW tensors,
channels-last views welcome; no dilation).

PyTorch's own double backward of a convolution (``ConvolutionBackwardBackward0``)
runs a grouped convolution one group at a time, and takes the weight term
of the input gradient as a convolution whose kernel is the whole output
gradient dilated by the stride; at 1024² either costs seconds per call
(a depthwise FIR blur: one cuDNN call per channel, ~19 ms each). R1 and the
path length penalty take those terms for every blur and plain conv of D
and G. Here the input gradient of ``conv2d`` is ``conv_transpose2d``
through the twin Function and vice versa, and each weight gradient is
cuDNN's weight-gradient kernel (``torch.nn.grad.conv2d_weight``), so a
gradient of a gradient runs the same convolutions again, all groups in one
call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _wgrad(image, weight_shape, small, stride, padding, groups):
    """∂⟨conv2d(image, w), small⟩/∂w: cuDNN's weight gradient."""
    return torch.nn.grad.conv2d_weight(image, weight_shape, small, stride=stride,
                                       padding=padding, groups=groups)


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
            extra = [x.shape[i] - ((dy.shape[i] - 1) * stride - 2 * padding
                                   + w.shape[i]) for i in (2, 3)]
            dx = conv_transpose2d(dy, w, stride, padding, extra, groups)
        if ctx.needs_input_grad[1]:
            dw = _wgrad(x, w.shape, dy, stride, padding, groups)
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
            dw = _wgrad(dy, w.shape, x, stride, padding, groups)
        return dx, dw, None, None, None, None


def conv2d(x, w, stride: int = 1, padding: int = 0, groups: int = 1):
    """``F.conv2d``; w (Cout, Cin / groups, kh, kw)."""
    return _Conv2d.apply(x, w, stride, padding, groups)


def conv_transpose2d(x, w, stride: int = 1, padding: int = 0,
                     output_padding=(0, 0), groups: int = 1):
    """``F.conv_transpose2d``; w (Cin, Cout / groups, kh, kw)."""
    return _ConvTranspose2d.apply(x, w, stride, padding, tuple(output_padding),
                                  groups)
