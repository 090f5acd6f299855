"""K2: equalised-lr 3x3 conv + bias + lrelu, one kernel.

Replaces the TPU kernel ``tools/conv3x3_bench.py::conv3x3_fused`` (body
``_kernel``): ``act(conv3x3(x, w·scale) + bias)``, NHWC, stride 1, pad 1,
fp32 accumulation, act = lrelu(0.2)·√2 or none. It runs every
non-downsampling 3x3 ``ConvLayer`` of the discriminator. Source:
``csrc/conv3x3.cu`` on ``csrc/conv3x3_tc.cuh``: an implicit GEMM on the
tensor cores (``wgmma``) in 3xTF32, each fp32 operand split into two TF32
parts and each product taken as three TF32 products, which keeps fp32
accuracy; ragged channel counts (the final conv's 512 + 1 minibatch-stddev
inputs) are zero-padded in the kernel. Bound on the H100: operations, at
the 3xTF32 rate (see the core's header).

``conv3x3`` is a ``torch.autograd.Function`` whose forward dispatches on
the device of ``x``: a CPU tensor takes the plain PyTorch version, a CUDA
tensor launches the kernel (or raises). Its backward is differentiable: the
input gradient is K2 itself through the same Function (the spatially
flipped weight with Cin and Cout swapped, no epilogue: exact for stride 1,
pad 1), the weight and bias gradients are plain PyTorch.

The bf16 form: a bf16 ``x`` launches the bf16 instantiation
(``w2e_conv3x3_bf16``): the weights rounded to bf16 after the scale
(round(scale·w), as the JAX layer casts them), one bf16 MMA per 16
channels of a tap summed in fp32, the fp32 bias and activation, one
rounding at the store; the final conv's 513 inputs are staged one value at
a time. ``conv3x3_plain`` on a bf16 ``x`` is its twin. The input gradient
of a bf16 call is the bf16 kernel; the weight and bias gradients are fp32.
``launches`` counts kernel launches, forward and backward alike, and
``launches_bf16`` those of the bf16 form among them.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from where2edit_tpu_torch.kernels.common import (
    check_cuda_tensor,
    check_launch,
    kernel_dtype,
    load,
    lrelu_grad,
    plain_epilogue,
    ptr,
    split_count,
    upcast,
)

launches = 0
launches_bf16 = 0

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                          ctypes.c_void_p]


def conv3x3_plain(x, w, scale, bias=None, act=False):
    """x (B,H,W,Cin); w (3,3,Cin,Cout), applied as w·scale; bias (Cout,).
    Returns (B,H,W,Cout) in x's dtype. A bf16 x is the bf16 form's twin:
    round(w·scale) to bf16, fp32 arithmetic, one rounding of the result."""
    dt = x.dtype
    ws = w.permute(3, 2, 0, 1) * scale
    if dt == torch.bfloat16:
        ws = ws.to(dt).float()
    y = F.conv2d(upcast(x).permute(0, 3, 1, 2), ws, padding=1).permute(0, 2, 3, 1)
    return plain_epilogue(y, None, None, bias, act).to(dt)


@functools.lru_cache(maxsize=None)
def workspace_floats(b, h, wd, cin, cout, splits, bf16=False) -> int:
    """fp32 scratch one call needs: the prepared (tiled) weights and, with
    splits > 1, the split-K partial sums; ``bf16``: for the bf16 form."""
    return load("conv3x3", "w2e_conv3x3_workspace", [ctypes.c_int] * 7,
                ctypes.c_longlong)(b, h, wd, cin, cout, splits, int(bf16))


def _launch(x, w, scale, bias, act):
    """The kernel on CUDA tensors, same contract as ``conv3x3_plain``."""
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    dev = x.device
    dt = kernel_dtype("conv3x3", x)
    bf = dt == torch.bfloat16
    check_cuda_tensor("x", x, (b, h, wd, cin), dev, dt)
    check_cuda_tensor("w", w, (3, 3, cin, cout), dev)
    if bias is not None:
        check_cuda_tensor("bias", bias, (cout,), dev)
    out = torch.empty((b, h, wd, cout), device=dev, dtype=dt)
    splits = split_count("conv3x3", b, h, wd, cin, cout, dev.index, bf)
    work = torch.empty(workspace_floats(b, h, wd, cin, cout, splits, bf),
                       device=dev, dtype=torch.float32)
    fn = load("conv3x3", "w2e_conv3x3_bf16" if bf else "w2e_conv3x3", _ARGTYPES)
    rc = fn(ptr(x), ptr(w), ptr(bias), ptr(out), ptr(work), b, h, wd, cin,
            cout, splits, int(act), float(scale),
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch("conv3x3", rc)
    global launches, launches_bf16
    launches += 1
    launches_bf16 += bf
    return out


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, scale, bias, act):
        if x.device.type == "cpu":
            y = conv3x3_plain(x, w, scale, bias, act)
        elif x.device.type == "cuda":
            y = _launch(x, w, scale, bias, act)
        else:
            raise ValueError(f"conv3x3: unsupported device {x.device}")
        ctx.act, ctx.scale = act, scale
        ctx.save_for_backward(x, w, y if act else None)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, y = ctx.saved_tensors
        need_x, need_w, _, need_b, _ = ctx.needs_input_grad
        dz = (lrelu_grad(dy, y) if ctx.act else dy).contiguous()
        dx = dw = None
        if need_x:
            dx = conv3x3(dz, w.flip((0, 1)).transpose(2, 3).contiguous(),
                         ctx.scale)
        if need_w:  # fp32, as the parameters (bf16 operands upcast)
            dw = torch.nn.grad.conv2d_weight(
                upcast(x).permute(0, 3, 1, 2), (w.shape[3], w.shape[2], 3, 3),
                upcast(dz).permute(0, 3, 1, 2), padding=1).permute(2, 3, 1, 0) * ctx.scale
        db = upcast(dz).sum((0, 1, 2)) if need_b else None
        return dx, dw, None, db, None


def conv3x3(x, w, scale, bias=None, act=False):
    """Same contract as ``conv3x3_plain``, differentiable (twice and more)
    in x, w and bias."""
    return _Conv3x3.apply(x, w, scale, bias, act)
