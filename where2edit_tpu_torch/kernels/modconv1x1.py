"""K3: modulated 1x1 conv with an optional fused epilogue, one kernel.

Replaces the TPU kernel ``tools/pallas_bench.py::modulated_conv1x1`` (body
``_kernel``). Source: ``csrc/modconv1x1.cu``. Bound on the H100: bytes
(Cout <= 32 on the path, so each input value feeds at most 32 multiply-adds);
a group of up to 32 lanes shares each pixel's Cin row, against a
style·weight fold made once per block in shared memory, reduces across the
group with warp shuffles and applies demod, noise, bias, the activation and
the residual before the single store (see the source's header). Any Cin
works: a Cin that is not a multiple of 4 is read one float at a time.

``modconv1x1`` is a ``torch.autograd.Function`` whose forward dispatches on
the device of ``x``: a CPU tensor takes the plain PyTorch version, a CUDA
tensor launches the kernel (or raises). Its backward is plain PyTorch in
differentiable calls, so it can itself be differentiated: the input
gradient would be K3 with its operands swapped, but its output width is the
layer's Cin (up to 512), beyond the kernel's Cout <= 32; the weight, style
and demod gradients come from one per-sample product
``P[b] = x[b]ᵀ dz[b]`` as in K1.

The bf16 form: a bf16 ``x`` launches ``w2e_modconv1x1_bf16``, which reads x
as 16-byte octets of 8 channels, folds style·weight in fp32 and sums in
fp32; its output is fp32 (``out_dtype=torch.float32``: ToRGB, whose RGB
skip chain stays fp32) or bf16 (the default, ``x``'s dtype: a 1x1
StyledConv, the mapper's convs), and ``residual`` comes in the output's
dtype. ``modconv1x1_plain`` on a bf16 ``x`` is its twin (x upcast, fp32
arithmetic, one rounding to the output's dtype); the TPU kernel's
round(x·s) differs from it by less than one bf16 step. A bf16 call's
gradients are taken in fp32 and handed back in each input's dtype.
``launches`` counts kernel launches, and ``launches_bf16`` those of the
bf16 form among them.
"""

from __future__ import annotations

import ctypes

import torch

from where2edit_tpu_torch.kernels.common import (
    check_cuda_tensor,
    check_launch,
    kernel_dtype,
    load,
    lrelu_grad,
    noise_grads,
    plain_epilogue,
    ptr,
    sm_count,
    upcast,
)

launches = 0
launches_bf16 = 0
MAX_COUT = 32

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_void_p] * 4 \
    + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_ARGTYPES_BF16 = _ARGTYPES[:-1] + [ctypes.c_int, ctypes.c_void_p]


def modconv1x1_plain(x, style, w, demod=None, noise=None, noise_weight=None,
                     bias=None, act=False, residual=None, out_dtype=None):
    """x (B,P,Cin); style (B,Cin) (the equalised-lr scale folded in);
    w (Cin,Cout); demod (B,Cout); noise (B or 1,P) with noise_weight (1,);
    bias (Cout,); residual (B,P,Cout). Returns (B,P,Cout) in ``out_dtype``
    (x's by default), computed in fp32 from the upcast operands."""
    y = torch.einsum("bpi,bi,io->bpo", upcast(x), style, w)
    if demod is not None:
        y = y * demod[:, None, :]
    res = None if residual is None else upcast(residual)
    return plain_epilogue(y, noise, noise_weight, bias, act, res).to(
        out_dtype or x.dtype)


def blocks(b, p, cin, cout, device_index=0) -> int:
    """Blocks the kernel launches for this shape on the card (0: not taken)."""
    return load("modconv1x1", "w2e_modconv1x1_blocks", [ctypes.c_int] * 5)(
        b, p, cin, cout, sm_count(device_index))


def _launch(x, style, w, demod, noise, noise_weight, bias, act, residual,
            out_dtype=None):
    """The kernel on CUDA tensors, same contract as ``modconv1x1_plain``."""
    b, p, cin = x.shape
    cout = w.shape[1]
    if cout > MAX_COUT:
        raise ValueError(f"modconv1x1 supports Cout <= {MAX_COUT}, got {cout}")
    dev = x.device
    dt = kernel_dtype("modconv1x1", x)
    bf = dt == torch.bfloat16
    odt = out_dtype or dt
    if odt not in (dt, torch.float32):
        raise TypeError(f"modconv1x1: a {dt} input gives {dt} or float32, not {odt}")
    check_cuda_tensor("x", x, (b, p, cin), dev, dt)
    check_cuda_tensor("style", style, (b, cin), dev)
    check_cuda_tensor("w", w, (cin, cout), dev)
    if demod is not None:
        check_cuda_tensor("demod", demod, (b, cout), dev)
    noise_bstride = 0
    if noise is not None:
        nb = noise.shape[0]
        if nb not in (1, b):
            raise ValueError(f"noise batch {nb} does not broadcast to {b}")
        check_cuda_tensor("noise", noise, (nb, p), dev)
        check_cuda_tensor("noise_weight", noise_weight, (1,), dev)
        noise_bstride = 0 if nb == 1 else p
    if bias is not None:
        check_cuda_tensor("bias", bias, (cout,), dev)
    if residual is not None:
        check_cuda_tensor("residual", residual, (b, p, cout), dev, odt)
    out = torch.empty((b, p, cout), device=dev, dtype=odt)
    args = (ptr(x), ptr(style), ptr(w), ptr(demod), ptr(noise), noise_bstride,
            ptr(noise_weight) if noise is not None else None, ptr(bias),
            ptr(residual), ptr(out), b, p, cin, cout, int(act),
            sm_count(dev.index))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if bf:
        rc = load("modconv1x1", "w2e_modconv1x1_bf16", _ARGTYPES_BF16)(
            *args, int(odt == torch.bfloat16), stream)
    else:
        rc = load("modconv1x1", "w2e_modconv1x1", _ARGTYPES)(*args, stream)
    check_launch("modconv1x1", rc)
    global launches, launches_bf16
    launches += 1
    launches_bf16 += bf
    return out


class _ModConv1x1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, style, w, demod, noise, noise_weight, bias, act, residual,
                out_dtype):
        args = (x, style, w, demod, noise, noise_weight, bias, act, residual,
                out_dtype)
        if x.device.type == "cpu":
            y = modconv1x1_plain(*args)
        elif x.device.type == "cuda":
            y = _launch(*args)
        else:
            raise ValueError(f"modconv1x1: unsupported device {x.device}")
        ctx.act = act
        ctx.save_for_backward(x, style, w, demod, noise, noise_weight,
                              y if act else None)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, style, w, demod, noise, noise_weight, y = ctx.saved_tensors
        need_x, need_s, need_w, need_d, need_n, need_nw, need_b, _, need_r, _ = \
            ctx.needs_input_grad
        dz = lrelu_grad(dy, y) if ctx.act else dy
        dres = dy if need_r else None
        dz = upcast(dz)  # the gradients in fp32, handed back in each input's dtype
        dx = ds = dw = dd = None
        if need_x:
            dc = dz if demod is None else dz * demod[:, None, :]
            dx = ((dc @ w.t()) * style[:, None, :]).to(x.dtype)
        if need_s or need_w or need_d:
            p = upcast(x).transpose(1, 2) @ dz             # (B, Cin, Cout)
            ps = p * style[:, :, None]
            pd = p if demod is None else p * demod[:, None, :]
            if need_w:
                dw = (ps if demod is None else ps * demod[:, None, :]).sum(0)
            if need_s:
                ds = (pd * w).sum(2)
            if need_d:
                dd = (ps * w).sum(1)
        dn, dnw = noise_grads(dz, noise, noise_weight, need_n, need_nw)
        db = dz.sum((0, 1)) if need_b else None
        return dx, ds, dw, dd, dn, dnw, db, None, dres, None


def modconv1x1(x, style, w, demod=None, noise=None, noise_weight=None,
               bias=None, act=False, residual=None, out_dtype=None):
    """Same contract as ``modconv1x1_plain`` (on CUDA, Cout <= 32),
    differentiable (twice and more) in every tensor argument."""
    if act and residual is not None:
        # the activation's gradient reads the output before the residual
        return modconv1x1(x, style, w, demod, noise, noise_weight, bias,
                          True, out_dtype=out_dtype) + residual
    return _ModConv1x1.apply(x, style, w, demod, noise, noise_weight, bias,
                             act, residual, out_dtype)
