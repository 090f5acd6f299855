"""K1: modulated 3x3 conv + demod + noise + bias + lrelu, one kernel.

Replaces the TPU kernel ``tools/conv3x3_bench.py::conv3x3_mod_fused`` (body
``_kernel_mod``). Source: ``csrc/modconv3x3.cu``. Bound on the H100: fp32
operations (~19.3 GFLOP per layer from 64² up against at most ~270 MB); the
kernel stages the style-modulated input tile and the weights in shared
memory and accumulates a register tile per thread with FMAs, applying the
whole epilogue before the single store. Where the grid alone would not fill
the SMs (4² to 32²) it splits Cin across blocks into an fp32 scratch that a
second pass sums before the epilogue (see the source's header).

``modconv3x3`` dispatches on the device of ``x``: a CPU tensor takes the
plain PyTorch version, a CUDA tensor launches the kernel (or raises).
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from where2edit_tpu_torch.kernels.common import (
    check_cuda_tensor,
    check_launch,
    load,
    plain_epilogue,
    ptr,
)

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_void_p] * 4 \
    + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_SPLITS_ARGTYPES = [ctypes.c_int] * 6


@functools.lru_cache(maxsize=None)
def _split_count(b, h, wd, cin, cout, device_index) -> int:
    """How many blocks share each output tile's Cin range (the source's
    ``w2e_modconv3x3_splits``), per shape and card."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return load("modconv3x3", "w2e_modconv3x3_splits", _SPLITS_ARGTYPES)(
        b, h, wd, cin, cout, sms)


def modconv3x3_plain(x, style, w, demod=None, noise=None, noise_weight=None,
                     bias=None, act=False):
    """x (B,H,W,Cin); style (B,Cin) (the equalised-lr scale folded in);
    w (3,3,Cin,Cout); demod (B,Cout); noise (B or 1,H,W) with noise_weight
    (1,); bias (Cout,). Returns (B,H,W,Cout)."""
    xm = (x * style[:, None, None, :]).permute(0, 3, 1, 2)
    y = F.conv2d(xm, w.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    if demod is not None:
        y = y * demod[:, None, None, :]
    return plain_epilogue(y, noise, noise_weight, bias, act)


def modconv3x3(x, style, w, demod=None, noise=None, noise_weight=None,
               bias=None, act=False):
    """Same contract as ``modconv3x3_plain``."""
    if x.device.type == "cpu":
        return modconv3x3_plain(x, style, w, demod, noise, noise_weight, bias, act)
    if x.device.type != "cuda":
        raise ValueError(f"modconv3x3: unsupported device {x.device}")
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    if cin % 4 or cout % 4:
        raise ValueError(f"modconv3x3 needs Cin and Cout divisible by 4, got {cin}, {cout}")
    dev = x.device
    check_cuda_tensor("x", x, (b, h, wd, cin), dev)
    check_cuda_tensor("style", style, (b, cin), dev)
    check_cuda_tensor("w", w, (3, 3, cin, cout), dev)
    if demod is not None:
        check_cuda_tensor("demod", demod, (b, cout), dev)
    noise_bstride = 0
    if noise is not None:
        nb = noise.shape[0]
        if nb not in (1, b):
            raise ValueError(f"noise batch {nb} does not broadcast to {b}")
        check_cuda_tensor("noise", noise, (nb, h, wd), dev)
        check_cuda_tensor("noise_weight", noise_weight, (1,), dev)
        noise_bstride = 0 if nb == 1 else h * wd
    if bias is not None:
        check_cuda_tensor("bias", bias, (cout,), dev)
    out = torch.empty((b, h, wd, cout), device=dev, dtype=torch.float32)
    splits = _split_count(b, h, wd, cin, cout, dev.index)
    partial = (torch.empty((splits, b, h, wd, cout), device=dev,
                           dtype=torch.float32) if splits > 1 else None)
    fn = load("modconv3x3", "w2e_modconv3x3", _ARGTYPES)
    rc = fn(ptr(x), ptr(style), ptr(w), ptr(demod), ptr(noise), noise_bstride,
            ptr(noise_weight) if noise is not None else None, ptr(bias),
            ptr(out), ptr(partial), b, h, wd, cin, cout, splits, int(act),
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch("modconv3x3", rc)
    global launches
    launches += 1
    return out
