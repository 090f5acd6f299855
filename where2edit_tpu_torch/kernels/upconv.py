"""K4: the modulated transposed up-conv of the upsampling StyledConvs, one
kernel: ``demod ⊙ conv_transpose2d(x·style, wᵀ, stride 2)``, NHWC, fp32.

Replaces no TPU kernel: the JAX package leaves the transposed conv to XLA
(``where2edit_tpu/nn/layers.py::_conv_transpose2x``), and the port ran it as
an input modulation pass, cuDNN's fp32 ``dgrad`` with its layout transforms
and a demod pass. Source: ``csrc/upconv.cu``, on K1's 3xTF32 core
(``csrc/conv3x3_tc.cuh``). Bound on the H100: operations, 2·9·Cin·Cout per
input pixel at the 3xTF32 rate (495/3 TFLOP/s), 45.1 GFLOP (0.274 ms) a
1024² config-f synthesis-image. The kernel splits the transposed conv by
output parity into four stride-1 convs over the input (``PHASE_TAPS``: 4, 2,
2 and 1 taps, 9 in all, so no structural zero is multiplied), each an
implicit GEMM on the tensor cores with the style applied to the input
before its split and demod in the epilogue, all four in one launch, the
heaviest phase's blocks first (see the source's header).

The kernel reads its weights split and tiled as K1 reads its own, from the
phase-ordered weights ``phase_weights`` (plain torch). A call prepares them
itself, or takes ``prepared`` from ``prepare_weight`` (``nn/layers.py::
ModulatedConv2d`` keeps one per weight version at inference).
``upconv_plain`` is the plain twin (the formula the port ran before K4,
which the bf16 up-convs still run).

``modupconv3x3`` is a ``torch.autograd.Function`` whose forward dispatches
on the device of ``x``: a CPU tensor takes ``upconv_plain``, an fp32 CUDA
tensor launches the kernel, anything else raises. Its backward is written in
``ops/conv.py``'s twice-differentiable calls (the path penalty takes a
gradient of a gradient), with as many convolutions as autograd through
``conv_transpose2d`` took: with z = conv_transpose2d(x·s, wᵀ) and y = z·demod,

- ``dxm = conv2d(dy·demod, wᵀ, stride 2)`` (one cuDNN fprop), ``dx = dxm·s``,
  ``ds = Σ_pixels x·dxm``;
- ``dw``: one cuDNN weight gradient (``ops/conv.py::_wgrad``) on the
  recomputed x·s;
- ``ddemod = Σ_pixels dy·y / demod`` (y is the saved output).

``launches`` counts the kernel's launches, ``prepares`` those of the weight
preparation.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from where2edit_tpu_torch.kernels.common import (
    check_cuda_tensor,
    check_launch,
    load,
    ptr,
    tc_prepared_plain,
)
from where2edit_tpu_torch.ops.conv import _wgrad, conv2d, conv_transpose2d

launches = 0
prepares = 0

# (ky, kx) of each output phase (py, px) = (even, even), (even, odd),
# (odd, even), (odd, odd): the taps whose parity matches the phase's. Output
# (2m + py, 2n + px) sums x[m - ky//2 if py == 0 else m, n - kx//2 if px == 0
# else n] over them. Flattened, this is the prepared weights' tap order.
PHASE_TAPS = (((0, 0), (0, 2), (2, 0), (2, 2)),
              ((0, 1), (2, 1)),
              ((1, 0), (1, 2)),
              ((1, 1),))

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def phase_weights(w: torch.Tensor) -> torch.Tensor:
    """w (Cout, Cin, 3, 3) as (9, Cin, Cout), contiguous, tap by tap in
    ``PHASE_TAPS`` order: what the kernel's weight preparation reads."""
    taps = [w[:, :, ky, kx].t() for phase in PHASE_TAPS for ky, kx in phase]
    return torch.stack(taps).contiguous()


def upconv_plain(x, style, w, demod=None):
    """x (B,H,W,Cin), style (B,Cin) (the equalised-lr scale folded in), w
    (Cout,Cin,3,3), demod (B,Cout) or None. Returns (B,2H+1,2W+1,Cout):
    ``demod ⊙ conv_transpose2d(x·style, wᵀ, stride 2)``, channels last."""
    xm = x * style[:, None, None, :]
    y = conv_transpose2d(xm.permute(0, 3, 1, 2), w.transpose(0, 1), 2).permute(0, 2, 3, 1)
    return y if demod is None else y * demod[:, None, None, :]


@functools.lru_cache(maxsize=None)
def prepared_size(cin: int, cout: int) -> int:
    """Floats of a (Cin, Cout) layer's prepared weights (K1's layout over
    the 9 phase-ordered taps: 2·9·Cin·Cout, padded to the tiles)."""
    return load("upconv", "w2e_upconv_prepared_floats", [ctypes.c_int] * 2,
                ctypes.c_longlong)(cin, cout)


def prepare_weight(w: torch.Tensor) -> torch.Tensor | None:
    """w (Cout, Cin, 3, 3) fp32 as the kernel reads it: ``phase_weights``,
    split into TF32 parts and tiled by one launch into a flat fp32 buffer
    for ``modupconv3x3(..., prepared=)``; None for a CPU tensor, whose plain
    version needs none."""
    if w.device.type == "cpu":
        return None
    if w.device.type != "cuda":
        raise ValueError(f"upconv: unsupported device {w.device}")
    cout, cin = w.shape[0], w.shape[1]
    if w.dtype != torch.float32 or w.shape != (cout, cin, 3, 3):
        raise ValueError(f"upconv: w must be float32 (Cout, Cin, 3, 3), got {w.dtype} "
                         f"{tuple(w.shape)}")
    wph = phase_weights(w.detach())
    wp = torch.empty(prepared_size(cin, cout), device=w.device, dtype=torch.float32)
    fn = load("upconv", "w2e_upconv_prep",
              [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    rc = fn(ptr(wph), ptr(wp), cin, cout, torch.cuda.current_stream(w.device).cuda_stream)
    check_launch("upconv prep", rc)
    global prepares
    prepares += 1
    return wp


def prepared_plain(w: torch.Tensor) -> torch.Tensor:
    """Plain twin of ``prepare_weight`` (on the CPU, for the tests): K1's
    layout (``tc_prepared_plain``) over ``phase_weights(w)``."""
    cout, cin = w.shape[0], w.shape[1]
    return tc_prepared_plain(phase_weights(w.detach()).reshape(3, 3, cin, cout))


def plan(b: int, h: int, wd: int, cout: int) -> dict:
    """The kernel's blocks per phase, threads a block and dynamic shared
    memory (bytes) for a call of this shape."""
    fields = (ctypes.c_int * 6)()
    load("upconv", "w2e_upconv_plan", [ctypes.c_int] * 4 + [ctypes.c_void_p],
         restype=None)(b, h, wd, cout, fields)
    return {"blocks": tuple(fields[:4]), "threads": fields[4], "smem": fields[5]}


def _launch(x, style, w, demod, prepared):
    """The kernel on CUDA tensors, same contract as ``upconv_plain``;
    ``prepared`` is ``prepare_weight(w)`` or None."""
    if x.dtype != torch.float32:
        raise TypeError(f"upconv: the kernel takes float32, got {x.dtype}")
    b, h, wd, cin = x.shape
    cout = w.shape[0]
    dev = x.device
    check_cuda_tensor("x", x, (b, h, wd, cin), dev)
    check_cuda_tensor("style", style, (b, cin), dev)
    if w.shape != (cout, cin, 3, 3):
        raise ValueError(f"w has shape {tuple(w.shape)}, expected {(cout, cin, 3, 3)}")
    if demod is not None:
        check_cuda_tensor("demod", demod, (b, cout), dev)
    if prepared is None:
        prepared = prepare_weight(w)
    check_cuda_tensor("prepared", prepared, (prepared_size(cin, cout),), dev)
    out = torch.empty((b, 2 * h + 1, 2 * wd + 1, cout), device=dev, dtype=torch.float32)
    fn = load("upconv", "w2e_upconv", _ARGTYPES)
    rc = fn(ptr(x), ptr(style), ptr(prepared), ptr(demod), ptr(out), b, h, wd, cin, cout,
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch("upconv", rc)
    global launches
    launches += 1
    return out


class _ModUpConv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, style, w, demod, prepared):
        if x.device.type == "cpu":
            y = upconv_plain(x, style, w, demod)
        elif x.device.type == "cuda":
            y = _launch(x, style, w, demod, prepared)
        else:
            raise ValueError(f"upconv: unsupported device {x.device}")
        ctx.save_for_backward(x, style, w, demod, y if demod is not None else None)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, style, w, demod, y = ctx.saved_tensors
        need_x, need_s, need_w, need_d, _ = ctx.needs_input_grad
        dx = ds = dw = dd = None
        dz = dy if demod is None else dy * demod[:, None, None, :]
        dz_nchw = dz.permute(0, 3, 1, 2)
        if need_x or need_s:
            dxm = conv2d(dz_nchw, w.transpose(0, 1), 2, 0).permute(0, 2, 3, 1)
            if need_x:
                dx = dxm * style[:, None, None, :]
            if need_s:
                ds = (x * dxm).sum((1, 2))
        if need_w:
            xm = (x * style[:, None, None, :]).permute(0, 3, 1, 2)
            # the weight gradient of conv2d(dz, wᵀ, 2) against xm, as
            # ops.conv's conv_transpose2d takes it (twice differentiable)
            dw = _wgrad(dz_nchw, (w.shape[1], w.shape[0], 3, 3), xm, 2, 0, 1).transpose(0, 1)
        if need_d:
            dd = (dy * y).sum((1, 2)) / demod
        return dx, ds, dw, dd, None


def modupconv3x3(x, style, w, demod=None, prepared=None):
    """Same contract as ``upconv_plain``, differentiable (twice and more) in
    x, style, w and demod; ``prepared`` is ``prepare_weight(w)``, which a
    CUDA call reads in place of preparing ``w`` itself (the plain version
    ignores it)."""
    return _ModUpConv3x3.apply(x, style, w, demod, prepared)
