"""K5: upfirdn2d (zero-stuff by ``up``, pad or crop, FIR, keep every
``down``-th sample) on NHWC CUDA tensors, one kernel.

Replaces no TPU kernel: the JAX package leaves upfirdn2d to XLA. Source:
``csrc/upfirdn2d.cu``. Bound on the H100: bytes (2 FLOP a byte for the
models' 4x4 FIR in fp32). A thread owns one 16-byte channel vector of an
output column and slides down a run of output rows, each input row loaded
once into registers for the 4 rows that use it; the borders are zero fill
by predicate, so no padded or stuffed copy is made. Every other call (up or
down > 1, another FIR size, a C that is not a multiple of the vector) takes
a general form, one value a thread, over only the taps that land on real
samples (see the source's header).

``upfirdn2d_cuda`` is the launch; ``ops/upfirdn2d.py``'s autograd Function
calls it for a CUDA tensor (the plain version there runs for a CPU one),
forward and backward alike: the input gradient of upfirdn2d is upfirdn2d
with ``up`` and ``down`` swapped and the FIR flipped. fp32 in and out, or
bf16 in and out with fp32 sums, fp32 taps and one rounding. ``launches``
counts kernel launches, and ``launches_bf16`` those of the bf16 form among
them.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

# the module, not its names: kernels.common imports ops, whose upfirdn2d
# imports this module, so common may still be loading here
from where2edit_tpu_torch.kernels import common

launches = 0
launches_bf16 = 0
MAX_TAPS = 8
MAX_GRID_YZ = 65535  # the launch's batch and output rows
FORMS = ("general", "dense")

_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_longlong] * 2
             + [ctypes.c_int] * 12 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
_PLAN_ARGTYPES = ([ctypes.c_int] + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 12
                  + [ctypes.c_void_p])


def out_size(n: int, up: int, down: int, pad0: int, pad1: int, k: int) -> int:
    """Samples along one axis of upfirdn2d's output from ``n`` inputs."""
    return (n * up + pad0 + pad1 - k) // down + 1


def _strided_ok(x: torch.Tensor) -> torch.Tensor:
    """x itself when its pixels and channels are dense (batch and row
    strides are the kernel's arguments: a band of rows is taken as it
    comes), else a contiguous copy."""
    c = x.shape[3]
    if x.stride(3) == 1 and (x.stride(2) == c or x.shape[2] == 1):
        return x
    return x.contiguous()


def plan(x: torch.Tensor, ho: int, wo: int, up: int, down: int, kh: int, kw: int) -> dict:
    """The kernel's plan for ``x`` (after ``_strided_ok``) on the card:
    ``form`` (``FORMS``), ``rows`` a thread, ``grid``."""
    n, h, w, c = x.shape
    fields = (ctypes.c_int * 5)()
    common.load("upfirdn2d", "w2e_upfirdn2d_plan", _PLAN_ARGTYPES, restype=None)(
        int(x.dtype == torch.bfloat16), x.stride(0), x.stride(1), n, h, w, c, ho, wo,
        up, down, kh, kw, int(x.data_ptr() % 16 == 0), common.sm_count(x.device.index),
        fields)
    return {"form": FORMS[fields[0]], "rows": fields[1], "grid": tuple(fields[2:])}


def upfirdn2d_cuda(x: torch.Tensor, taps: np.ndarray, up: int, down: int,
                   pads: tuple) -> torch.Tensor:
    """x (N, H, W, C) fp32 or bf16 on the card; ``taps`` (kh, kw) the FIR
    as upfirdn2d takes it (a true convolution); ``pads`` (pad_y0, pad_y1,
    pad_x0, pad_x1). Returns (N, Ho, Wo, C) in x's dtype, contiguous."""
    global launches, launches_bf16
    dt = common.kernel_dtype("upfirdn2d", x)
    n, h, w, c = x.shape
    kh, kw = taps.shape
    if not (1 <= kh <= MAX_TAPS and 1 <= kw <= MAX_TAPS):
        raise ValueError(f"upfirdn2d takes a FIR of at most {MAX_TAPS}x{MAX_TAPS}, "
                         f"got {kh}x{kw}")
    if up < 1 or down < 1:
        raise ValueError(f"upfirdn2d: up and down must be >= 1, got {up}, {down}")
    py0, py1, px0, px1 = pads
    ho, wo = out_size(h, up, down, py0, py1, kh), out_size(w, up, down, px0, px1, kw)
    if ho < 1 or wo < 1:
        raise ValueError(f"upfirdn2d: pads {pads} leave an empty output of {h}x{w}")
    if n > MAX_GRID_YZ or ho > MAX_GRID_YZ:
        raise ValueError(f"upfirdn2d takes batch and output rows <= {MAX_GRID_YZ}")
    out = torch.empty((n, ho, wo, c), device=x.device, dtype=dt)
    if out.numel() == 0:
        return out
    x = _strided_ok(x)
    flipped = np.ascontiguousarray(taps[::-1, ::-1], dtype=np.float32).ravel()
    bf = dt == torch.bfloat16
    fn = common.load("upfirdn2d", "w2e_upfirdn2d", _ARGTYPES)
    rc = fn(x.data_ptr(), out.data_ptr(), int(bf), x.stride(0), x.stride(1), n, h, w, c,
            ho, wo, up, down, py0, px0, kh, kw, flipped.ctypes.data,
            common.sm_count(x.device.index), torch.cuda.current_stream(x.device).cuda_stream)
    common.check_launch("upfirdn2d", rc)
    launches += 1
    if bf:
        launches_bf16 += 1
    return out
