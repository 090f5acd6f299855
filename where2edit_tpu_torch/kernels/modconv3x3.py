"""K1: modulated 3x3 conv + demod + noise + bias + lrelu, one kernel.

Replaces the TPU kernel ``tools/conv3x3_bench.py::conv3x3_mod_fused`` (body
``_kernel_mod``). Source: ``csrc/modconv3x3.cu``, its fp32 form on
``csrc/conv3x3_tc.cuh`` and its bf16 form on ``csrc/conv3x3_bf16.cuh``
(below), the cores K2 runs on. The fp32 core is an implicit GEMM on the tensor cores (``wgmma``) in
3xTF32, each fp32 operand split into two TF32 parts and each product taken
as three TF32 products, which keeps fp32 accuracy. The style multiplies each
input value before its split; demod, noise, bias and the activation are the
epilogue's, before the single store. Bound on the H100: operations, at the
3xTF32 rate (495/3 TFLOP/s; ~19.3 GFLOP per layer from 64² up at batch 1
against at most ~270 MB). Where the grid alone would not fill the SMs (4²
to 32² at batch 1) the K range is split across blocks into an fp32 scratch
that a second pass sums before the epilogue (see the core's header).

The kernel reads its weights split and tiled. A call prepares them itself,
or takes ``prepared``, the buffer ``prepare_weight`` made from the same
``w`` (``nn/layers.py::ModulatedConv2d`` keeps one per weight version at
inference). ``tc_prepared_plain`` in ``kernels/common.py`` is the layout's
plain twin.

``modconv3x3`` is a ``torch.autograd.Function`` whose forward dispatches on
the device of ``x``: a CPU tensor takes the plain PyTorch version, a CUDA
tensor launches the kernel (or raises). Its backward is written in
differentiable calls, so it can itself be differentiated (R1 and the path
length penalty take a gradient of a gradient):

- the input gradient is K1 itself, launched through the same Function:
  ``dx = s ⊙ conv3x3(dz·demod, flip(w)ᵀ)`` is ``modconv3x3`` with style :=
  demod, demod := s and the spatially flipped weight with Cin and Cout
  swapped (dz = dy·lrelu'(·), the epilogue dropped; its weights prepared
  per call);
- the weight, style and demod gradients are plain PyTorch, all three from
  one per-sample weight gradient ``P[b] = Σ_pixels x̃[b]ᵀ dz[b]`` (x̃ the
  zero-padded 3x3 neighbourhoods): ``dw = Σ_b s⊗demod·P``,
  ``ds = Σ w·demod·P``, ``ddemod = Σ w·s·P``;
- noise, noise gain and bias gradients are sums of dz.

The bf16 form: a bf16 ``x`` launches the bf16 kernel
(``w2e_modconv3x3_bf16``) on the bf16 core ``csrc/conv3x3_bf16.cuh``,
shared with K2's bf16 form: bf16 in and out, the style rounded to bf16 and
multiplied into the staged input with one more rounding, the weights
rounded to bf16, fp32 sums, the fp32 epilogue before one rounding at the
store: the arithmetic of the TPU kernel, which takes bf16. Every other
operand stays fp32. Bound on the H100 (NVIDIA H100 80GB HBM3, 700 W):
operations at the bf16 tensor cores' 989 TFLOP/s from 16² up at batch 8,
bytes at 512² and 1024² (64 and 32 channels), fixed cost at 4² and 8². The
core is a persistent, warp-specialised implicit GEMM: one producer thread
keeps TMA loads of the halo'd input patch (once per 64-channel slice;
TMA's zero fill is the padding) and of the weights in flight, two consumer
warpgroups run ``wgmma`` with the tap shift taken as an address in the
patch, the modulation is one pass per staged patch by the producer
warpgroup's other warps, the epilogue stores whole rows (by TMA where it
can), weights of 32 and 64 channels stay in shared memory, small grids
split K, and where Cin > 128 each pair of K steps sums into a fresh
tensor-core accumulator added in fp32 (the tensor cores truncate their own
sums; see the core's header). A Cin that is not a multiple of 8 reaches
the kernel padded with zero channels (TMA reads whole 16-byte rows).
``modconv3x3_plain`` on a bf16 ``x`` is its twin: the bf16 operands
upcast, the same roundings, fp32 arithmetic, one rounding at the end;
``tests/test_torch_kernels_bf16.py`` holds a twin of the core's work
decomposition. The input gradient of a bf16 call is the bf16 kernel; the
weight, style and demod gradients are taken in fp32 from the upcast
operands.

``launches`` counts convolution launches, forward and backward alike, and
``launches_bf16`` those of the bf16 form among them; ``prepares`` counts
``prepare_weight``'s launches.
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
    noise_grads,
    plain_epilogue,
    ptr,
    split_count,
    upcast,
)

launches = 0
launches_bf16 = 0
prepares = 0

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_void_p] * 4 \
    + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def modconv3x3_plain(x, style, w, demod=None, noise=None, noise_weight=None,
                     bias=None, act=False):
    """x (B,H,W,Cin); style (B,Cin) (the equalised-lr scale folded in) or
    None for 1; w (3,3,Cin,Cout); demod (B,Cout); noise (B or 1,H,W) with
    noise_weight (1,); bias (Cout,). Returns (B,H,W,Cout) in x's dtype.
    A bf16 x is the bf16 form's twin: x·round(style) and w rounded to bf16,
    then fp32 arithmetic and one rounding of the result."""
    dt = x.dtype
    bf = dt == torch.bfloat16
    xm = upcast(x)
    if style is not None:
        xm = xm * (style.to(dt).float() if bf else style)[:, None, None, :]
        if bf:
            xm = xm.to(dt).float()
    if bf:
        w = w.to(dt).float()
    y = F.conv2d(xm.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 padding=1).permute(0, 2, 3, 1)
    if demod is not None:
        y = y * demod[:, None, None, :]
    return plain_epilogue(y, noise, noise_weight, bias, act).to(dt)


@functools.lru_cache(maxsize=None)
def workspace_floats(b, h, wd, cin, cout, splits, prepared, bf16=False) -> int:
    """fp32 scratch one call needs: the prepared weights unless the caller
    passes them (``prepared``), then, with splits > 1, the split-K partial
    sums; ``bf16``: for the bf16 form."""
    return load("modconv3x3", "w2e_modconv3x3_workspace", [ctypes.c_int] * 8,
                ctypes.c_longlong)(b, h, wd, cin, cout, splits, int(prepared),
                                   int(bf16))


def prepared_size(cin, cout, dtype=torch.float32) -> int:
    """Values (of ``dtype``) of a (Cin, Cout) layer's prepared weights:
    fp32 split in two TF32 parts, or bf16 (2·9·Cin·Cout floats against
    9·Cin·Cout bf16 values, each padded to its tiles)."""
    bf = dtype == torch.bfloat16
    floats = workspace_floats(1, 1, 1, cin, cout, 1, False, bf)
    return 2 * floats if bf else floats


def prepare_weight(w, dtype=torch.float32):
    """w (3,3,Cin,Cout) (fp32) tiled as the kernel of form ``dtype`` reads
    it, for ``modconv3x3(..., prepared=)``: split into TF32 parts (fp32) or
    rounded to bf16; on a CUDA tensor one launch into a flat buffer of
    ``dtype``; None for a CPU tensor, whose plain version needs none."""
    if w.device.type == "cpu":
        return None
    if w.device.type != "cuda":
        raise ValueError(f"modconv3x3: unsupported device {w.device}")
    cin, cout = w.shape[2], w.shape[3]
    check_cuda_tensor("w", w, (3, 3, cin, cout), w.device)
    bf = dtype == torch.bfloat16
    wp = torch.empty(prepared_size(cin, cout, dtype), device=w.device,
                     dtype=dtype)
    fn = load("modconv3x3", "w2e_modconv3x3_bf16_prep" if bf else "w2e_modconv3x3_prep",
              [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    rc = fn(ptr(w), ptr(wp), cin, cout,
            torch.cuda.current_stream(w.device).cuda_stream)
    check_launch("modconv3x3 prep", rc)
    global prepares
    prepares += 1
    return wp


def _launch(x, style, w, demod, noise, noise_weight, bias, act, prepared):
    """The kernel on CUDA tensors, same contract as ``modconv3x3_plain``;
    ``prepared`` is ``prepare_weight(w, x.dtype)`` or None."""
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    dev = x.device
    dt = kernel_dtype("modconv3x3", x)
    bf = dt == torch.bfloat16
    check_cuda_tensor("x", x, (b, h, wd, cin), dev, dt)
    if style is not None:
        check_cuda_tensor("style", style, (b, cin), dev)
    check_cuda_tensor("w", w, (3, 3, cin, cout), dev)
    if prepared is not None:
        check_cuda_tensor("prepared", prepared, (prepared_size(cin, cout, dt),),
                          dev, dt)
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
    if bf and cin % 8:  # TMA reads whole 16-byte rows: zero channels to a multiple of 8
        x = F.pad(x, (0, 8 - cin % 8))
    out = torch.empty((b, h, wd, cout), device=dev, dtype=dt)
    splits = split_count("modconv3x3", b, h, wd, cin, cout, dev.index, bf)
    n_work = workspace_floats(b, h, wd, cin, cout, splits, prepared is not None, bf)
    work = (torch.empty(n_work, device=dev, dtype=torch.float32)
            if n_work else None)
    fn = load("modconv3x3", "w2e_modconv3x3_bf16" if bf else "w2e_modconv3x3",
              _ARGTYPES)
    rc = fn(ptr(x), ptr(style), ptr(w), ptr(prepared), ptr(demod), ptr(noise),
            noise_bstride, ptr(noise_weight) if noise is not None else None,
            ptr(bias), ptr(out), ptr(work), b, h, wd, cin, cout, splits,
            int(act), torch.cuda.current_stream(dev).cuda_stream)
    check_launch("modconv3x3", rc)
    global launches, launches_bf16
    launches += 1
    launches_bf16 += bf
    return out


def _per_sample_wgrad(x, dz):
    """P (B,3,3,Cin,Cout): each sample's weight gradient of a stride-1,
    pad-1 3x3 conv, ``P[b,ky,kx,i,o] = Σ_hw x[b,h+ky-1,w+kx-1,i]·dz[b,h,w,o]``.
    Plain PyTorch (cuDNN's weight gradient, one sample per call), twice
    differentiable; fp32 (bf16 operands are upcast)."""
    x, dz = upcast(x), upcast(dz)
    cin, cout = x.shape[3], dz.shape[3]
    rows = [torch.nn.grad.conv2d_weight(
        x[i:i + 1].permute(0, 3, 1, 2), (cout, cin, 3, 3),
        dz[i:i + 1].permute(0, 3, 1, 2), padding=1) for i in range(x.shape[0])]
    return torch.stack(rows).permute(0, 3, 4, 2, 1)


class _ModConv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, style, w, demod, noise, noise_weight, bias, act,
                prepared):
        if x.device.type == "cpu":
            y = modconv3x3_plain(x, style, w, demod, noise, noise_weight, bias, act)
        elif x.device.type == "cuda":
            y = _launch(x, style, w, demod, noise, noise_weight, bias, act,
                        prepared)
        else:
            raise ValueError(f"modconv3x3: unsupported device {x.device}")
        ctx.act = act
        ctx.save_for_backward(x, style, w, demod, noise, noise_weight,
                              y if act else None)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, style, w, demod, noise, noise_weight, y = ctx.saved_tensors
        need_x, need_s, need_w, need_d, need_n, need_nw, need_b, _, _ = \
            ctx.needs_input_grad
        dz = (lrelu_grad(dy, y) if ctx.act else dy).contiguous()
        dx = ds = dw = dd = None
        if need_x:
            w_t = w.flip((0, 1)).transpose(2, 3).contiguous()
            dx = modconv3x3(dz, demod, w_t, style)
        if need_s or need_w or need_d:
            p = _per_sample_wgrad(x, dz)  # fp32, as the parameters
            ps = p if style is None else p * style[:, None, None, :, None]
            pd = p if demod is None else p * demod[:, None, None, None, :]
            if need_w:
                dw = (ps if demod is None else ps * demod[:, None, None, None, :]).sum(0)
            if need_s:
                ds = (pd * w).sum((1, 2, 4))
            if need_d:
                dd = (ps * w).sum((1, 2, 3))
        dzf = upcast(dz)
        dn, dnw = noise_grads(dzf, noise, noise_weight, need_n, need_nw)
        db = dzf.sum((0, 1, 2)) if need_b else None
        return dx, ds, dw, dd, dn, dnw, db, None, None


def modconv3x3(x, style, w, demod=None, noise=None, noise_weight=None,
               bias=None, act=False, prepared=None):
    """Same contract as ``modconv3x3_plain``, differentiable (twice and
    more) in every tensor argument but ``prepared``: ``prepare_weight(w,
    x.dtype)``, which a CUDA call reads in place of preparing ``w`` itself
    (the plain version ignores it)."""
    return _ModConv3x3.apply(x, style, w, demod, noise, noise_weight, bias, act,
                             prepared)
