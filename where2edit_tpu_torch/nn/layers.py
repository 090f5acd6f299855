"""StyleGAN2 building blocks (counterpart of where2edit_tpu/nn/layers.py).

NHWC activations; parameters in the reference rosinality layout and key
names (``conv.weight`` (1, Cout, Cin, k, k), ``conv.modulation.*``,
``noise.weight``, ``activate.bias``, ToRGB ``bias`` (1, 3, 1, 1), the
blur/upsample FIR ``kernel`` buffers), so reference state dicts load as
they are.

``ModulatedConv2d`` modulates activations and demodulates outputs
(``conv(x, w·s) == demod ⊙ conv(x·s, w)``). Its non-upsampling branches run
one kernel call each on CUDA (K1 ``modconv3x3``, K3 ``modconv1x1``), and the
layer that owns the epilogue passes it into that same call: a 3x3
``StyledConv`` fuses noise, bias and lrelu into K1; a 1x1 ``StyledConv`` and
every ``ToRGB`` fuse theirs (ToRGB: bias, then the upsampled skip) into K3.
The upsampling branch is plain PyTorch: transposed conv, demod, then
``Blur(pad=(1, 1), ×4)``. Its transposed conv, every plain conv with a
trained weight and every FIR blur go through ``ops.conv``, whose gradient
of a gradient stays one cuDNN call per convolution.

The discriminator's layers (``EqualConv2d``, ``ConvLayer``, ``ResBlock``)
keep the reference's ``nn.Sequential`` key layout (``convs.N.0.weight``,
``convs.N.1.bias``, …). A stride-1 3x3 ``EqualConv2d`` is one K2
(``conv3x3``) call into which its ``ConvLayer`` passes the activation and
its bias; the downsampling layers (blur, then a stride-2 conv) and the 1x1
convs are plain PyTorch. Every kernel call is a twice-differentiable
autograd Function, so R1 and the path length penalty train through them.

Precision follows the activations, as in the JAX layers: a bf16 input runs
the layer in bf16 (the kernels' bf16 forms, the up-conv, the blurs and the
plain convs in bf16) while the parameters stay fp32 and are cast at use,
and the style MLP, the modulation, demod, the noise and every kernel's
epilogue stay fp32. ``ToRGB`` keeps its skip chain fp32 (K3 writes fp32
from a bf16 input).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from where2edit_tpu_torch.kernels import conv3x3 as k2
from where2edit_tpu_torch.kernels import modconv1x1 as k3
from where2edit_tpu_torch.kernels import modconv3x3 as k1
from where2edit_tpu_torch.kernels.common import plain_epilogue, upcast
from where2edit_tpu_torch.ops.conv import conv2d, conv_transpose2d
from where2edit_tpu_torch.ops.fused_act import fused_leaky_relu
from where2edit_tpu_torch.ops.upfirdn2d import make_kernel, upfirdn2d


def pixel_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x · rsqrt(mean(x², dim) + 1e-8)."""
    return x * torch.rsqrt(torch.mean(x.square(), dim=dim, keepdim=True) + 1e-8)


class PixelNorm(nn.Module):
    """``pixel_norm`` over ``dim`` (the features by default; the StyleCLIP
    mapper's is the reference's ``dim=1``)."""

    def __init__(self, dim: int = -1):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        return pixel_norm(x, self.dim)


class EqualLinear(nn.Module):
    """Equalised-lr linear: weight (out, in) scaled at run time by
    lr_mul/sqrt(in), bias by lr_mul; ``activation='fused_lrelu'`` applies the
    bias inside the fused leaky relu."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 bias_init: float = 0.0, lr_mul: float = 1.0,
                 activation: str | None = None,
                 rng: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.randn(out_dim, in_dim, generator=rng) / lr_mul)
        self.bias = (nn.Parameter(torch.full((out_dim,), float(bias_init)))
                     if bias else None)
        self.scale = (1.0 / math.sqrt(in_dim)) * lr_mul
        self.lr_mul = lr_mul
        self.activation = activation

    def forward(self, x):
        out = F.linear(x, self.weight * self.scale)
        b = None if self.bias is None else self.bias * self.lr_mul
        if self.activation == "fused_lrelu":
            return fused_leaky_relu(out, b)
        return out if b is None else out + b


class Blur(nn.Module):
    """upfirdn2d FIR blur; ``kernel`` buffer = make_kernel(k)·factor²."""

    def __init__(self, kernel: Sequence[int] = (1, 3, 3, 1), pad=(0, 0),
                 upsample_factor: int = 1):
        super().__init__()
        k = make_kernel(kernel) * (upsample_factor ** 2)
        self.register_buffer("kernel", torch.from_numpy(k))
        self.pad = tuple(pad)

    def forward(self, x):
        return upfirdn2d(x, self.kernel, pad=self.pad)


class ScaledLeakyReLU(nn.Module):
    """lrelu(x, 0.2)·√2 without a bias."""

    def __init__(self, negative_slope: float = 0.2):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return fused_leaky_relu(x, None, self.negative_slope)


class EqualConv2d(nn.Module):
    """Equalised-lr conv, NHWC in and out: ``weight`` (Cout, Cin, k, k)
    scaled by 1/sqrt(Cin·k²) at run time, optional ``bias`` (Cout,)."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 rng: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(
            out_channel, in_channel, kernel_size, kernel_size, generator=rng))
        self.scale = 1.0 / math.sqrt(in_channel * kernel_size ** 2)
        self.stride = stride
        self.padding = padding
        self.bias = nn.Parameter(torch.zeros(out_channel)) if bias else None

    def forward(self, x):
        return self.fused(x, self.bias, act=False)

    def fused(self, x, bias, act: bool):
        """act(conv(x) + bias), act = lrelu·√2: one K2 call for a stride-1
        3x3 conv, plain PyTorch otherwise."""
        k = self.weight.shape[-1]
        if k == 3 and self.stride == 1 and self.padding == 1:
            return k2.conv3x3(x.contiguous(),
                              self.weight.permute(2, 3, 1, 0).contiguous(),
                              self.scale, bias, act)
        y = conv2d(x.permute(0, 3, 1, 2), (self.weight * self.scale).to(x.dtype),
                   self.stride, self.padding)
        return plain_epilogue(y.permute(0, 2, 3, 1), None, None, bias, act)


class Upsample(nn.Module):
    """FIR upsample ×2 of the ToRGB skip."""

    def __init__(self, kernel: Sequence[int] = (1, 3, 3, 1), factor: int = 2):
        super().__init__()
        k = make_kernel(kernel) * (factor ** 2)
        self.register_buffer("kernel", torch.from_numpy(k))
        self.factor = factor
        p = k.shape[0] - factor
        self.pad = ((p + 1) // 2 + factor - 1, p // 2)

    def forward(self, x):
        return upfirdn2d(x, self.kernel, up=self.factor, pad=self.pad)


class Downsample(nn.Module):
    """FIR downsample ×2."""

    def __init__(self, kernel: Sequence[int] = (1, 3, 3, 1), factor: int = 2):
        super().__init__()
        k = make_kernel(kernel)
        self.register_buffer("kernel", torch.from_numpy(k))
        self.factor = factor
        p = k.shape[0] - factor
        self.pad = ((p + 1) // 2, p // 2)

    def forward(self, x):
        return upfirdn2d(x, self.kernel, down=self.factor, pad=self.pad)


class ModulatedConv2d(nn.Module):
    """Style-modulated, optionally demodulated conv. ``forward`` returns
    ``(out, s)`` with ``s`` the (B, Cin) S-space style vector.

    The optional epilogue ``act(out + noise_weight·noise + bias) + residual``
    (act = lrelu·√2) rides in the kernel call of the non-upsampling branches
    and is applied in plain PyTorch after the upsampling branch.
    """

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int,
                 style_dim: int, demodulate: bool = True,
                 upsample: bool = False,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1),
                 rng: torch.Generator | None = None):
        super().__init__()
        if kernel_size not in (1, 3):
            raise ValueError(f"kernel_size must be 1 or 3, got {kernel_size}")
        if upsample and kernel_size != 3:
            raise ValueError("only the 3x3 conv upsamples")
        self.in_channel = in_channel
        self.out_channel = out_channel
        self.kernel_size = kernel_size
        self.demodulate = demodulate
        self.upsample = upsample
        self.scale = 1.0 / math.sqrt(in_channel * kernel_size ** 2)
        self.weight = nn.Parameter(torch.randn(
            1, out_channel, in_channel, kernel_size, kernel_size, generator=rng))
        self.modulation = EqualLinear(style_dim, in_channel, bias_init=1.0,
                                      rng=rng)
        if upsample:
            factor = 2
            p = (len(blur_kernel) - factor) - (kernel_size - 1)
            pad0, pad1 = (p + 1) // 2 + factor - 1, p // 2 + 1
            self.blur = Blur(blur_kernel, pad=(pad0, pad1),
                             upsample_factor=factor)
        self._prepared_key = None
        self._prepared = None

    def _prepare(self, w):
        """(weight in the kernel's layout, demod norm Σ(scale·w)² (Cout, Cin)
        or None): (3,3,Cin,Cout) for K1, (Cin,Cout) for K3, the reference
        (Cout,Cin,3,3) for the up-conv."""
        if self.upsample:
            wk = w
        elif self.kernel_size == 3:
            wk = w.permute(2, 3, 1, 0).contiguous()
        else:
            wk = w[:, :, 0, 0].t().contiguous()
        w2 = (self.scale * w).square().sum((2, 3)) if self.demodulate else None
        return wk, w2

    def prepared_weight(self, dtype=torch.float32):
        """(``_prepare`` of the current weight, K1's prepared buffer or
        None), computed once per weight version, device and compute dtype
        (fixed at inference, so not redone each forward); recomputed on
        every call when autograd needs a graph through it, and then without
        K1's buffer (the kernel prepares its weights per call). The buffer
        (``k1.prepare_weight``: the weights tiled for the tensor cores of
        K1's ``dtype`` form, ~2·9·Cin·Cout floats in fp32, 9·Cin·Cout bf16
        values in bf16) exists for a non-upsampling 3x3 conv on CUDA; it is
        None on the CPU."""
        weight = self.weight
        if torch.is_grad_enabled() and weight.requires_grad:
            return (*self._prepare(weight[0]), None)
        key = (weight._version, weight.device, weight.data_ptr(), dtype)
        if key != self._prepared_key:
            with torch.no_grad():
                wk, w2 = self._prepare(weight[0])
                wp = (k1.prepare_weight(wk, dtype=dtype)
                      if self.kernel_size == 3 and not self.upsample else None)
                self._prepared = (wk, w2, wp)
            self._prepared_key = key
        return self._prepared

    def forward(self, x, style, input_is_stylespace: bool = False, *,
                noise=None, noise_weight=None, bias=None, act: bool = False,
                residual=None, out_dtype=None):
        """x (B,H,W,Cin), fp32 or bf16 (the compute dtype); noise (B or
        1,H_out,W_out,1); bias (Cout,); residual (B,H_out,W_out,Cout). The
        output is in x's dtype, or ``out_dtype`` (the 1x1 conv only:
        ToRGB's fp32 from a bf16 input)."""
        b = x.shape[0]
        dt = x.dtype
        s = (style.reshape(b, self.in_channel) if input_is_stylespace
             else self.modulation(style))
        wk, w2, wp = self.prepared_weight(dt)
        demod = None if w2 is None else torch.rsqrt(s.square() @ w2.t() + 1e-8)
        style_eff = (self.scale * s).contiguous()
        if noise is not None:
            noise = upcast(noise)  # the epilogue's operands stay fp32

        if self.upsample:
            xm = (x * style_eff.to(dt)[:, None, None, :]).permute(0, 3, 1, 2)
            out = conv_transpose2d(xm, wk.transpose(0, 1).to(dt), 2)
            out = out.permute(0, 2, 3, 1)
            if demod is not None:
                out = out * demod.to(dt)[:, None, None, :]
            out = self.blur(out)
            nz = None if noise is None else noise[..., 0]
            return plain_epilogue(out, nz, noise_weight, bias, act, residual), s

        bsz, h, wd, _ = x.shape
        x = x.contiguous()
        if self.kernel_size == 3:
            nz = None if noise is None else noise[..., 0].contiguous()
            if residual is not None:
                raise ValueError("the 3x3 conv takes no residual")
            out = k1.modconv3x3(x, style_eff, wk, demod, nz, noise_weight,
                                bias, act, prepared=wp)
            return out, s
        p = h * wd
        nz = None if noise is None else noise.reshape(noise.shape[0], p)
        res = None if residual is None else residual.reshape(bsz, p, -1)
        out = k3.modconv1x1(x.reshape(bsz, p, self.in_channel), style_eff,
                            wk, demod, nz, noise_weight, bias, act, res,
                            out_dtype=out_dtype)
        return out.reshape(bsz, h, wd, self.out_channel), s


class NoiseInjection(nn.Module):
    """Holds the per-layer noise gain ``weight`` (1,)."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1))


class FusedLeakyReLU(nn.Module):
    """Holds the activation bias ``bias`` (C,)."""

    def __init__(self, channel: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channel))


class ConstantInput(nn.Module):
    """Learned 4x4 constant; parameter ``input`` (1, C, 4, 4), output NHWC."""

    def __init__(self, channel: int, size: int = 4,
                 rng: torch.Generator | None = None):
        super().__init__()
        self.input = nn.Parameter(torch.randn(1, channel, size, size,
                                              generator=rng))

    def forward(self, batch: int):
        const = self.input.permute(0, 2, 3, 1)
        return const.expand(batch, *const.shape[1:])


class StyledConv(nn.Module):
    """ModulatedConv2d + noise + FusedLeakyReLU: one kernel call for the
    non-upsampling convs."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int,
                 style_dim: int, upsample: bool = False,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1),
                 demodulate: bool = True, rng: torch.Generator | None = None):
        super().__init__()
        self.conv = ModulatedConv2d(in_channel, out_channel, kernel_size,
                                    style_dim, demodulate=demodulate,
                                    upsample=upsample, blur_kernel=blur_kernel,
                                    rng=rng)
        self.noise = NoiseInjection()
        self.activate = FusedLeakyReLU(out_channel)

    def forward(self, x, style, noise=None, input_is_stylespace: bool = False,
                rng: torch.Generator | None = None):
        """``noise`` (B or 1,H_out,W_out,1); when None it is drawn from
        ``rng``, which must then be given."""
        if noise is None:
            if rng is None:
                raise ValueError("pass noise, or a torch.Generator to draw it")
            up = 2 if self.conv.upsample else 1
            noise = torch.randn(x.shape[0], x.shape[1] * up, x.shape[2] * up, 1,
                                generator=rng, device=x.device)
        return self.conv(x, style, input_is_stylespace, noise=noise,
                         noise_weight=self.noise.weight,
                         bias=self.activate.bias, act=True)


class ToRGB(nn.Module):
    """1x1 modulated conv to RGB + bias + upsampled skip: one K3 call. The
    RGB and the skip chain are fp32 whatever the input's dtype (the JAX
    ToRGB's default ``rgb_dtype``)."""

    def __init__(self, in_channel: int, style_dim: int, upsample: bool = True,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1),
                 rng: torch.Generator | None = None):
        super().__init__()
        if upsample:
            self.upsample = Upsample(blur_kernel)
        self.conv = ModulatedConv2d(in_channel, 3, 1, style_dim,
                                    demodulate=False, rng=rng)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))

    def forward(self, x, style, skip=None, input_is_stylespace: bool = False):
        residual = None
        if skip is not None:
            residual = self.upsample(upcast(skip)).contiguous()
        return self.conv(x, style, input_is_stylespace,
                         bias=self.bias.view(3), residual=residual,
                         out_dtype=torch.promote_types(x.dtype, torch.float32))


class ConvLayer(nn.Sequential):
    """[Blur,] EqualConv2d[, FusedLeakyReLU | ScaledLeakyReLU], the
    discriminator's conv stack, indexed as the reference's Sequential. A
    downsampling layer blurs, then convolves with stride 2 and no padding."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int,
                 downsample: bool = False,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1), bias: bool = True,
                 activate: bool = True, rng: torch.Generator | None = None):
        layers = []
        if downsample:
            p = (len(blur_kernel) - 2) + (kernel_size - 1)
            layers.append(Blur(blur_kernel, pad=((p + 1) // 2, p // 2)))
            stride, padding = 2, 0
        else:
            stride, padding = 1, kernel_size // 2
        layers.append(EqualConv2d(in_channel, out_channel, kernel_size,
                                  stride=stride, padding=padding,
                                  bias=bias and not activate, rng=rng))
        if activate:
            layers.append(FusedLeakyReLU(out_channel) if bias
                          else ScaledLeakyReLU())
        super().__init__(*layers)
        self.downsample = downsample
        self.activate = activate

    def forward(self, x):
        if self.downsample:
            x = self[0](x)
        conv = self[1 if self.downsample else 0]
        if not self.activate:
            return conv(x)
        return conv.fused(x, getattr(self[-1], "bias", None), act=True)


class ResBlock(nn.Module):
    """Discriminator residual block: (conv1, downsampling conv2) + a
    downsampling 1x1 skip, over √2."""

    def __init__(self, in_channel: int, out_channel: int,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1),
                 rng: torch.Generator | None = None):
        super().__init__()
        self.conv1 = ConvLayer(in_channel, in_channel, 3, rng=rng)
        self.conv2 = ConvLayer(in_channel, out_channel, 3, downsample=True,
                               blur_kernel=blur_kernel, rng=rng)
        self.skip = ConvLayer(in_channel, out_channel, 1, downsample=True,
                              blur_kernel=blur_kernel, bias=False,
                              activate=False, rng=rng)

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        return (out + self.skip(x)) / math.sqrt(2.0)
