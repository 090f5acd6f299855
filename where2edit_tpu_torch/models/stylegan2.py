"""StyleGAN2 generator with region-attention synthesis, and the
discriminator (counterparts of where2edit_tpu/models/stylegan2.py), NHWC.

Layer schedule at 1024²: conv1, to_rgb1, then 8 octaves of (up-conv, conv,
to_rgb): 26 style vectors and 26 feature taps. The 1-based
``attention_layer`` indexes the tap list; blending at a conv layer also
rewrites the octave's to_rgb skip (the reference fork's ``this_layer``
coupling).

``Generator(dtype=torch.bfloat16)`` synthesises in bf16 (the JAX
Generator's ``dtype``): the activations, the convs and the taps are bf16
while the parameters, the style MLP, demod and the RGB skip chain stay
fp32, and the returned image is fp32. ``Discriminator(dtype=, remat=)``
runs its conv tower in ``dtype`` (the minibatch-stddev statistic and the
final linears in fp32) and, with ``remat``, recomputes each ``ResBlock``
in the backward pass (``torch.utils.checkpoint``) instead of keeping its
activations.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from where2edit_tpu_torch.nn.layers import (
    ConstantInput,
    ConvLayer,
    EqualLinear,
    PixelNorm,
    ResBlock,
    StyledConv,
    ToRGB,
)
from where2edit_tpu_torch.ops.interpolate import interpolate_nearest
from where2edit_tpu_torch.parallel.collectives import gather_with_grad
from where2edit_tpu_torch.parallel.dist import rows


def channel_table(channel_multiplier: int = 2) -> dict[int, int]:
    return {
        4: 512,
        8: 512,
        16: 512,
        32: 512,
        64: 256 * channel_multiplier,
        128: 128 * channel_multiplier,
        256: 64 * channel_multiplier,
        512: 32 * channel_multiplier,
        1024: 16 * channel_multiplier,
    }


class GeneratorOutput(NamedTuple):
    image: torch.Tensor                      # (B, size, size, 3)
    latent: Any = None                       # W+ (B, n_latent, 512) or S-space list
    style_vector: Optional[list] = None      # per-layer (B, C) S-space vectors
    feature_map: Optional[list] = None       # per-layer (B, h, w, C) taps


def _is_to_rgb(layer: int) -> bool:
    return layer == 2 or (layer > 2 and (layer - 2) % 3 == 0)


def _convs_since_prev_rgb(layer: int) -> tuple:
    return (1,) if layer == 2 else (layer - 2, layer - 1)


def blend_tap_indices(attention_layer: int) -> list:
    """0-based tap indices the masked blend reads: the attention layer and,
    when it is a conv, the octave's to_rgb skip."""
    idxs = {attention_layer - 1}
    layer = attention_layer + 1
    while not _is_to_rgb(layer):
        layer += 1
    if attention_layer in _convs_since_prev_rgb(layer):
        idxs.add(layer - 1)
    return sorted(idxs)


def _blend(out: torch.Tensor, mask: torch.Tensor, orig: torch.Tensor) -> torch.Tensor:
    """mask·out + (1-mask)·orig with the single-channel mask nearest-resized."""
    m = interpolate_nearest(mask, out.shape[1]).to(out.dtype)
    return m * out + (1.0 - m) * orig


class Generator(nn.Module):
    def __init__(self, size: int, style_dim: int = 512, n_mlp: int = 8,
                 channel_multiplier: int = 2,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1),
                 lr_mlp: float = 0.01, rng: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.size = size
        self.dtype = dtype  # of the synthesis (the parameters stay fp32)
        self.style_dim = style_dim
        self.log_size = int(math.log2(size))
        self.num_layers = (self.log_size - 2) * 2 + 1
        self.n_latent = self.log_size * 2 - 2
        ch = channel_table(channel_multiplier)
        self.channels = ch

        self.style = nn.Sequential(PixelNorm(), *[
            EqualLinear(style_dim, style_dim, lr_mul=lr_mlp,
                        activation="fused_lrelu", rng=rng)
            for _ in range(n_mlp)])
        self.input = ConstantInput(ch[4], rng=rng)
        self.conv1 = StyledConv(ch[4], ch[4], 3, style_dim,
                                blur_kernel=blur_kernel, rng=rng)
        self.to_rgb1 = ToRGB(ch[4], style_dim, upsample=False, rng=rng)
        self.convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        in_ch = ch[4]
        for i in range(3, self.log_size + 1):
            out_ch = ch[2 ** i]
            self.convs.append(StyledConv(in_ch, out_ch, 3, style_dim,
                                         upsample=True,
                                         blur_kernel=blur_kernel, rng=rng))
            self.convs.append(StyledConv(out_ch, out_ch, 3, style_dim,
                                         blur_kernel=blur_kernel, rng=rng))
            self.to_rgbs.append(ToRGB(out_ch, style_dim, blur_kernel=blur_kernel,
                                      rng=rng))
            in_ch = out_ch
        # fixed per-layer noise buffers, reference layout (1, 1, r, r)
        self.noises = nn.Module()
        for i in range(self.num_layers):
            r = 2 ** ((i + 5) // 2)
            self.noises.register_buffer(
                f"noise_{i}", torch.randn(1, 1, r, r, generator=rng))

    @property
    def device(self) -> torch.device:
        return self.input.input.device

    def style_mlp(self, z: torch.Tensor) -> torch.Tensor:
        """z → w: PixelNorm + the equalised fused-lrelu MLP."""
        return self.style(z)

    def mix_latents(self, w1: torch.Tensor, w2: torch.Tensor,
                    inject) -> torch.Tensor:
        """W+ (B, n_latent, 512) whose rows before ``inject`` come from w1
        (B, 512) and the rest from w2; ``inject`` is an int or a 0-dim
        tensor (it may stay on the device), ``n_latent`` for no mixing."""
        row = torch.arange(self.n_latent, device=w1.device)
        return torch.where(row[None, :, None] < inject, w1[:, None, :],
                           w2[:, None, :])

    def stylespace(self, w: torch.Tensor) -> list:
        """W+ (B, n_latent, 512) → the S-space vectors (B, C_i), in the
        forward pass's order (conv1, to_rgb1, then per octave the up-conv,
        the conv and the ToRGB), each the layer's ``modulation`` of its W+
        row: the forward's ``style_vector`` without the synthesis."""
        styles = [self.conv1.conv.modulation(w[:, 0]),
                  self.to_rgb1.conv.modulation(w[:, 1])]
        i = 1
        for oct_idx, to_rgb in enumerate(self.to_rgbs):
            styles += [self.convs[2 * oct_idx].conv.modulation(w[:, i]),
                       self.convs[2 * oct_idx + 1].conv.modulation(w[:, i + 1]),
                       to_rgb.conv.modulation(w[:, i + 2])]
            i += 2
        return styles

    def mean_latent(self, n_latent: int, rng: torch.Generator) -> torch.Tensor:
        z = torch.randn(n_latent, self.style_dim, generator=rng,
                        device=self.device)
        return self.style_mlp(z).mean(0, keepdim=True)

    def forward(self, styles, *, return_latents: bool = False,
                return_features: bool = False,
                inject_index: Optional[int] = None, truncation: float = 1.0,
                truncation_latent: Optional[torch.Tensor] = None,
                input_is_latent: bool = False,
                input_is_stylespace: bool = False,
                noise: Optional[list] = None, randomize_noise: bool = True,
                attention_layer: int = 0,
                attention_map: Optional[torch.Tensor] = None,
                feature_map: Optional[list] = None,
                tap_subsample: Optional[int] = None,
                tap_indices: Optional[Sequence[int]] = None,
                rng: torch.Generator | None = None) -> GeneratorOutput:
        """``styles``: list of (B, 512) z/w, or of one (B, n_latent, 512) W+,
        or with ``input_is_stylespace`` the list of (B, C_i) style vectors.
        ``attention_map`` (B, h, w, 1) blends against ``feature_map`` (taps of
        a prior ``return_features`` pass). ``tap_subsample``/``tap_indices``
        shape the stored taps: taps above ``tap_subsample`` are stored
        nearest-subsampled to it, taps not in ``tap_indices`` as None.
        ``rng`` draws the per-layer noise when ``randomize_noise`` and no
        ``noise`` is given, and the mixing index when two styles are given
        without ``inject_index``."""
        if not input_is_latent and not input_is_stylespace:
            styles = [self.style_mlp(s) for s in styles]

        if noise is None:
            if randomize_noise:
                noise = [None] * self.num_layers
            else:
                noise = [getattr(self.noises, f"noise_{i}").permute(0, 2, 3, 1)
                         for i in range(self.num_layers)]

        if truncation < 1 and not input_is_stylespace:
            styles = [truncation_latent + truncation * (s - truncation_latent)
                      for s in styles]

        if input_is_stylespace:
            latent = list(styles)
        elif len(styles) < 2:
            latent = (styles[0][:, None, :].expand(-1, self.n_latent, -1)
                      if styles[0].ndim < 3 else styles[0])
        else:
            if inject_index is None:
                if rng is None:
                    raise ValueError("pass inject_index, or a torch.Generator "
                                     "to draw it")
                inject_index = int(torch.randint(1, self.n_latent, (1,),
                                                 generator=rng,
                                                 device=rng.device))
            latent = self.mix_latents(styles[0], styles[1], inject_index)

        blending = attention_map is not None
        keep_taps = None if tap_indices is None else set(tap_indices)
        style_vector: list = []
        taps: list = []
        n_tapped = 0

        def tap(x):
            nonlocal n_tapped
            idx = n_tapped
            n_tapped += 1
            if blending and attention_layer >= 1:
                layer = idx + 1
                if layer == attention_layer or (
                        _is_to_rgb(layer)
                        and attention_layer in _convs_since_prev_rgb(layer)):
                    x = _blend(x, attention_map, feature_map[idx].to(x.dtype))
            if return_features:
                if keep_taps is not None and idx not in keep_taps:
                    taps.append(None)
                elif tap_subsample is not None and x.shape[1] > tap_subsample:
                    s = x.shape[1] // tap_subsample
                    taps.append(x[:, ::s, ::s, :])
                else:
                    taps.append(x)
            return x

        if input_is_stylespace:
            batch = latent[0].shape[0]
            get = lambda j: latent[j]  # noqa: E731
            first, second, i, step = latent[0], latent[1], 2, 3
        else:
            batch = latent.shape[0]
            get = lambda j: latent[:, j]  # noqa: E731
            first, second, i, step = latent[:, 0], latent[:, 1], 1, 2
        kw = dict(input_is_stylespace=input_is_stylespace)

        out = self.input(batch).to(self.dtype)
        out, s = self.conv1(out, first, noise=noise[0], rng=rng, **kw)
        out = tap(out)
        style_vector.append(s)
        skip, s = self.to_rgb1(out, second, **kw)
        skip = tap(skip)
        style_vector.append(s)

        for oct_idx, to_rgb in enumerate(self.to_rgbs):
            conv_up = self.convs[2 * oct_idx]
            conv = self.convs[2 * oct_idx + 1]
            out, s1 = conv_up(out, get(i), noise=noise[1 + 2 * oct_idx],
                              rng=rng, **kw)
            out = tap(out)
            out, s2 = conv(out, get(i + 1), noise=noise[2 + 2 * oct_idx],
                           rng=rng, **kw)
            out = tap(out)
            skip, s3 = to_rgb(out, get(i + 2), skip, **kw)
            skip = tap(skip)
            style_vector.extend([s1, s2, s3])
            i += step

        keep = return_latents or return_features
        return GeneratorOutput(
            image=skip,
            latent=latent if keep else None,
            style_vector=style_vector if keep else None,
            feature_map=taps if return_features else None)


class Discriminator(nn.Module):
    """ResBlocks down to 4², the minibatch-stddev channel, a 3x3 conv and
    two equalised linears; input (B, size, size, 3), output (B, 1).
    Parameters in the reference layout (``convs.N.…``, ``final_conv.…``,
    ``final_linear.{0,1}.…``)."""

    def __init__(self, size: int, channel_multiplier: int = 2,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1),
                 rng: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.dtype = dtype  # of the conv tower (the parameters stay fp32)
        self.remat = remat
        ch = channel_table(channel_multiplier)
        log_size = int(math.log2(size))
        convs = [ConvLayer(3, ch[size], 1, rng=rng)]
        in_ch = ch[size]
        for i in range(log_size, 2, -1):
            out_ch = ch[2 ** (i - 1)]
            convs.append(ResBlock(in_ch, out_ch, blur_kernel, rng=rng))
            in_ch = out_ch
        self.convs = nn.Sequential(*convs)
        self.stddev_group = 4
        # the minibatch-stddev over the data-parallel group's global batch
        # (set by the trainer in a group; off, the local batch)
        self.global_stddev = False
        self.final_conv = ConvLayer(in_ch + 1, ch[4], 3, rng=rng)
        self.final_linear = nn.Sequential(
            EqualLinear(ch[4] * 4 * 4, ch[4], activation="fused_lrelu", rng=rng),
            EqualLinear(ch[4], 1, rng=rng))

    def forward(self, x):
        out = x.to(self.dtype)
        for block in self.convs:
            if self.remat and isinstance(block, ResBlock):
                out = checkpoint(block, out, use_reentrant=False)
            else:
                out = block(out)
        b, h, w, c = out.shape
        # one stddev feature per group of min(B, 4) samples, sample i in
        # group i % (B / group) as the reference's view(group, -1, ...);
        # fp32, since a bf16 variance of near-equal values cancels. With
        # ``global_stddev`` B is the global batch: the ranks' activations
        # are gathered (differentiably) and each keeps its rows' feature
        src = out.float()
        if self.global_stddev:
            src = gather_with_grad(src)
        group = min(src.shape[0], self.stddev_group)
        stddev = src.reshape(group, -1, h, w, c)
        stddev = torch.sqrt(stddev.var(0, unbiased=False) + 1e-8)
        stddev = stddev.mean((1, 2, 3)).reshape(-1, 1, 1, 1).repeat(group, h, w, 1)
        if self.global_stddev:
            stddev = rows(stddev)
        out = torch.cat([out, stddev.to(out.dtype)], -1)
        out = self.final_conv(out)
        # the reference flattens NCHW
        return self.final_linear(out.float().permute(0, 3, 1, 2).reshape(b, -1))
