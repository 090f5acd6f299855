"""The StyleGAN2 generator and discriminator as plain formulas over a
state dict in the rosinality layout (Karras et al. 2020, config-f), NCHW,
float32.

Generator: the style MLP (PixelNorm, 8 equalised linears at lr 0.01), a
learned 4x4 constant, modulated 3x3 convs with demodulation (an upsampling
one per octave: transposed conv, stride 2, then a 4x4 FIR blur), noise
scaled by a learned gain, bias and leaky ReLU·√2, and 1x1 ToRGBs without
demodulation whose skip is FIR-upsampled. The region-attention synthesis of
Where2edit blends ``m·x + (1 − m)·orig`` at the attention layer and, when
that layer is a conv, at its octave's ToRGB skip.

Discriminator: fromRGB 1x1, residual blocks (conv, blur + stride-2 conv,
blur + stride-2 1x1 skip, over √2), the minibatch-stddev channel, a 3x3
conv and two equalised linears.
"""

from __future__ import annotations

import math

import torch

from port_bench.reference.ops import (
    conv2d,
    conv_transpose2d,
    equal_linear,
    fir_kernel,
    lrelu,
    nearest,
    pixel_norm,
    upfirdn2d,
)


def channels(cfg: dict) -> dict:
    cm = cfg["channel_multiplier"]
    return {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * cm, 128: 128 * cm,
            256: 64 * cm, 512: 32 * cm, 1024: 16 * cm}


def n_latent(cfg: dict) -> int:
    return 2 * int(math.log2(cfg["size"])) - 2


def num_layers(cfg: dict) -> int:
    return 2 * (int(math.log2(cfg["size"])) - 2) + 1


def style_mlp(sd: dict, z: torch.Tensor, cfg: dict) -> torch.Tensor:
    x = pixel_norm(z)
    for i in range(1, cfg["n_mlp"] + 1):
        x = equal_linear(x, sd[f"style.{i}.weight"], sd[f"style.{i}.bias"],
                         lr_mul=cfg["lr_mlp"], act=True)
    return x


def conv_layers(cfg: dict) -> list:
    """(state-dict prefix, kind) of each styled layer in synthesis order:
    kind 'conv', 'up' or 'rgb'."""
    out = [("conv1", "conv"), ("to_rgb1", "rgb")]
    for k in range(int(math.log2(cfg["size"])) - 2):
        out += [(f"convs.{2 * k}", "up"), (f"convs.{2 * k + 1}", "conv"),
                (f"to_rgbs.{k}", "rgb")]
    return out


def latent_rows(cfg: dict) -> list:
    """The W+ row each styled layer reads."""
    rows = [0, 1]
    for k in range(int(math.log2(cfg["size"])) - 2):
        rows += [1 + 2 * k, 2 + 2 * k, 3 + 2 * k]
    return rows


def modulation(sd: dict, prefix: str, w: torch.Tensor) -> torch.Tensor:
    return equal_linear(w, sd[f"{prefix}.conv.modulation.weight"],
                        sd[f"{prefix}.conv.modulation.bias"])


def stylespace(sd: dict, cfg: dict, wplus: torch.Tensor) -> list:
    return [modulation(sd, p, wplus[:, r])
            for (p, _), r in zip(conv_layers(cfg), latent_rows(cfg))]


def modconv(sd: dict, prefix: str, x, s, *, up: bool = False, demod: bool = True):
    weight = sd[f"{prefix}.conv.weight"][0]
    cout, cin, k, _ = weight.shape
    w = weight / math.sqrt(cin * k * k)
    x = x * s[:, :, None, None]
    if up:
        y = conv_transpose2d(x, w.transpose(0, 1), 2)
    else:
        y = conv2d(x, w, 1, k // 2)
    if demod:
        d = torch.rsqrt(s.square() @ w.square().sum((2, 3)).t() + 1e-8)
        y = y * d[:, :, None, None]
    if up:
        y = upfirdn2d(y, fir_kernel(gain=4.0).to(y.device), pad=(1, 1))
    return y


def styled_conv(sd, prefix, x, s, noise, up: bool):
    y = modconv(sd, prefix, x, s, up=up)
    y = y + sd[f"{prefix}.noise.weight"] * noise
    return lrelu(y, sd[f"{prefix}.activate.bias"])


def to_rgb(sd, prefix, x, s, skip):
    y = modconv(sd, prefix, x, s, demod=False) + sd[f"{prefix}.bias"]
    if skip is not None:
        y = y + upfirdn2d(skip, fir_kernel(gain=4.0).to(y.device), up=2, pad=(2, 1))
    return y


def _is_rgb(layer: int) -> bool:
    return layer == 2 or (layer > 2 and (layer - 2) % 3 == 0)


def _blends_at(layer: int, attention_layer: int) -> bool:
    """Whether the tap of 1-based ``layer`` is blended: the attention layer
    itself, or the ToRGB of the octave whose conv it is."""
    if layer == attention_layer:
        return True
    if not _is_rgb(layer):
        return False
    since = (1,) if layer == 2 else (layer - 2, layer - 1)
    return attention_layer in since


def blend_taps(attention_layer: int, n_taps: int) -> list:
    return [i for i in range(n_taps) if _blends_at(i + 1, attention_layer)]


def synthesis(sd: dict, cfg: dict, styles, *, stylespace_input: bool,
              noise: list, attention_layer: int = 0, attention_map=None,
              orig_taps=None, tap_size=None, keep_taps=None):
    """``styles``: W+ (B, L, 512), or the list of S-space vectors with
    ``stylespace_input``. ``noise``: one (B or 1, 1, r, r) tensor per conv.
    Returns (image, S-space vectors, taps): the taps, as the capture stores
    them, are None outside ``keep_taps`` and nearest-subsampled to
    ``tap_size`` where larger; ``orig_taps`` are the taps blended against
    (whole or subsampled, resized to each layer's size by nearest)."""
    layers = conv_layers(cfg)
    if stylespace_input:
        svec = list(styles)
    else:
        svec = [modulation(sd, p, styles[:, r])
                for (p, _), r in zip(layers, latent_rows(cfg))]
    batch = svec[0].shape[0]
    taps = []

    def tap(x, idx):
        if attention_map is not None and _blends_at(idx + 1, attention_layer):
            m = nearest(attention_map, x.shape[-1])
            orig = orig_taps[idx]
            if orig.shape[-1] != x.shape[-1]:
                orig = nearest(orig, x.shape[-1])
            x = m * x + (1.0 - m) * orig
        if keep_taps is not None:
            if idx not in keep_taps:
                taps.append(None)
            else:
                h = x.shape[-1]
                step = h // tap_size if tap_size and h > tap_size else 1
                taps.append(x[:, :, ::step, ::step])
        return x

    x = sd["input.input"].expand(batch, -1, -1, -1)
    skip = None
    ni = 0
    for idx, ((prefix, kind), s) in enumerate(zip(layers, svec)):
        if kind == "rgb":
            skip = tap(to_rgb(sd, prefix, x, s, skip), idx)
        else:
            x = tap(styled_conv(sd, prefix, x, s, noise[ni], kind == "up"), idx)
            ni += 1
    return skip, svec, taps


def fixed_noise(sd: dict, cfg: dict) -> list:
    return [sd[f"noises.noise_{i}"] for i in range(num_layers(cfg))]


def discriminator(sd: dict, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, 3, size, size) → (B, 1)."""
    size = cfg["size"]
    blur = fir_kernel().to(x.device)

    def conv(prefix, x, stride=1, padding=0):
        w = sd[f"{prefix}.weight"]
        return conv2d(x, w / math.sqrt(w.shape[1] * w.shape[2] * w.shape[3]),
                      stride, padding)

    out = lrelu(conv("convs.0.0", x), sd["convs.0.1.bias"])
    for i in range(1, int(math.log2(size)) - 1):
        p = f"convs.{i}"
        y = lrelu(conv(f"{p}.conv1.0", out, 1, 1), sd[f"{p}.conv1.1.bias"])
        y = upfirdn2d(y, blur, pad=(2, 2))
        y = lrelu(conv(f"{p}.conv2.1", y, 2, 0), sd[f"{p}.conv2.2.bias"])
        skip = conv(f"{p}.skip.1", upfirdn2d(out, blur, pad=(1, 1)), 2, 0)
        out = (y + skip) / math.sqrt(2.0)
    b, c, h, w = out.shape
    group = min(b, 4)
    std = out.reshape(group, -1, c, h, w)
    std = torch.sqrt(std.var(0, unbiased=False) + 1e-8).mean((1, 2, 3))
    std = std.reshape(-1, 1, 1, 1).repeat(group, 1, h, w)
    out = torch.cat([out, std], 1)
    out = lrelu(conv("final_conv.0", out, 1, 1), sd["final_conv.1.bias"])
    out = equal_linear(out.reshape(b, -1), sd["final_linear.0.weight"],
                       sd["final_linear.0.bias"], act=True)
    return equal_linear(out, sd["final_linear.1.weight"], sd["final_linear.1.bias"])
