"""The e4e encoder (Tov et al. 2021, "Designing an Encoder for StyleGAN Image
Manipulation"; code github.com/omertov/encoder4editing, built on pSp's
``models/encoders/psp_encoders.py`` and ``helpers.py``) as plain formulas
over a state dict in the reference layout, NCHW, float32, forward only.

IR-SE trunk (``helpers.py``): ``input_layer`` = 3x3 conv (no bias), BN,
PReLU; then the bottleneck units of IR-SE 50 (3 / 4 / 14 / 3 units of
widths 64 / 128 / 256 / 512, the first of each stage strided 2). A unit:

    res      = SE(BN(conv3x3_s(PReLU(conv3x3(BN(x))))))
    SE(u)    = u · sigmoid(fc2(relu(fc1(mean_hw(u)))))    (1x1 convs, no bias, reduction 16)
    shortcut = MaxPool2d(1, s)(x)            when the widths agree
             = BN(conv1x1_s(x))              otherwise
    out      = res + shortcut

BN is its formula on the running statistics, (x − mean) / sqrt(var + 1e-5)
· γ + β (the encoder is frozen at inference). PReLU is max(x, 0) + a ·
min(x, 0) per channel.

FPN (``psp_encoders.py``): c1, c2, c3 are the outputs of units 6, 20 and
23; p2 = up(c3) + latlayer1(c2), p1 = up(p2) + latlayer2(c1), where up is
bilinear with ``align_corners=True`` to the lateral's size (pSp's
``_upsample_add``) and the laterals are 1x1 convs with bias.

``GradualStyleBlock(spatial)``: log2(spatial) stride-2 3x3 convs with bias,
each followed by LeakyReLU(0.01), to 1x1; then pSp's ``EqualLinear(512,
512, lr_mul=1)``: x · (W / sqrt(512))ᵀ + b.

e4e's ``Encoder4Editing.forward``: w0 = styles[0](c3) in every row; row i
(1 ≤ i < progressive_stage + 1) adds styles[i] of c3 (i < 3), p2 (i < 7)
or p1; rows from ``progressive_stage + 1`` on stay w0. pSp adds
``latent_avg`` (``start_from_latent_avg``).

Departures: the input is NHWC in [-1, 1] (the port's convention), permuted
to NCHW here; the encoder never runs in training mode, so BN's batch
statistics and dropout do not appear.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FPN_TAPS = (6, 20, 23)
UNITS = {50: (3, 4, 14, 3), 100: (3, 13, 30, 3), 152: (3, 8, 36, 3)}
WIDTHS = ((64, 64), (64, 128), (128, 256), (256, 512))


def units(num_layers: int) -> list:
    """(in width, out width, stride) of each bottleneck unit."""
    out = []
    for (cin, depth), n in zip(WIDTHS, UNITS[num_layers]):
        out += [(cin, depth, 2)] + [(depth, depth, 1)] * (n - 1)
    return out


def batch_norm(sd: dict, p: str, x: torch.Tensor) -> torch.Tensor:
    def c(v):
        return v[None, :, None, None]
    return ((x - c(sd[f"{p}.running_mean"])) / torch.sqrt(c(sd[f"{p}.running_var"]) + 1e-5)
            * c(sd[f"{p}.weight"]) + c(sd[f"{p}.bias"]))


def prelu(sd: dict, p: str, x: torch.Tensor) -> torch.Tensor:
    a = sd[f"{p}.weight"][None, :, None, None]
    return x.clamp(min=0) + a * x.clamp(max=0)


def conv(sd: dict, p: str, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    w = sd[f"{p}.weight"]
    return F.conv2d(x, w, sd.get(f"{p}.bias"), stride=stride, padding=w.shape[-1] // 2)


def squeeze_excite(sd: dict, p: str, u: torch.Tensor) -> torch.Tensor:
    s = u.mean((2, 3), keepdim=True)
    s = F.relu(F.conv2d(s, sd[f"{p}.fc1.weight"]))
    return u * torch.sigmoid(F.conv2d(s, sd[f"{p}.fc2.weight"]))


def bottleneck(sd: dict, p: str, x: torch.Tensor, cin: int, depth: int,
               stride: int, use_se: bool) -> torch.Tensor:
    if cin == depth:
        shortcut = F.max_pool2d(x, 1, stride)
    else:
        shortcut = batch_norm(sd, f"{p}.shortcut_layer.1",
                              conv(sd, f"{p}.shortcut_layer.0", x, stride))
    r = batch_norm(sd, f"{p}.res_layer.0", x)
    r = prelu(sd, f"{p}.res_layer.2", conv(sd, f"{p}.res_layer.1", r))
    r = batch_norm(sd, f"{p}.res_layer.4", conv(sd, f"{p}.res_layer.3", r, stride))
    if use_se:
        r = squeeze_excite(sd, f"{p}.res_layer.5", r)
    return r + shortcut


def trunk(sd: dict, x: torch.Tensor, num_layers: int = 50, use_se: bool = True) -> dict:
    """NCHW image -> {unit index: output} at the FPN taps."""
    x = prelu(sd, "input_layer.2", batch_norm(sd, "input_layer.1", conv(sd, "input_layer.0", x)))
    taps = {}
    for i, (cin, depth, stride) in enumerate(units(num_layers)):
        x = bottleneck(sd, f"body.{i}", x, cin, depth, stride, use_se)
        if i in FPN_TAPS:
            taps[i] = x
    return taps


def upsample_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, size=y.shape[2:], mode="bilinear", align_corners=True) + y


def style_block(sd: dict, p: str, x: torch.Tensor, spatial: int) -> torch.Tensor:
    for j in range(int(math.log2(spatial))):
        x = F.leaky_relu(conv(sd, f"{p}.convs.{2 * j}", x, 2), 0.01)
    x = x.reshape(x.shape[0], -1)
    w = sd[f"{p}.linear.weight"]
    return F.linear(x, w / math.sqrt(w.shape[1]), sd[f"{p}.linear.bias"])


def block_spatial(i: int, coarse: int, middle: int) -> int:
    return 16 if i < coarse else 32 if i < middle else 64


@torch.no_grad()
def encode(sd: dict, ecfg: dict, photos: torch.Tensor, latent_avg: torch.Tensor) -> torch.Tensor:
    """NHWC photos (B, 256, 256, 3) in [-1, 1] -> W+ (B, n_styles, 512)
    with ``latent_avg`` ((n_styles, 512) or (512,)) added. ``sd``: the
    encoder's entries (``encoder.`` removed)."""
    n = 2 * int(math.log2(ecfg["stylegan_size"])) - 2
    coarse, middle = ecfg["coarse_ind"], ecfg["middle_ind"]
    taps = trunk(sd, photos.permute(0, 3, 1, 2).float(), ecfg["num_layers"],
                 ecfg["mode"] == "ir_se")
    c1, c2, c3 = (taps[i] for i in FPN_TAPS)
    p2 = upsample_add(c3, conv(sd, "latlayer1", c2))
    p1 = upsample_add(p2, conv(sd, "latlayer2", c1))
    features = {16: c3, 32: p2, 64: p1}
    w0 = style_block(sd, "styles.0", c3, 16)
    rows = [w0]
    for i in range(1, n):
        if i > ecfg["progressive_stage"]:
            rows.append(w0)
        else:
            s = block_spatial(i, coarse, middle)
            rows.append(w0 + style_block(sd, f"styles.{i}", features[s], s))
    out = torch.stack(rows, 1)
    if ecfg["start_from_latent_avg"]:
        out = out + latent_avg
    return out
