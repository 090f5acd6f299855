"""GAN-inversion encoders of the pSp / e4e family (counterpart of
where2edit_tpu/models/encoders.py).

Every encoder is the IR-SE trunk (``models/irse.py``) plus a readout, with
NHWC input (B, H, W, 3) in [-1, 1] and W+ output (B, style_count, 512),
style_count = 2·log2(stylegan_size) − 2. The FPN encoders read body taps
6 / 20 / 23 (c1, c2, c3) through ``style_count`` ``GradualStyleBlock``s:
rows 0–2 from c3 (nominal 16²), 3–6 from p2 = up(c3) + latlayer1(c2)
(32²), the rest from p1 = up(p2) + latlayer2(c1) (64²). Parameters in the
reference layout (``styles.{i}.convs.{2j}``, ``styles.{i}.linear``,
``latlayer1/2``, ``linear``).

The tracer's spans (``utils/profiling.py``): ``encoder.trunk`` around the
IR-SE trunk as an encoder runs it, ``encoder.styles`` around the readout
(the FPN laterals and the style blocks, or the W encoder's linear).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from where2edit_tpu_torch.models.irse import IRSEBody, conv2d
from where2edit_tpu_torch.nn.layers import EqualLinear
from where2edit_tpu_torch.utils.profiling import span

# e4e's progressive training stage at inference: every row active
PROGRESSIVE_STAGE_INFERENCE = 18


def _upsample_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """FPN merge, NCHW: bilinear (align_corners=True) up to y's size, + y."""
    return F.interpolate(x, size=y.shape[2:], mode="bilinear",
                         align_corners=True) + y


class GradualStyleBlock(nn.Module):
    """log2(spatial) stride-2 3x3 convs, each with lrelu(0.01), to a 1x1
    map, then an ``EqualLinear``. NCHW in, (B, out_c) out. The input must
    reach 1x1 after those convs (it does from the 256² encoder input or any
    smaller one)."""

    def __init__(self, in_c: int, out_c: int, spatial: int,
                 rng: torch.Generator | None = None):
        super().__init__()
        self.out_c = out_c
        convs = []
        for i in range(int(math.log2(spatial))):
            convs += [conv2d(in_c if i == 0 else out_c, out_c, 3, 2, 1,
                             bias=True, rng=rng), nn.LeakyReLU(0.01)]
        self.convs = nn.Sequential(*convs)
        self.linear = EqualLinear(out_c, out_c, lr_mul=1.0, rng=rng)

    def forward(self, x):
        x = self.convs(x)
        return self.linear(x.reshape(x.shape[0], self.out_c))


class _EncoderBase(IRSEBody):
    def __init__(self, num_layers: int = 50, mode: str = "ir_se",
                 stylegan_size: int = 1024, rng: torch.Generator | None = None):
        super().__init__(num_layers, mode, rng=rng)
        self.style_count = 2 * int(math.log2(stylegan_size)) - 2
        self.coarse_ind, self.middle_ind = 3, 7

    def _taps(self, x: torch.Tensor):
        """NHWC image -> (c1, c2, c3), NCHW."""
        with span("encoder.trunk"):
            _, taps = self.trunk(x.permute(0, 3, 1, 2).contiguous())
        return taps[6], taps[20], taps[23]


class _FPNEncoder(_EncoderBase):
    """The trunk, ``style_count`` style blocks and the two lateral 1x1
    convs."""

    def __init__(self, num_layers: int = 50, mode: str = "ir_se",
                 stylegan_size: int = 1024, rng: torch.Generator | None = None):
        super().__init__(num_layers, mode, stylegan_size, rng)
        self.styles = nn.ModuleList([
            GradualStyleBlock(512, 512, 16 if i < self.coarse_ind
                              else 32 if i < self.middle_ind else 64, rng)
            for i in range(self.style_count)])
        self.latlayer1 = conv2d(256, 512, 1, bias=True, rng=rng)
        self.latlayer2 = conv2d(128, 512, 1, bias=True, rng=rng)


class GradualStyleEncoder(_FPNEncoder):
    """pSp: every W+ row from its own style block."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c1, c2, c3 = self._taps(x)
        with span("encoder.styles"):
            rows = [self.styles[j](c3) for j in range(self.coarse_ind)]
            p2 = _upsample_add(c3, self.latlayer1(c2))
            rows += [self.styles[j](p2)
                     for j in range(self.coarse_ind, self.middle_ind)]
            p1 = _upsample_add(p2, self.latlayer2(c1))
            rows += [self.styles[j](p1)
                     for j in range(self.middle_ind, self.style_count)]
            return torch.stack(rows, 1)


class Encoder4Editing(_FPNEncoder):
    """e4e: a base code w0 (style block 0) in every row, plus the deltas of
    blocks 1 … limit − 1, limit = min(progressive_stage + 1, style_count);
    the rows from ``limit`` on stay at w0 (their blocks do not run)."""

    def __init__(self, num_layers: int = 50, mode: str = "ir_se",
                 stylegan_size: int = 1024,
                 progressive_stage: int = PROGRESSIVE_STAGE_INFERENCE,
                 rng: torch.Generator | None = None):
        super().__init__(num_layers, mode, stylegan_size, rng)
        self.progressive_stage = progressive_stage

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c1, c2, c3 = self._taps(x)
        with span("encoder.styles"):
            w0 = self.styles[0](c3)
            rows = [w0]
            features = c3
            limit = min(self.progressive_stage + 1, self.style_count)
            for i in range(1, self.style_count):
                if i >= limit:
                    rows.append(w0)
                    continue
                if i == self.coarse_ind:
                    p2 = features = _upsample_add(c3, self.latlayer1(c2))
                elif i == self.middle_ind:
                    features = _upsample_add(p2, self.latlayer2(c1))
                rows.append(w0 + self.styles[i](features))
            return torch.stack(rows, 1)


class BackboneEncoderUsingLastLayerIntoW(_EncoderBase):
    """Single W: the trunk's last map, averaged over space, through an
    ``EqualLinear``, repeated in every row."""

    def __init__(self, num_layers: int = 50, mode: str = "ir_se",
                 stylegan_size: int = 1024, rng: torch.Generator | None = None):
        super().__init__(num_layers, mode, stylegan_size, rng)
        self.linear = EqualLinear(512, 512, lr_mul=1.0, rng=rng)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("encoder.trunk"):
            feat, _ = self.trunk(x.permute(0, 3, 1, 2).contiguous())
        with span("encoder.styles"):
            w = self.linear(feat.mean((2, 3)))
            return w[:, None, :].repeat(1, self.style_count, 1)
