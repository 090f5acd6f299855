"""The IR-SE residual trunk of the pSp / e4e encoders (counterpart of
where2edit_tpu/models/irse.py).

Parameters use the reference layout (``input_layer.{0,1,2}``,
``body.{i}.shortcut_layer.{0,1}``, ``body.{i}.res_layer.{0..4}``, SE at
``res_layer.5.fc1/fc2``), so an e4e checkpoint's ``encoder.*`` entries load
as they are. The trunk is frozen wherever it is used: BatchNorm always runs
on its running statistics. Inside, activations are NCHW (BatchNorm and
PReLU want channels at dim 1); ``IRSEBody.forward`` and the encoders take
NHWC, as every public function of the port does.

Weights drawn from ``rng`` (a ``torch.Generator``) in module order: convs
N(0, 1/fan_in) with biases N(0, 0.01); BatchNorm running means N(0, 0.01)
and variances U(0.5, 1.5), so the running statistics are exercised; PReLU
slopes 0.25.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from where2edit_tpu_torch.models.state import assign_state

# body indices whose outputs feed the encoders' FPN (c1, c2, c3)
FPN_TAPS = (6, 20, 23)


class BlockSpec(NamedTuple):
    in_channel: int
    depth: int
    stride: int


def get_block(in_channel: int, depth: int, num_units: int,
              stride: int = 2) -> list[BlockSpec]:
    return [BlockSpec(in_channel, depth, stride)] + [
        BlockSpec(depth, depth, 1) for _ in range(num_units - 1)]


def get_blocks(num_layers: int) -> list[list[BlockSpec]]:
    """The stages of IR-SE 50 / 100 / 152."""
    units = {50: (3, 4, 14, 3), 100: (3, 13, 30, 3), 152: (3, 8, 36, 3)}
    if num_layers not in units:
        raise ValueError(f"invalid num_layers {num_layers}")
    widths = ((64, 64), (64, 128), (128, 256), (256, 512))
    return [get_block(i, d, n) for (i, d), n in zip(widths, units[num_layers])]


def conv2d(in_channel: int, out_channel: int, kernel_size: int,
           stride: int = 1, padding: int = 0, bias: bool = False,
           rng: torch.Generator | None = None) -> nn.Conv2d:
    """``nn.Conv2d`` with a seeded N(0, 1/fan_in) weight (no default init
    is drawn; under ``torch.device("meta")`` nothing is)."""
    conv = nn.Conv2d(in_channel, out_channel, kernel_size, stride, padding,
                     bias=bias, device="meta")
    fan_in = in_channel * kernel_size ** 2
    conv.weight = nn.Parameter(torch.randn(conv.weight.shape, generator=rng)
                               / math.sqrt(fan_in))
    if bias:
        conv.bias = nn.Parameter(0.1 * torch.randn(out_channel, generator=rng))
    return conv


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm on its running statistics (eps 1e-5) in train and eval mode
    alike: the trunk is always frozen."""

    def __init__(self, channels: int, rng: torch.Generator | None = None):
        super().__init__(channels, eps=1e-5)
        with torch.no_grad():
            self.running_mean.copy_(0.1 * torch.randn(channels, generator=rng))
            self.running_var.copy_(torch.rand(channels, generator=rng) + 0.5)

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class SEModule(nn.Module):
    """Squeeze-excite: x · sigmoid(fc2(relu(fc1(mean_hw(x)))))."""

    def __init__(self, channels: int, reduction: int = 16,
                 rng: torch.Generator | None = None):
        super().__init__()
        self.fc1 = conv2d(channels, channels // reduction, 1, rng=rng)
        self.fc2 = conv2d(channels // reduction, channels, 1, rng=rng)

    def forward(self, x):
        s = x.mean((2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(s))))


class BottleneckIR(nn.Module):
    """BN, 3x3 conv, PReLU, 3x3 conv (stride), BN [, SE], plus the shortcut:
    a strided slice (the reference's ``MaxPool2d(1, stride)``) when the
    widths agree, else a strided 1x1 conv and BN. NCHW."""

    def __init__(self, in_channel: int, depth: int, stride: int,
                 use_se: bool = True, rng: torch.Generator | None = None):
        super().__init__()
        self.stride = stride
        self.shortcut_layer = (None if in_channel == depth else nn.Sequential(
            conv2d(in_channel, depth, 1, stride, rng=rng),
            BatchNorm2d(depth, rng)))
        layers = [BatchNorm2d(in_channel, rng),
                  conv2d(in_channel, depth, 3, 1, 1, rng=rng),
                  nn.PReLU(depth),
                  conv2d(depth, depth, 3, stride, 1, rng=rng),
                  BatchNorm2d(depth, rng)]
        if use_se:
            layers.append(SEModule(depth, 16, rng))
        self.res_layer = nn.Sequential(*layers)

    def forward(self, x):
        if self.shortcut_layer is None:
            shortcut = x[:, :, :: self.stride, :: self.stride]
        else:
            shortcut = self.shortcut_layer(x)
        return self.res_layer(x) + shortcut


class IRSEBody(nn.Module):
    """``input_layer`` (3x3 conv, BN, PReLU) and the unrolled residual
    ``body``, with the FPN taps at body indices 6 / 20 / 23."""

    def __init__(self, num_layers: int = 50, mode: str = "ir_se",
                 rng: torch.Generator | None = None):
        super().__init__()
        self.input_layer = nn.Sequential(conv2d(3, 64, 3, 1, 1, rng=rng),
                                         BatchNorm2d(64, rng), nn.PReLU(64))
        self.body = nn.Sequential(*[
            BottleneckIR(s.in_channel, s.depth, s.stride,
                         use_se=mode == "ir_se", rng=rng)
            for stage in get_blocks(num_layers) for s in stage])

    def trunk(self, x: torch.Tensor):
        """NCHW in; (the last map, {tap index: map}), NCHW."""
        x = self.input_layer(x)
        taps = {}
        for i, block in enumerate(self.body):
            x = block(x)
            if i in FPN_TAPS:
                taps[i] = x
        return x, taps

    def forward(self, x: torch.Tensor, want_taps: bool = False):
        """(B, H, W, 3) -> the last map (B, H/16, W/16, 512) [, the taps],
        NHWC."""
        out, taps = self.trunk(x.permute(0, 3, 1, 2).contiguous())
        out = out.permute(0, 2, 3, 1)
        if want_taps:
            return out, {i: t.permute(0, 2, 3, 1) for i, t in taps.items()}
        return out


class BatchNorm1d(nn.BatchNorm1d):
    """BatchNorm1d on its running statistics, as ``BatchNorm2d``; without
    ``affine`` it has no scale or shift (the reference's ``affine=False``)."""

    def __init__(self, channels: int, affine: bool = True,
                 rng: torch.Generator | None = None):
        super().__init__(channels, eps=1e-5, affine=affine)
        with torch.no_grad():
            self.running_mean.copy_(0.1 * torch.randn(channels, generator=rng))
            self.running_var.copy_(torch.rand(channels, generator=rng) + 0.5)

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class Backbone(IRSEBody):
    """The ArcFace recognition net (counterpart of
    where2edit_tpu/models/irse.py ``Backbone``): the IR-SE trunk, then
    ``output_layer`` = BatchNorm2d, Dropout (inert: the net is frozen),
    Flatten (NCHW, as the reference's Linear expects), Linear(512·s² → 512),
    BatchNorm1d; the output is L2-normalised. (B, input_size, input_size, 3)
    in, (B, 512) out."""

    def __init__(self, input_size: int = 112, num_layers: int = 50,
                 mode: str = "ir_se", drop_ratio: float = 0.4,
                 affine: bool = True, rng: torch.Generator | None = None):
        if input_size not in (112, 224):
            raise ValueError(f"input_size must be 112 or 224, not {input_size}")
        super().__init__(num_layers, mode, rng)
        spatial = input_size // 16
        linear = nn.Linear(512 * spatial ** 2, 512, device="meta")
        linear.weight = nn.Parameter(torch.randn(linear.weight.shape, generator=rng)
                                     / math.sqrt(linear.in_features))
        linear.bias = nn.Parameter(0.1 * torch.randn(512, generator=rng))
        self.output_layer = nn.Sequential(
            BatchNorm2d(512, rng), nn.Dropout(drop_ratio), nn.Flatten(),
            linear, BatchNorm1d(512, affine, rng))
        self.input_size = input_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out, _ = self.trunk(x.permute(0, 3, 1, 2).contiguous())
        bn2d, _, flatten, linear, bn1d = self.output_layer  # no dropout
        out = bn1d(linear(flatten(bn2d(out))))
        return out / torch.linalg.norm(out, dim=1, keepdim=True)

    @classmethod
    def from_state_dict(cls, state_dict: dict, input_size: int = 112,
                        num_layers: int = 50, mode: str = "ir_se",
                        drop_ratio: float = 0.4) -> "Backbone":
        """A reference-layout ArcFace state dict (``input_layer.*``,
        ``body.*``, ``output_layer.*``) → ``Backbone`` on the CPU, built on
        the meta device and holding the dict's tensors; ``affine`` is read
        from the dict (``output_layer.4.weight``). Missing or unexpected
        keys raise."""
        with torch.device("meta"):
            model = cls(input_size, num_layers, mode, drop_ratio,
                        affine="output_layer.4.weight" in state_dict)
        return assign_state(model, state_dict)
