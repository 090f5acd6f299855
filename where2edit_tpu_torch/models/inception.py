"""InceptionV3 feature extractor for FID / IS (counterpart of
where2edit_tpu/models/inception.py): torchvision's architecture, returning
the 2048-d pool3 features and the logits (1008 classes, the FID-standard
TF-ported checkpoint's; torchvision's own has 1000).

Parameters use torchvision's keys (``Conv2d_1a_3x3.conv.weight``,
``.bn.{weight,bias,running_mean,running_var}``,
``Mixed_5b.branch1x1.conv.weight``, …, ``fc.{weight,bias}``), so a
torchvision-layout state dict loads through ``InceptionV3.from_state_dict``
(its ``AuxLogits.*`` entries are dropped: the extractor never runs that
head).
BatchNorm always runs on its running statistics (eps 1e-3). NHWC in, NCHW
inside. Without a state dict the weights are drawn from ``rng``: convs
N(0, 2/fan_in), running means N(0, 0.01), variances U(0.5, 1.5).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from where2edit_tpu_torch.models.state import assign_state


class BasicConv2d(nn.Module):
    """Conv (no bias), BatchNorm (eps 1e-3) on running statistics, ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride: int = 1,
                 padding=0, rng: torch.Generator | None = None):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride, padding, bias=False,
                              device="meta")
        fan_in = in_ch * math.prod(self.conv.kernel_size)
        self.conv.weight = nn.Parameter(
            torch.randn(self.conv.weight.shape, generator=rng) * math.sqrt(2 / fan_in))
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-3)
        with torch.no_grad():
            self.bn.running_mean.copy_(0.1 * torch.randn(out_ch, generator=rng))
            self.bn.running_var.copy_(torch.rand(out_ch, generator=rng) + 0.5)

    def forward(self, x):
        x = F.batch_norm(self.conv(x), self.bn.running_mean, self.bn.running_var,
                         self.bn.weight, self.bn.bias, False, 0.0, self.bn.eps)
        return F.relu(x)


def _max_pool(x):
    return F.max_pool2d(x, 3, 2)


def _avg_pool3(x):
    # count_include_pad: divides by 9 at the borders too
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_ch: int, rng=None):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, 1, rng=rng)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, 1, rng=rng)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2, rng=rng)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1, rng=rng)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1, rng=rng)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1, rng=rng)
        self.branch_pool = BasicConv2d(in_ch, pool_ch, 1, rng=rng)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(_avg_pool3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int, rng=None):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, 3, stride=2, rng=rng)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1, rng=rng)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1, rng=rng)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2, rng=rng)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, c7: int, rng=None):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 192, 1, rng=rng)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, 1, rng=rng)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3), rng=rng)
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0), rng=rng)
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, 1, rng=rng)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0), rng=rng)
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3), rng=rng)
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0), rng=rng)
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3), rng=rng)
        self.branch_pool = BasicConv2d(in_ch, 192, 1, rng=rng)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3,
                     self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = conv(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avg_pool3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int, rng=None):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, 1, rng=rng)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2, rng=rng)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, 1, rng=rng)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3), rng=rng)
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0), rng=rng)
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2, rng=rng)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for conv in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, _max_pool(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, in_ch: int, rng=None):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 320, 1, rng=rng)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, 1, rng=rng)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1), rng=rng)
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0), rng=rng)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, 1, rng=rng)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1, rng=rng)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1), rng=rng)
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0), rng=rng)
        self.branch_pool = BasicConv2d(in_ch, 192, 1, rng=rng)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        return torch.cat([self.branch1x1(x), b3, bd,
                          self.branch_pool(_avg_pool3(x))], 1)


class InceptionV3(nn.Module):
    """(B, H, W, 3) → (pool3 features (B, 2048), logits (B, num_classes)).
    The smallest input it takes is 75²; FID feeds 299²."""

    def __init__(self, num_classes: int = 1008, rng: torch.Generator | None = None):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2, rng=rng)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3, rng=rng)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1, rng=rng)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1, rng=rng)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3, rng=rng)
        self.Mixed_5b = InceptionA(192, 32, rng)
        self.Mixed_5c = InceptionA(256, 64, rng)
        self.Mixed_5d = InceptionA(288, 64, rng)
        self.Mixed_6a = InceptionB(288, rng)
        self.Mixed_6b = InceptionC(768, 128, rng)
        self.Mixed_6c = InceptionC(768, 160, rng)
        self.Mixed_6d = InceptionC(768, 160, rng)
        self.Mixed_6e = InceptionC(768, 192, rng)
        self.Mixed_7a = InceptionD(768, rng)
        self.Mixed_7b = InceptionE(1280, rng)
        self.Mixed_7c = InceptionE(2048, rng)
        self.fc = nn.Linear(2048, num_classes, device="meta")
        self.fc.weight = nn.Parameter(torch.randn(num_classes, 2048, generator=rng)
                                      / math.sqrt(2048))
        self.fc.bias = nn.Parameter(torch.zeros(num_classes))

    def forward(self, x: torch.Tensor):
        x = x.permute(0, 3, 1, 2).contiguous()
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max_pool(x)))
        x = _max_pool(x)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                      self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e,
                      self.Mixed_7a, self.Mixed_7b, self.Mixed_7c):
            x = block(x)
        feats = x.mean((2, 3))
        return feats, self.fc(feats)

    @classmethod
    def from_state_dict(cls, state_dict: dict) -> "InceptionV3":
        """A torchvision-layout state dict → ``InceptionV3`` on the CPU,
        built on the meta device and holding the dict's tensors (the class
        count is read from ``fc.weight``). ``AuxLogits.*`` entries are
        dropped and missing ``num_batches_tracked`` counters allowed;
        anything else missing or unexpected raises."""
        sd = {k: v for k, v in state_dict.items() if not k.startswith("AuxLogits.")}
        with torch.device("meta"):
            model = cls(num_classes=sd["fc.weight"].shape[0])
        return assign_state(model, sd)

