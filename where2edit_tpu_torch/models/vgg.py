"""VGG16 feature extractor for the perceptual loss (counterpart of
where2edit_tpu/models/vgg.py), NHWC at the boundary.

torchvision's ``vgg16.features`` sliced at relu1_2 / relu2_2 / relu3_3 /
relu4_3, with its parameter keys (``features.{idx}.weight`` / ``.bias``), so
a torchvision state dict loads through ``load_vgg16_state``. ``forward``
stops after the last tap its caller asks for: the perceptual loss reads
relu2_2 only, 9.4 of the 28 GFLOP of the trunk per 224² image.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

# torchvision vgg16.features conv positions and channel plan (through relu4_3)
VGG16_CONVS = [
    (0, 3, 64), (2, 64, 64),
    (5, 64, 128), (7, 128, 128),
    (10, 128, 256), (12, 256, 256), (14, 256, 256),
    (17, 256, 512), (19, 512, 512), (21, 512, 512),
]
_POOL_BEFORE = {5, 10, 17}  # a 2x2 max pool sits before these conv indices
TAPS = {2: "relu1_2", 7: "relu2_2", 14: "relu3_3", 21: "relu4_3"}


class VggFeatures(NamedTuple):
    relu1_2: Optional[torch.Tensor] = None
    relu2_2: Optional[torch.Tensor] = None
    relu3_3: Optional[torch.Tensor] = None
    relu4_3: Optional[torch.Tensor] = None


class Vgg16(nn.Module):
    """Conv trunk through relu4_3 with the four perceptual taps."""

    def __init__(self, rng: torch.Generator | None = None):
        super().__init__()
        self.features = nn.Module()
        for idx, cin, cout in VGG16_CONVS:
            conv = nn.Conv2d(cin, cout, 3, padding=1)
            with torch.no_grad():
                conv.weight.copy_(torch.randn(conv.weight.shape, generator=rng)
                                  * (2.0 / (cin * 9)) ** 0.5)
                conv.bias.zero_()
            self.features.add_module(str(idx), conv)

    def forward(self, x: torch.Tensor, last: str = "relu4_3") -> VggFeatures:
        """x (B, H, W, 3) → the taps up to and including ``last``, each
        (B, h, w, C); later taps are None."""
        if last not in TAPS.values():
            raise ValueError(f"unknown VGG16 tap {last!r}")
        x = x.permute(0, 3, 1, 2)
        taps = {}
        for idx, _, _ in VGG16_CONVS:
            if idx in _POOL_BEFORE:
                x = F.max_pool2d(x, 2)
            x = torch.relu(getattr(self.features, str(idx))(x))
            if idx in TAPS:
                taps[TAPS[idx]] = x.permute(0, 2, 3, 1)
                if TAPS[idx] == last:
                    break
        return VggFeatures(**taps)


def load_vgg16_state(model: Vgg16, state_dict: dict) -> Vgg16:
    """Load a torchvision vgg16 state dict ('features.N.weight', classifier
    entries ignored) or one of the features module alone ('N.weight')."""
    prefix = "features." if any(k.startswith("features.") for k in state_dict) else ""
    sd = {f"features.{idx}.{p}": state_dict[f"{prefix}{idx}.{p}"]
          for idx, _, _ in VGG16_CONVS for p in ("weight", "bias")}
    model.load_state_dict(sd)
    return model
