"""VGG16's trunk through relu2_2 (Simonyan & Zisserman 2015, torchvision's
``features`` layout), the tap of Where2edit's perceptual loss, on the
224² resize of the generator's image without normalisation."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def relu2_2(sd: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, 3, 224, 224) → (B, 128, 112, 112)."""
    for idx in (0, 2):
        x = torch.relu(F.conv2d(x, sd[f"features.{idx}.weight"], sd[f"features.{idx}.bias"],
                                padding=1))
    x = F.max_pool2d(x, 2)
    for idx in (5, 7):
        x = torch.relu(F.conv2d(x, sd[f"features.{idx}.weight"], sd[f"features.{idx}.bias"],
                                padding=1))
    return x
