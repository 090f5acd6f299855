"""VGG16 perceptual loss (counterpart of where2edit_tpu/losses/perceptual.py).

As the reference: its ``normalize_batch`` is a no-op (the ImageNet
normalisation is commented out), so [-1, 1] images reach VGG unnormalised,
and the loss is the MSE of relu2_2 after ``clip_image_resize``. VGG stops at
relu2_2.
"""

from __future__ import annotations

import torch

from where2edit_tpu_torch.losses.clip_loss import clip_image_resize


def normalize_batch(x: torch.Tensor) -> torch.Tensor:
    """The reference's no-op normalisation, kept as a named step."""
    return x


class PerceptualLoss:
    def __init__(self, vgg, stylegan_size: int = 1024):
        self.vgg = vgg
        self.stylegan_size = stylegan_size

    def features(self, image: torch.Tensor) -> torch.Tensor:
        x = normalize_batch(clip_image_resize(image, self.stylegan_size))
        return self.vgg(x, last="relu2_2").relu2_2

    def __call__(self, image1: torch.Tensor, image2: torch.Tensor) -> torch.Tensor:
        """mean((vgg(image1) - vgg(image2))²); ``image2`` may have batch 1
        against ``image1``'s batch (the trainer's row-0 target), which is
        the mean over its broadcast."""
        return (self.features(image1) - self.features(image2)).square().mean()
