"""CLIP similarity loss and image features (counterpart of
where2edit_tpu/losses/clip_loss.py).

As the reference: images are resized by nearest ×7 upsampling then an
average pool of stylegan_size // 32 (not a proper resize to 224), computed
here as one banded (224, S) matrix applied along each axis, so the ×7
image (7168² at 1024²) is never made; and images enter CLIP in the
generator's [-1, 1] range without CLIP's mean/std normalisation.
"""

from __future__ import annotations

import torch

from where2edit_tpu_torch.ops.interpolate import upsample_repeat


def _resize_matrix(src: int, up: int, k: int, device=None) -> torch.Tensor:
    """Row-stochastic (src·up/k, src) matrix of repeat-upsample(up) then
    avgpool(k): W[o, i] = |[k·o, k·o+k) ∩ [up·i, up·i+up)| / k, built on
    ``device`` (no host copy; the entries are multiples of 1/k, exact in
    fp32)."""
    o = torch.arange(src * up // k, device=device)[:, None]
    i = torch.arange(src, device=device)[None, :]
    overlap = (torch.minimum(k * o + k, up * i + up) - torch.maximum(k * o, up * i))
    return overlap.clamp(min=0).float() / k


def clip_image_resize(image: torch.Tensor, stylegan_size: int) -> torch.Tensor:
    """(B, S, S, 3) → (B, 224, 224, 3), the reference's upsample(×7) +
    avgpool(S // 32); below 32 (k = 0) a repeat-upsample to 224."""
    if stylegan_size < 32:
        return upsample_repeat(image, 224 // image.shape[1])
    w = _resize_matrix(image.shape[1], 7, stylegan_size // 32, image.device).to(image.dtype)
    x = torch.einsum("oh,bhwc->bowc", w, image)
    return torch.einsum("pw,bowc->bopc", w, x)


class CLIPLoss:
    """CLIP image and text features of the generator's images, and the
    reference's loss = 1 - logits_per_image / 100."""

    def __init__(self, clip_model, stylegan_size: int = 1024):
        self.model = clip_model
        self.stylegan_size = stylegan_size

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        """image: the generator's output (B, S, S, 3) in [-1, 1]."""
        return self.model.encode_image(clip_image_resize(image, self.stylegan_size))

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.model.encode_text(tokens)

    def __call__(self, image: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        logits_per_image, _ = self.model(
            clip_image_resize(image, self.stylegan_size), tokens)
        return 1.0 - logits_per_image / 100.0
