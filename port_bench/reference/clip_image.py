"""CLIP's image tower (ViT-B/32: 224², patches of 32, width 768, 12
layers, 12 heads) as plain formulas over an OpenAI-layout state dict, and
Where2edit's way into it: the generator's [-1, 1] image upsampled ×7 by
repetition and average-pooled by size/32 to 224² (no CLIP normalisation),
as attention/run_attention.py's CLIPLoss does."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from port_bench.reference.clip_text import _block


def resize_224(image: torch.Tensor) -> torch.Tensor:
    """(B, 3, S, S) → (B, 3, 224, 224): nearest ×7, then avg-pool S/32."""
    s = image.shape[-1]
    up = image.repeat_interleave(7, 2).repeat_interleave(7, 3)
    return F.avg_pool2d(up, s // 32)


def encode_image(sd: dict, cfg: dict, image: torch.Tensor) -> torch.Tensor:
    """image (B, 3, 224, 224) → (B, output_dim)."""
    p = "visual."
    x = F.conv2d(image, sd[p + "conv1.weight"], stride=cfg["patch_size"])
    x = x.flatten(2).transpose(1, 2)
    cls = sd[p + "class_embedding"].expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], 1) + sd[p + "positional_embedding"]
    d = x.shape[-1]
    x = F.layer_norm(x, (d,), sd[p + "ln_pre.weight"], sd[p + "ln_pre.bias"], 1e-5)
    for i in range(cfg["layers"]):
        x = _block(sd, f"{p}transformer.resblocks.{i}", x, 0.0, cfg["heads"])
    x = F.layer_norm(x[:, 0], (d,), sd[p + "ln_post.weight"], sd[p + "ln_post.bias"], 1e-5)
    return x @ sd[p + "proj"]
