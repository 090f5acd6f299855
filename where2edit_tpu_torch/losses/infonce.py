"""InfoNCE consistency loss on one card (counterpart of
where2edit_tpu/losses/infonce.py without the cross-device all-gather):
CE(norm(img) @ norm(cond)ᵀ / temperature, arange)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True)


def infonce_consistency(image_features: torch.Tensor,
                        cond_features: torch.Tensor,
                        temperature: float = 0.01) -> torch.Tensor:
    logits = (_normalize(image_features) @ _normalize(cond_features).t()) / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    return F.cross_entropy(logits, labels)
