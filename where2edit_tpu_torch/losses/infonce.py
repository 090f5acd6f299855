"""Global-batch InfoNCE consistency loss (counterpart of
where2edit_tpu/losses/infonce.py): CE(norm(img) @ norm(cond)ᵀ /
temperature, arange).

With ``gather`` and a data-parallel group, the image and condition features
are all-gathered with their gradient first (the reference's
``GatherLayer``, run_attention.py:1312-1318; JAX's ``lax.all_gather`` at
``axis_name``), so every rank computes the one global loss. The gather's
backward sums the gradient over the ranks, which the trainer's average then
divides back: the mapper's gradient is the global one. Outside a group it is
the single-card loss, as JAX's with ``axis_name=None``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from where2edit_tpu_torch.parallel.collectives import gather_with_grad


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True)


def infonce_consistency(image_features: torch.Tensor,
                        cond_features: torch.Tensor,
                        temperature: float = 0.01,
                        gather: bool = False) -> torch.Tensor:
    if gather:
        image_features = gather_with_grad(image_features)
        cond_features = gather_with_grad(cond_features)
    logits = (_normalize(image_features) @ _normalize(cond_features).t()) / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    return F.cross_entropy(logits, labels)
