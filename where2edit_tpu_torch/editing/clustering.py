"""In-mapper cluster assignment (counterpart of
where2edit_tpu/editing/clustering.py ``cluster_features(upsample2=False)``
and ``assign_clusters``): nearest k-means centre per pixel of a feature tap,
with position channels appended."""

from __future__ import annotations

import torch


def pairwise_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared euclidean (N, M) x (K, M) → (N, K) as |a|² - 2ab + |b|²."""
    a2 = a.square().sum(-1, keepdim=True)
    b2 = b.square().sum(-1)
    return a2 - 2.0 * (a @ b.t()) + b2[None, :]


def cluster_features(blend_feature: torch.Tensor) -> torch.Tensor:
    """(B, S, S, C) tap → (B·S·S, C + 2·(C//16)): the features, then C//16
    copies of the x position and of the y position, each in [-1, 1]."""
    b, size, _, c = blend_feature.shape
    pc = c // 16
    r = (torch.arange(size, device=blend_feature.device,
                      dtype=blend_feature.dtype) * 2.0 / float(size - 1) - 1.0)
    x_pos = r[None, None, :, None].expand(b, size, size, pc)
    y_pos = r[None, :, None, None].expand(b, size, size, pc)
    concat = torch.cat([blend_feature, x_pos, y_pos], dim=-1)
    return concat.reshape(-1, c + 2 * pc)


def assign_clusters(blend_feature: torch.Tensor,
                    centers: torch.Tensor) -> torch.Tensor:
    """Nearest-centre ids (B, S, S), offset by sample·K."""
    b, h, w, _ = blend_feature.shape
    k = centers.shape[0]
    feats = cluster_features(blend_feature)
    dis = pairwise_distance(feats, centers.to(feats.dtype))
    ids = dis.argmin(dim=1).reshape(b, h, w)
    return ids + (torch.arange(b, device=ids.device) * k)[:, None, None]
