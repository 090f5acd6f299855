"""Cluster-region pooling (counterpart of where2edit_tpu/ops/segment.py).

Every pixel of the attention map is replaced by the mean over its k-means
region; an empty cluster has mean 0, which leaves the pooled map untouched
and adds nothing to the coverage penalty (the reference's NaN skip).
"""

from __future__ import annotations

import torch


def segment_mean_map(values: torch.Tensor, segment_ids: torch.Tensor,
                     num_segments: int):
    """values (B, H, W) float; segment_ids (B, H, W) int, already offset by
    sample·clusters. Returns (pooled (B, H, W), means (S,), counts (S,)).

    The sums are a product with the one-hot id matrix, not an atomic
    scatter, so the same inputs give the same bits on the card (an edit is
    reproducible)."""
    flat_v = values.reshape(-1).float()
    flat_i = segment_ids.reshape(-1).long()
    onehot = flat_v.new_zeros(flat_v.shape[0], num_segments).scatter_(
        1, flat_i[:, None], 1.0)
    sums = flat_v @ onehot
    counts = onehot.sum(0)
    means = sums / counts.clamp(min=1.0)
    pooled = means[flat_i].reshape(values.shape).to(values.dtype)
    return pooled, means, counts


def cluster_coverage_penalty(means: torch.Tensor, counts: torch.Tensor,
                             batch: int, threshold: float = 0.7) -> torch.Tensor:
    """sum_k relu(mean_k - threshold) over non-empty clusters, averaged over
    the batch."""
    per_seg = torch.where(counts > 0, torch.relu(means - threshold),
                          torch.zeros_like(means))
    return per_seg.sum() / float(batch)
