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
    sample·clusters. Returns (pooled (B, H, W), means (S,), counts (S,))."""
    flat_v = values.reshape(-1).float()
    flat_i = segment_ids.reshape(-1).long()
    sums = flat_v.new_zeros(num_segments).index_add_(0, flat_i, flat_v)
    counts = flat_v.new_zeros(num_segments).index_add_(
        0, flat_i, torch.ones_like(flat_v))
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
