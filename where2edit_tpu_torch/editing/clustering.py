"""Semantic-region discovery (counterpart of
where2edit_tpu/editing/clustering.py): the k-means clustering matrix of a
feature tap, nearest-centre assignment, and the k-means fit.

The fit runs on the host (sklearn when importable, else the native C++
Lloyd, ``utils/native.py``) or, with ``backend="torch"``, as a Lloyd
iteration on the data's device (the counterpart of JAX's ``"jax"``
backend).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from where2edit_tpu_torch.ops.interpolate import interpolate_bilinear


def pairwise_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared euclidean (N, M) x (K, M) → (N, K) as |a|² - 2ab + |b|²."""
    a2 = a.square().sum(-1, keepdim=True)
    b2 = b.square().sum(-1)
    return a2 - 2.0 * (a @ b.t()) + b2[None, :]


def cluster_features(blend_feature: torch.Tensor, *,
                     upsample2: bool = False) -> torch.Tensor:
    """(B, H, W, C) tap → (B·S·S, C + 2·(C//16)): the features, then C//16
    copies of the x position and of the y position, each in [-1, 1].
    ``upsample2`` first resizes the tap bilinearly ×2 (align_corners), as
    phase-1 collection does; without it S = H, the in-mapper assignment."""
    b, h, _, c = blend_feature.shape
    size = 2 * h if upsample2 else h
    feat = (interpolate_bilinear(blend_feature, size, align_corners=True)
            if upsample2 else blend_feature)
    pc = c // 16
    r = (torch.arange(size, device=feat.device, dtype=feat.dtype)
         * 2.0 / float(size - 1) - 1.0)
    x_pos = r[None, None, :, None].expand(b, size, size, pc)
    y_pos = r[None, :, None, None].expand(b, size, size, pc)
    concat = torch.cat([feat, x_pos, y_pos], dim=-1)
    return concat.reshape(-1, c + 2 * pc)


def assign_clusters(blend_feature: torch.Tensor, centers: torch.Tensor, *,
                    offset_per_sample: bool = True) -> torch.Tensor:
    """Nearest-centre ids (B, S, S), offset by sample·K unless
    ``offset_per_sample`` is False."""
    b, h, w, _ = blend_feature.shape
    k = centers.shape[0]
    feats = cluster_features(blend_feature)
    ids = pairwise_distance(feats, centers.to(feats.dtype)).argmin(dim=1)
    ids = ids.reshape(b, h, w)
    if offset_per_sample:
        ids = ids + (torch.arange(b, device=ids.device) * k)[:, None, None]
    return ids


def _lloyd(data: torch.Tensor, init_centers: torch.Tensor, num_clusters: int,
           num_iters: int) -> torch.Tensor:
    """``num_iters`` Lloyd steps on ``data``'s device: assign each row to its
    nearest centre, then move each centre to its rows' mean (an empty
    cluster keeps its centre). The per-cluster sums are one-hot products."""
    centers = init_centers.to(data.dtype)
    a2 = data.square().sum(-1, keepdim=True)
    for _ in range(num_iters):
        d = a2 - 2.0 * (data @ centers.t()) + centers.square().sum(-1)[None, :]
        onehot = F.one_hot(d.argmin(dim=1), num_clusters).to(data.dtype)
        counts = onehot.sum(0)
        new = (onehot.t() @ data) / counts.clamp(min=1.0)[:, None]
        centers = torch.where((counts > 0)[:, None], new, centers)
    return centers


def _host(data) -> np.ndarray:
    if isinstance(data, torch.Tensor):
        data = data.detach().cpu().numpy()
    return np.asarray(data, dtype=np.float32)


def _fit_native(data, num_clusters, num_iters, seed):
    from where2edit_tpu_torch.utils.native import kmeans_fit_native  # noqa: PLC0415

    out = kmeans_fit_native(_host(data), num_clusters, max_iters=num_iters,
                            seed=seed)
    return None if out is None else out[0]


def kmeans_fit(data, num_clusters: int = 10, *, seed: int = 42,
               num_iters: int = 50, backend: str | None = None) -> np.ndarray:
    """Fit cluster centers → numpy (num_clusters, D). ``data``: (N, D)
    numpy or tensor.

    Backends, as the JAX package orders them:
      * 'sklearn' (the default) — ``KMeans(random_state=seed)``, the
        reference's fit; without sklearn, native, then torch;
      * 'native'  — the multithreaded C++ Lloyd (k-means++ seeding), for
        large matrices; without the library, sklearn;
      * 'torch'   — Lloyd on the tensor's device (a numpy array runs on
        the CPU), from ``num_clusters`` distinct rows drawn with ``seed``."""
    backend = backend or "sklearn"
    if backend == "native":
        out = _fit_native(data, num_clusters, num_iters, seed)
        if out is not None:
            return out
        backend = "sklearn"
    if backend == "sklearn":
        try:
            from sklearn.cluster import KMeans  # noqa: PLC0415
        except ImportError:
            out = _fit_native(data, num_clusters, num_iters, seed)
            if out is not None:
                return out
        else:
            km = KMeans(n_clusters=num_clusters, random_state=seed).fit(_host(data))
            return km.cluster_centers_.astype(np.float32)
    x = data if isinstance(data, torch.Tensor) else torch.from_numpy(_host(data))
    x = x.float()
    idx = torch.randperm(x.shape[0], generator=torch.Generator().manual_seed(seed))
    init = x[idx[:num_clusters].to(x.device)]
    return _lloyd(x, init, num_clusters, num_iters).cpu().numpy()
