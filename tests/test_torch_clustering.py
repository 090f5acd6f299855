"""The port's k-means regions against the JAX package's
(where2edit_tpu/editing/clustering.py) on the same numpy inputs: the
clustering matrix with and without the bilinear ×2 (1e-5), the nearest-
centre ids with and without the per-sample offset (equal), the Lloyd
iteration from the same initial centres (1e-5), the native backend
(bitwise: the same C++ library through each package's loader); and
``cli/run_clustering.main`` at size 32 on the CPU.

The features are well-separated prototypes plus small noise, so no pixel
sits near two centres and the ids must agree exactly.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from where2edit_tpu.editing import clustering as jc
from where2edit_tpu_torch.cli import run_clustering
from where2edit_tpu_torch.cli.common import load_cluster_centers
from where2edit_tpu_torch.editing import clustering as tc

from torch_parity import t

TOL = 1e-5
K = 6


def _taps(b=2, s=8, c=64, seed=0):
    rng = np.random.default_rng(seed)
    protos = (rng.standard_normal((K, c)) * 4.0).astype(np.float32)
    which = rng.integers(0, K, (b, s, s))
    feats = (protos[which] + 0.05 * rng.standard_normal((b, s, s, c))).astype(np.float32)
    centers = np.concatenate([protos, np.zeros((K, 2 * (c // 16)), np.float32)], 1)
    return feats, centers


@pytest.mark.parametrize("upsample2", [False, True])
def test_torch_cluster_features_match_jax(upsample2):
    feats, _ = _taps()
    want = np.asarray(jc.cluster_features(jnp.asarray(feats), upsample2=upsample2))
    got = tc.cluster_features(t(feats), upsample2=upsample2).numpy()
    assert got.shape == want.shape == ((2 * 8 * 8 * (4 if upsample2 else 1)), 64 + 8)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("offset", [False, True])
def test_torch_assign_clusters_match_jax(offset):
    feats, centers = _taps(seed=1)
    want = np.asarray(jc.assign_clusters(jnp.asarray(feats), jnp.asarray(centers),
                                         offset_per_sample=offset))
    got = tc.assign_clusters(t(feats), t(centers), offset_per_sample=offset).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) == (2 * K if offset else K)


def _blobs(n=3000, d=24, seed=2):
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((K, d)).astype(np.float32) * 5.0
    rows = protos[rng.integers(0, K, n)] + rng.standard_normal((n, d)).astype(np.float32)
    return rows.astype(np.float32)


def test_torch_lloyd_matches_jax():
    data = _blobs()
    init = data[[0, 10, 20, 30, 40, 50]]
    want = np.asarray(jc._lloyd(jnp.asarray(data), jnp.asarray(init), K, 20))
    got = tc._lloyd(t(data), t(init), K, 20).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_torch_lloyd_keeps_an_empty_cluster_and_fits_from_a_seed():
    data = _blobs(n=500)
    init = np.concatenate([data[:K - 1], np.full((1, data.shape[1]), 1e3, np.float32)])
    got = tc._lloyd(t(data), t(init), K, 5).numpy()
    np.testing.assert_array_equal(got[-1], init[-1])  # nothing joined it
    a = tc.kmeans_fit(data, K, backend="torch", num_iters=10, seed=3)
    b = tc.kmeans_fit(t(data), K, backend="torch", num_iters=10, seed=3)
    assert a.shape == (K, data.shape[1]) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def test_torch_native_backend_matches_jax_bitwise():
    from where2edit_tpu.utils.native import native_available  # noqa: PLC0415
    from where2edit_tpu_torch.utils import native  # noqa: PLC0415

    if not (native_available() and native.native_available()):
        pytest.skip("make could not build native/libw2e_native.so")
    data = _blobs(n=4000, d=32, seed=4)
    want = jc.kmeans_fit(data, K, backend="native", seed=9)
    got = tc.kmeans_fit(t(data), K, backend="native", seed=9)
    np.testing.assert_array_equal(got, want)
    ids = native.kmeans_assign_native(data, got)
    dist = ((data[:, None, :] - got[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(ids, dist.argmin(1))


def test_torch_run_clustering_cli_pickle(tmp_path):
    torch.set_num_threads(2)
    out = run_clustering.main(["--stylegan_size", "32", "--device", "cpu",
                               "--attention_layer", "7", "--batch_size", "2",
                               "--step", "1", "--results_dir", str(tmp_path),
                               "--ckpt", "/nonexistent"])
    assert os.path.basename(out) == "k_means_layer_7_10_clusters.pkl"
    centers = load_cluster_centers(out)
    assert centers.shape == (10, 512 + 2 * 32) and centers.dtype == np.float32
    assert np.isfinite(centers).all()
    assert (tmp_path / "final_cluster.jpg").exists()
    assert (tmp_path / "final_result.jpg").exists()
