"""The evaluation statistics of the port against the JAX package's, on the
CPU: ``_sqrtm_psd``, ``frechet_distance`` and ``inception_score_from_probs``
on the same float64 arrays (≤ 1e-9 relative: the same numpy code on the
same arrays), ``ssim`` on the same images (≤ 1e-5: fp32 filters summed in
another order), and the IoU helpers (``binarize_for_iou``,
``remap_celeba_labels``, ``jaccard``) exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from where2edit_tpu.editing.masks import binarize_for_iou as j_binarize
from where2edit_tpu.eval import iou as jiou
from where2edit_tpu.eval import metrics as jmetrics
from where2edit_tpu.eval.ssim import ssim as j_ssim
from where2edit_tpu_torch.editing.masks import binarize_for_iou
from where2edit_tpu_torch.eval import iou as tiou
from where2edit_tpu_torch.eval import metrics as tmetrics
from where2edit_tpu_torch.eval.ssim import ssim

STATS_TOL, SSIM_TOL = 1e-9, 1e-5


def _pools(n: int, d: int, seed: int):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, d))
    b = 0.7 * rng.standard_normal((n, d)) @ rng.standard_normal((d, d)) / d ** 0.5 + 0.3
    return a, b


def _probs(n: int, c: int, seed: int):
    logits = 3 * np.random.default_rng(seed).standard_normal((n, c))
    e = np.exp(logits - logits.max(1, keepdims=True))
    return e / e.sum(1, keepdims=True)


STATISTICS = {  # case → (function name, inputs)
    "sqrtm_psd": ("_sqrtm_psd", lambda: (np.cov(_pools(40, 16, 0)[0], rowvar=False),)),
    "sqrtm_rank_deficient": ("_sqrtm_psd", lambda: (np.cov(_pools(6, 16, 1)[0], rowvar=False),)),
    "fid_n_above_d": ("frechet_distance", lambda: _pools(64, 16, 2)),
    "fid_n_below_d": ("frechet_distance", lambda: _pools(8, 32, 3)),
    "fid_identical": ("frechet_distance", lambda: (_pools(32, 8, 4)[0],) * 2),
    "is_ten_splits": ("inception_score_from_probs", lambda: (_probs(53, 10, 5),)),
    "is_fewer_rows_than_splits": ("inception_score_from_probs", lambda: (_probs(4, 7, 6),)),
}


@pytest.mark.parametrize("case", sorted(STATISTICS))
def test_torch_eval_statistics_match_jax(case):
    name, make = STATISTICS[case]
    args = make()
    got = getattr(tmetrics, name)(*args)
    want = getattr(jmetrics, name)(*args)
    np.testing.assert_allclose(got, want, rtol=STATS_TOL, atol=STATS_TOL * np.abs(want).max())


@pytest.mark.parametrize("pair", ["random", "noisy_copy", "identical"])
def test_torch_ssim_matches_jax(pair):
    rng = np.random.default_rng(7)
    a = np.tanh(rng.standard_normal((2, 24, 20, 3))).astype(np.float32)
    b = {"random": np.tanh(rng.standard_normal(a.shape)),
         "noisy_copy": a + 0.1 * rng.standard_normal(a.shape),
         "identical": a}[pair].astype(np.float32)
    got = float(ssim(torch.from_numpy(a), torch.from_numpy(b)))
    want = float(j_ssim(jnp.asarray(a), jnp.asarray(b)))
    assert abs(got - want) <= SSIM_TOL, (got, want)
    if pair == "identical":
        assert abs(got - 1.0) <= SSIM_TOL


def _binarize():
    m = np.random.default_rng(8).uniform(0, 1, (2, 9, 9, 1)).astype(np.float32)
    m[0, 0, :4, 0] = [0.7, 0.79999, 0.8, 0.80001]
    got = binarize_for_iou(torch.from_numpy(m)).numpy()
    assert set(np.unique(got)) <= {0.0, 1.0}
    return got, np.asarray(j_binarize(jnp.asarray(m)))


def _remap():
    label = np.random.default_rng(9).integers(0, 19, (17, 13))
    return tiou.remap_celeba_labels(label), jiou.remap_celeba_labels(label)


def _jaccard():
    rng = np.random.default_rng(10)
    pred = (rng.uniform(0, 1, (300, 8)) > 0.6).astype(np.float32)
    true = (rng.uniform(0, 1, (300, 8)) > 0.7).astype(np.float32)
    true[:, 3] = 0.0
    pred[:, 3] = 0.0  # an empty union scores 0
    (tc, tm), (jc, jm) = tiou.jaccard(pred, true), jiou.jaccard(pred, true)
    assert tc[3] == 0.0
    return np.append(tc, tm), np.append(jc, jm)


@pytest.mark.parametrize("helper", ["binarize_for_iou", "remap_celeba_labels", "jaccard"])
def test_torch_iou_helpers_equal_jax(helper):
    got, want = {"binarize_for_iou": _binarize, "remap_celeba_labels": _remap,
                 "jaccard": _jaccard}[helper]()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
