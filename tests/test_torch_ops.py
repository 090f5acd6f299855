"""The port's plain ops against the JAX package's (same numpy inputs).

Tolerance 1e-5 absolute and relative: fp32 on both sides, short sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from where2edit_tpu.ops import fused_leaky_relu as j_lrelu
from where2edit_tpu.ops import gaussian_blur as j_blur
from where2edit_tpu.ops import interpolate_nearest as j_nearest
from where2edit_tpu.ops import upfirdn2d as j_upfirdn2d
from where2edit_tpu.ops.interpolate import adaptive_avg_pool as j_adaptive
from where2edit_tpu.ops.interpolate import avg_pool as j_avg_pool
from where2edit_tpu.ops.interpolate import interpolate_bilinear as j_bilinear
from where2edit_tpu.ops.interpolate import upsample_repeat as j_repeat
from where2edit_tpu.ops.segment import cluster_coverage_penalty as j_penalty
from where2edit_tpu.ops.segment import segment_mean_map as j_segment
from where2edit_tpu_torch.ops import (
    adaptive_avg_pool,
    avg_pool,
    cluster_coverage_penalty,
    fused_leaky_relu,
    gaussian_blur,
    interpolate_bilinear,
    interpolate_nearest,
    segment_mean_map,
    upfirdn2d,
    upsample_repeat,
)

from torch_parity import close, t

TOL = 1e-5
RNG = np.random.default_rng(0)


def rand(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize(
    "up,down,pad,ksize,channels",
    [
        (1, 1, (1, 1), 4, 3),    # plain blur
        (2, 1, (2, 1), 4, 3),    # ToRGB skip upsample
        (1, 2, (1, 1), 4, 3),    # downsample
        (2, 1, (1, 1), 3, 3),    # odd kernel
        (1, 1, (2, 2), 4, 3),
        (1, 2, (2, 1), 4, 3),
        (1, 1, (-1, 2), 4, 3),   # negative pad crops
        (2, 1, (2, 1), 4, 16),   # wide input (JAX's separable path)
        (1, 1, (1, 1), 4, 16),   # the up-conv's Blur(pad=(1,1))
    ],
)
def test_torch_upfirdn2d(up, down, pad, ksize, channels):
    x = rand(2, 13, 13, channels)
    k1 = np.array([1, 3, 3, 1], np.float32)[:ksize]
    k = np.outer(k1, k1) / np.outer(k1, k1).sum()
    want = j_upfirdn2d(jnp.asarray(x), k, up=up, down=down, pad=pad)
    got = upfirdn2d(t(x), k, up=up, down=down, pad=pad)
    assert got.shape == want.shape
    close(got, want, TOL)


def test_torch_upfirdn2d_nonseparable_kernel():
    x = rand(1, 9, 9, 2)
    k = rand(3, 3)
    close(upfirdn2d(t(x), k, up=2, pad=(1, 1)),
          j_upfirdn2d(jnp.asarray(x), k, up=2, pad=(1, 1)), TOL)


def test_torch_fused_leaky_relu():
    x, b = rand(2, 5, 5, 8), rand(8)
    close(fused_leaky_relu(t(x), t(b)), j_lrelu(jnp.asarray(x), jnp.asarray(b)), TOL)
    close(fused_leaky_relu(t(x)), j_lrelu(jnp.asarray(x)), TOL)


@pytest.mark.parametrize("src,dst", [(16, 8), (4, 16), (12, 7), (5, 12), (7, 7)])
def test_torch_interpolate_nearest(src, dst):
    x = rand(2, src, src, 3)
    close(interpolate_nearest(t(x), dst), j_nearest(jnp.asarray(x), dst), 0.0)


def test_torch_gaussian_blur():
    x = rand(2, 16, 16, 1)
    close(gaussian_blur(t(x), 5), j_blur(jnp.asarray(x), 5), TOL)


def test_torch_segment_mean_map_with_empty_cluster():
    b, k = 2, 5
    vals = RNG.random((b, 8, 8)).astype(np.float32)
    ids = RNG.integers(0, k - 1, (b, 8, 8))  # cluster k-1 stays empty
    ids = (ids + np.arange(b)[:, None, None] * k).astype(np.int32)
    pooled, means, counts = segment_mean_map(t(vals), t(ids).long(), b * k)
    jp, jm, jc = j_segment(jnp.asarray(vals), jnp.asarray(ids), b * k)
    close(pooled, jp, TOL)
    close(means, jm, TOL)
    close(counts, jc, 0.0)
    assert float(means[k - 1]) == 0.0 and float(counts[k - 1]) == 0.0
    close(cluster_coverage_penalty(means, counts, b, 0.4),
          j_penalty(jm, jc, b, 0.4), TOL)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("src,dst", [
    ((8, 8), (16, 16)),     # up, integer ratio (the FPN merge's 16² -> 32²)
    ((16, 16), (8, 8)),     # down
    ((7, 9), (10, 13)),     # up, non-integer ratios, H != W
    ((10, 13), (7, 9)),     # down, non-integer ratios
    ((5, 6), (1, 1)),       # to size 1
    ((1, 1), (4, 3)),       # from size 1
])
def test_torch_interpolate_bilinear(src, dst, align_corners):
    x = rand(2, *src, 3)
    got = interpolate_bilinear(t(x), dst, align_corners=align_corners)
    want = j_bilinear(jnp.asarray(x), dst, align_corners=align_corners)
    assert got.shape == want.shape
    close(got, want, TOL)


@pytest.mark.parametrize("src,dst", [
    ((1024, 1024), (256, 256)),  # the pSp face pool
    ((64, 64), (16, 16)),        # equal bins
    ((24, 24), (10, 10)),        # general bins, overlapping
    ((32, 32), (256, 256)),      # output larger than input
    ((24, 32), (10, 7)),         # H != W
])
def test_torch_adaptive_avg_pool(src, dst):
    x = rand(1, *src, 3)
    got = adaptive_avg_pool(t(x), dst)
    want = j_adaptive(jnp.asarray(x), dst)
    assert got.shape == want.shape
    close(got, want, TOL)


@pytest.mark.parametrize("kernel,stride", [(2, None), (3, 2), (32, None)])
def test_torch_avg_pool(kernel, stride):
    x = rand(2, 64, 64, 3)
    close(avg_pool(t(x), kernel, stride), j_avg_pool(jnp.asarray(x), kernel, stride), TOL)


def test_torch_upsample_repeat():
    x = rand(2, 5, 5, 3)
    close(upsample_repeat(t(x), 7), j_repeat(jnp.asarray(x), 7), 0.0)
