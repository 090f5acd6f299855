"""Plain PyTorch primitives (counterparts of where2edit_tpu/ops), NHWC."""

from where2edit_tpu_torch.ops.fused_act import fused_leaky_relu
from where2edit_tpu_torch.ops.gaussian_blur import gaussian_blur
from where2edit_tpu_torch.ops.interpolate import (
    adaptive_avg_pool,
    avg_pool,
    interpolate_bilinear,
    interpolate_nearest,
    upsample_repeat,
)
from where2edit_tpu_torch.ops.segment import (
    cluster_coverage_penalty,
    segment_mean_map,
)
from where2edit_tpu_torch.ops.upfirdn2d import make_kernel, upfirdn2d

__all__ = [
    "adaptive_avg_pool",
    "avg_pool",
    "cluster_coverage_penalty",
    "fused_leaky_relu",
    "gaussian_blur",
    "interpolate_bilinear",
    "interpolate_nearest",
    "make_kernel",
    "segment_mean_map",
    "upfirdn2d",
    "upsample_repeat",
]
