"""Pixel and descriptor distances and their aggregators, on torch tensors.

Port of video_segment_tpu/ops/pixel_distance.py (the reference's
pixel_distance policy classes; citations there): the mean-normalized L1/L2
colour difference, the 2-channel gradient difference (its L2 form scaled by
10 and clamped to 1), the sign-normalized gradient-mean descriptor with its
thresholds 0.1 / 0.15, and the three distance aggregators.

The solver bucketizes these distances into 2048 levels, so a one-ulp
difference can move an edge into another bucket.  Every function equals
`jax.jit` of the JAX one bit for bit on the CPU: where the JAX package's
compiled (XLA CPU) code fuses a multiply into an add, the port rounds once
as well (`histograms._fma`), and square roots are correctly rounded
(`tile_felz.sqrt32`).
"""

from __future__ import annotations

import torch

from video_segment_tpu_torch.ops.histograms import _f32, _fma
from video_segment_tpu_torch.ops.tile_felz import sqrt32

# BT.601 luminance weights for BGR input (conversion_units.cpp), as the
# float32 constants the compiled code multiplies by.
_LUM_B, _LUM_G, _LUM_R = _f32(0.114), _f32(0.587), _f32(0.299)

GRADIENT_MERGE_THRESHOLD = 0.1   # pixel_distance.h:525
GRADIENT_SPLIT_THRESHOLD = 0.15  # pixel_distance.h:526


def _sum_sq(d: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last dim (2 or 3 terms), added left to
    right as XLA's reduction does."""
    out = d[..., 0] * d[..., 0]
    for k in range(1, d.shape[-1]):
        out = out + d[..., k] * d[..., k]
    return out


def color_distance(a, b, metric: str = "l2"):
    """ColorDiff3L1/L2 over (..., 3) features."""
    d = a - b
    if metric == "l1":
        return (d[..., 0].abs() + d[..., 1].abs() + d[..., 2].abs()) \
            * (1.0 / 3.0)
    return sqrt32(_sum_sq(d) * (1.0 / 3.0))


def _scaled_l2(d):
    """min(1, 10 * sqrt(sum(d*d) * 0.5)) over (..., 2)."""
    return torch.clamp(10.0 * sqrt32(_sum_sq(d) * 0.5), max=1.0)


def gradient_distance(a, b, metric: str = "l2"):
    """GradientDiffL1/L2 over (..., 2) gradient features."""
    d = a - b
    if metric == "l1":
        return (d[..., 0].abs() + d[..., 1].abs()) * 0.5
    return _scaled_l2(d)


def aggregate(d1, d2, aggregator: str, weight1: float = 0.5):
    """Combine two distances (pixel_distance.h:712-744)."""
    if aggregator == "linear":
        return _fma(d1, _f32(weight1), _f32(1.0 - weight1) * d2)
    if aggregator == "independent":
        return _fma(-(1.0 - d1), 1.0 - d2, 1.0)
    if aggregator == "sqrt":
        return sqrt32(_fma(d1, d1, d2 * d2)) * 0.70711
    raise ValueError(f"unknown aggregator {aggregator!r}")


def aggregate_scalar(d1: float, d2: float, aggregator: str,
                     weight1: float = 0.5) -> float:
    """Python-scalar aggregate (static threshold combination,
    AggregatedDescriptorTraits::MergeDistanceThreshold)."""
    if aggregator == "linear":
        return weight1 * d1 + (1.0 - weight1) * d2
    if aggregator == "independent":
        return 1.0 - (1.0 - d1) * (1.0 - d2)
    if aggregator == "sqrt":
        return float((d1 * d1 + d2 * d2) ** 0.5 * 0.70711)
    raise ValueError(f"unknown aggregator {aggregator!r}")


def gradient_features(vol):
    """(T,H,W,3) BGR [0,1] -> (T,H,W,2) central-difference luminance
    gradient (dL/dx, dL/dy) with zero borders."""
    lum = _fma(vol[..., 2], _LUM_R,
               _fma(vol[..., 0], _LUM_B, vol[..., 1] * _LUM_G))
    gx = torch.zeros_like(lum)
    gx[..., 1:-1] = 0.5 * (lum[..., 2:] - lum[..., :-2])
    gy = torch.zeros_like(lum)
    gy[..., 1:-1, :] = 0.5 * (lum[..., 2:, :] - lum[..., :-2, :])
    return torch.stack([gx, gy], dim=-1)


def sign_normalize(grad):
    """Flip both components so the first is non-negative
    (GradientMeanDescriptorTraits::InitializeDescriptor)."""
    return grad * torch.where(grad[..., :1] < 0, -1.0, 1.0)


def gradient_trait_distance(mean_a, mean_b):
    """GradientMeanDescriptorTraits::DescriptorDistance on (..., 2)
    sign-normalized gradient means."""
    return _scaled_l2(mean_a - mean_b)
