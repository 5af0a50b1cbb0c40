"""Pre-smoothing filters on (H,W,C) float tensors.

Port of video_segment_tpu/ops/filters.py (same parity targets):
- Gaussian: cv::GaussianBlur(3x3, sigma=1.5), reflect-101 border;
- Bilateral: circular window of radius floor(1.5*sigma_space), replicate
  border, spatial weight exp(-0.5*r^2/ss^2), joint color weight
  exp(-0.5*||dc||^2/sc^2) shared by all channels (defaults 3.0 / 0.25).
Sums run in the JAX version's left-to-right order.  The Gaussian's
multiply-adds round as XLA's CPU backend contracts them (fused
multiply-adds), so it equals the JAX version bit for bit; the bilateral
filter's exp is torch's, not XLA's own polynomial, and stays within a few
float32 ulps of it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    w = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (w / w.sum()).astype(np.float32)


def _fma(a: float, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * x + c rounded once to float32, as a fused multiply-add: the
    float32 product is exact in float64, and the float64 sum is rounded
    once to float32."""
    return (a * x.double() + c.double()).float()


def _taps(k: list, tap) -> torch.Tensor:
    """sum_i k[i] * tap(i) in the JAX package's compiled rounding: XLA's
    CPU backend contracts the first two products' sum into
    fma(k0, t0, k1 * t1) and each later term into fma(k_i, t_i, sum)."""
    if len(k) == 1:
        return k[0] * tap(0)
    out = _fma(k[0], tap(0), k[1] * tap(1))
    for i in range(2, len(k)):
        out = _fma(k[i], tap(i), out)
    return out


def gaussian_blur(img: torch.Tensor, ksize: int = 3,
                  sigma: float = 1.5) -> torch.Tensor:
    """Separable Gaussian blur of an (H,W,C) float image, reflect-101."""
    k = [float(v) for v in _gaussian_kernel_1d(ksize, sigma)]
    r = ksize // 2
    h, w = img.shape[0], img.shape[1]
    chw = img.permute(2, 0, 1)[None]
    pad = F.pad(chw, (0, 0, r, r), mode="reflect")
    out = _taps(k, lambda i: pad[:, :, i:i + h])
    pad = F.pad(out, (r, r, 0, 0), mode="reflect")
    out = _taps(k, lambda i: pad[:, :, :, i:i + w])
    return out[0].permute(1, 2, 0).contiguous()


def _circular_offsets(radius: int) -> list[tuple[int, int, float]]:
    offs = []
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            r2 = dy * dy + dx * dx
            if r2 <= radius * radius:
                offs.append((dy, dx, float(r2)))
    return offs


def bilateral_filter(img: torch.Tensor, sigma_space: float = 3.0,
                     sigma_color: float = 0.25) -> torch.Tensor:
    """Bilateral filter of an (H,W,C) float image (full circular window)."""
    radius = int(sigma_space * 1.5)
    offs = _circular_offsets(radius)
    h, w, _ = img.shape
    ch = [img[:, :, c] for c in range(3)]
    pads = [F.pad(c[None, None], (radius,) * 4, mode="replicate")[0, 0]
            for c in ch]

    space_coeff = -0.5 / (sigma_space * sigma_space)
    color_coeff = -0.5 / (sigma_color * sigma_color)

    wsum = torch.zeros((h, w), dtype=img.dtype, device=img.device)
    vsum = [torch.zeros_like(wsum) for _ in range(3)]
    for dy, dx, r2 in offs:
        y0, x0 = dy + radius, dx + radius
        nb = [p[y0:y0 + h, x0:x0 + w] for p in pads]
        d2 = sum((c - n) * (c - n) for c, n in zip(ch, nb))
        ws = float(np.exp(space_coeff * r2).astype(np.float32))
        wt = ws * torch.exp(color_coeff * d2)
        wsum = wsum + wt
        vsum = [v + wt * n for v, n in zip(vsum, nb)]
    den = torch.clamp(wsum, min=1e-20)
    return torch.stack([v / den for v in vsum], dim=-1)


def presmooth(img: torch.Tensor, mode: str = "bilateral") -> torch.Tensor:
    """Reference presmoothing dispatch (dense_segmentation.cpp:183-198)."""
    if mode == "none":
        return img
    if mode == "gaussian":
        return gaussian_blur(img, 3, 1.5)
    if mode == "bilateral":
        return bilateral_filter(img, 3.0, 0.25)
    raise ValueError(f"unknown presmoothing mode: {mode}")
