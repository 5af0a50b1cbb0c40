"""Pre-smoothing filters on (H,W,C) float tensors.

Port of video_segment_tpu/ops/filters.py (same parity targets):
- Gaussian: cv::GaussianBlur(3x3, sigma=1.5), reflect-101 border;
- Bilateral: circular window of radius floor(1.5*sigma_space), replicate
  border, spatial weight exp(-0.5*r^2/ss^2), joint color weight
  exp(-0.5*||dc||^2/sc^2) shared by all channels (defaults 3.0 / 0.25).
Sums run in the JAX version's left-to-right order, and multiply-adds round
as XLA's CPU backend contracts them (fused multiply-adds, emulated in
float64); the bilateral filter's exp is XLA's own polynomial
(`ops/histograms.xla_exp`).  Both filters equal the JAX versions bit for
bit on the CPU.  On a CUDA tensor the bilateral filter is one launch of
K6 (`ops/bilateral.py`, `csrc/bilateral.cu`), bit for bit the eager body
(`bilateral_filter_plain`) on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from video_segment_tpu_torch.ops import bilateral as bilateral_ops
from video_segment_tpu_torch.ops.histograms import _fma, xla_exp


def _gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    w = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (w / w.sum()).astype(np.float32)


def _taps(k: list, tap) -> torch.Tensor:
    """sum_i k[i] * tap(i) in the JAX package's compiled rounding: XLA's
    CPU backend contracts the first two products' sum into
    fma(k0, t0, k1 * t1) and each later term into fma(k_i, t_i, sum)."""
    if len(k) == 1:
        return k[0] * tap(0)
    out = _fma(tap(0), k[0], k[1] * tap(1))
    for i in range(2, len(k)):
        out = _fma(tap(i), k[i], out)
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


_TAP_BLOCK = 7   # taps whose weights are computed in one batch of launches


def bilateral_filter(img: torch.Tensor, sigma_space: float = 3.0,
                     sigma_color: float = 0.25) -> torch.Tensor:
    """Bilateral filter of an (H,W,C) float image: on a CUDA tensor one
    launch of K6, which takes a contiguous (H,W,3) float32 image or raises
    (nothing falls back); on any other device `bilateral_filter_plain`."""
    if img.device.type == "cuda":
        return bilateral_ops.bilateral(
            img, _space_weights(sigma_space, img.device),
            int(sigma_space * 1.5), -0.5 / (sigma_color * sigma_color))
    return bilateral_filter_plain(img, sigma_space, sigma_color)


@functools.lru_cache(maxsize=None)
def _space_weights(sigma_space: float, device: torch.device) -> torch.Tensor:
    """The taps' spatial weights as `bilateral_filter_plain` computes them
    (in `_circular_offsets` order), on `device`, once per sigma_space."""
    radius = int(sigma_space * 1.5)
    space_coeff = -0.5 / (sigma_space * sigma_space)
    return torch.tensor(
        [np.exp(space_coeff * r2).astype(np.float32)
         for *_, r2 in _circular_offsets(radius)],
        dtype=torch.float32, device=device)


def bilateral_filter_plain(img: torch.Tensor, sigma_space: float = 3.0,
                           sigma_color: float = 0.25) -> torch.Tensor:
    """Bilateral filter of an (H,W,C) float image (full circular window),
    in the rounding of the JAX package's compiled filter: the squared
    colour distance as fma(d2, d2, fma(d0, d0, d1 * d1)) over the channel
    differences, the weight sum as plain adds in tap order, each channel's
    value sum as fma(w0, n0, w1 * n1) and then one fused multiply-add a
    tap.  The weights of `_TAP_BLOCK` taps are computed at once (the same
    arithmetic per element, a seventh of the launches); the two sums run
    tap by tap, because each step rounds."""
    radius = int(sigma_space * 1.5)
    offs = _circular_offsets(radius)
    h, w, _ = img.shape
    chw = img.permute(2, 0, 1)
    pad = F.pad(chw[None], (radius,) * 4, mode="replicate")[0]

    space_coeff = -0.5 / (sigma_space * sigma_space)
    color_coeff = -0.5 / (sigma_color * sigma_color)

    ws_all = torch.tensor(
        [np.exp(space_coeff * r2).astype(np.float32) for *_, r2 in offs],
        dtype=torch.float32, device=img.device)[:, None, None]
    wsum = vsum = first = None
    for b0 in range(0, len(offs), _TAP_BLOCK):
        block = offs[b0:b0 + _TAP_BLOCK]
        nbs = torch.stack([pad[:, dy + radius:dy + radius + h,
                               dx + radius:dx + radius + w]
                           for dy, dx, _ in block])          # (B,3,H,W)
        s = chw[None] - nbs
        d2 = _fma(s[:, 2], s[:, 2], _fma(s[:, 0], s[:, 0],
                                         s[:, 1] * s[:, 1]))
        wts = xla_exp(d2 * color_coeff) * ws_all[b0:b0 + _TAP_BLOCK]
        for wt, nb in zip(wts, nbs):
            if wsum is None:
                wsum, first = wt, (wt, nb)
            elif vsum is None:
                wsum = wsum + wt
                vsum = _fma(first[0], first[1], wt * nb)
            else:
                wsum = wsum + wt
                vsum = _fma(wt, nb, vsum)
    den = torch.clamp(wsum, min=1e-20)
    return (vsum / den).permute(1, 2, 0).contiguous()


def presmooth(img: torch.Tensor, mode: str = "bilateral") -> torch.Tensor:
    """Reference presmoothing dispatch (dense_segmentation.cpp:183-198)."""
    if mode == "none":
        return img
    if mode == "gaussian":
        return gaussian_blur(img, 3, 1.5)
    if mode == "bilateral":
        return bilateral_filter(img, 3.0, 0.25)
    raise ValueError(f"unknown presmoothing mode: {mode}")
