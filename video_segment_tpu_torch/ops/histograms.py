"""Region descriptor histograms and distances on torch tensors.

Port of video_segment_tpu/ops/histograms.py (formulas and reference
citations there): Lab bin indices, scatter-added (R, B) histogram tables,
chi-square over L1-normalized histograms, and the size-penalized
SquaredOR combined distance.  Flow histogram distances are not ported
(flow is off in this slice: with no flow frames agglomeration never asks
for them).
"""

from __future__ import annotations

import torch


def lab_bins(lab_u8: torch.Tensor, lum_bins: int = 10,
             color_bins: int = 20) -> torch.Tensor:
    """(...,3) Lab in uint8 ranges -> flat bin index (histograms.h:211-213)."""
    lab = lab_u8.to(torch.int32)
    l = (lab[..., 0] * lum_bins) >> 8
    a = (lab[..., 1] * color_bins) >> 8
    b = (lab[..., 2] * color_bins) >> 8
    return (l * color_bins + a) * color_bins + b


def accumulate_histogram(hist: torch.Tensor, labels: torch.Tensor,
                         bins: torch.Tensor, weights: torch.Tensor | None,
                         num_regions: int, num_bins: int) -> torch.Tensor:
    """Scatter-add (label, bin[, weight]) samples into a (R, B) table (in
    place on `hist`, which is returned)."""
    key = (labels.reshape(-1).long() * num_bins + bins.reshape(-1).long())
    w = (torch.ones(key.shape, dtype=hist.dtype, device=hist.device)
         if weights is None else weights.reshape(-1).to(hist.dtype))
    hist.view(-1).index_add_(0, key, w)
    return hist.view(num_regions, num_bins)


def chi_square(a: torch.Tensor, b: torch.Tensor, dim: int = -1):
    """0.5 * sum (a-b)^2 / (a+b), zero-safe (histograms.cpp:396-407)."""
    add = a + b
    sub = a - b
    nz = add.abs() > 1e-12
    return 0.5 * torch.sum(torch.where(nz, sub * sub, 0.0)
                           / torch.where(nz, add, 1.0), dim=dim)


def normalize_l1(h: torch.Tensor, dim: int = -1) -> torch.Tensor:
    s = torch.sum(h, dim=dim, keepdim=True)
    return h / torch.clamp(s, min=1e-20)


def edge_color_distance(hist: torch.Tensor, edges: torch.Tensor,
                        batch: int = 8192) -> torch.Tensor:
    """chi^2 over normalized color hists for (E,2) region index pairs, in
    edge batches to bound the gathered (batch, bins) windows."""
    out = []
    for s in range(0, edges.shape[0], batch):
        chunk = edges[s:s + batch]
        ha = normalize_l1(hist.index_select(0, chunk[:, 0]))
        hb = normalize_l1(hist.index_select(0, chunk[:, 1]))
        out.append(chi_square(ha, hb))
    if not out:
        return torch.zeros(0, dtype=hist.dtype, device=hist.device)
    return torch.cat(out)


def combined_distance(color_d, flow_d, size_a, size_b, inv_median_size,
                      penalizer: float = 0.25, use_flow: bool = True):
    """SquaredORDistanceSizePenalized over [appearance, flow] + penalizer."""
    prod = 1.0 - color_d
    if use_flow:
        prod = prod * (1.0 - flow_d)
    base = (1.0 - prod) * (1.0 - prod)
    min_sz = torch.minimum(size_a, size_b)
    scale = torch.clamp(1.0 + penalizer * torch.log2(
        torch.clamp(min_sz * inv_median_size, min=1e-20)), max=1.0)
    return torch.clamp(base * scale, 0.0, 1.0)
