"""Region descriptor histograms and distances on torch tensors.

Port of video_segment_tpu/ops/histograms.py (formulas and reference
citations there): Lab and flow-angle bin indices, scatter-added (R, B)
histogram tables, chi-square over L1-normalized histograms, the per-frame
weighted flow distance, and the size-penalized SquaredOR combined
distance.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def lab_bins(lab_u8: torch.Tensor, lum_bins: int = 10,
             color_bins: int = 20) -> torch.Tensor:
    """(...,3) Lab in uint8 ranges -> flat bin index (histograms.h:211-213)."""
    lab = lab_u8.to(torch.int32)
    l = (lab[..., 0] * lum_bins) >> 8
    a = (lab[..., 1] * color_bins) >> 8
    b = (lab[..., 2] * color_bins) >> 8
    return (l * color_bins + a) * color_bins + b


def flow_bins(flow: torch.Tensor, angle_bins: int = 16):
    """(...,2) flow -> (bin index, magnitude) (histograms.cpp:471-479)."""
    ang = (torch.atan2(flow[..., 1], flow[..., 0])
           / (2.0 * math.pi + 1e-4) + 0.5)
    b = torch.clamp((ang * angle_bins).to(torch.int32), 0, angle_bins - 1)
    return b, torch.hypot(flow[..., 0], flow[..., 1])


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


_WINDOW = 32


def _sum_in_order(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim, left to right from 0."""
    cols = x.movedim(-1, 0).contiguous()
    acc = torch.zeros_like(cols[0])
    for col in cols:
        acc = acc + col
    return acc


def xla_order_sum(x: torch.Tensor) -> torch.Tensor:
    """Float sum over the last dim in the order of the JAX package's
    compiled (XLA CPU) reductions, so that the two agree bit for bit: a
    reduction longer than 32 is cut into windows of 32 (zero-padded, half
    the padding in front, rounded down), each summed left to right, and the
    window sums are reduced the same way; 32 or fewer are summed left to
    right."""
    while x.shape[-1] > _WINDOW:
        n = x.shape[-1]
        nw = -(-n // _WINDOW)
        pad = nw * _WINDOW - n
        if pad:
            x = F.pad(x, (pad // 2, pad - pad // 2))
        x = _sum_in_order(x.reshape(*x.shape[:-1], nw, _WINDOW))
    return _sum_in_order(x)


def ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim: `xla_order_sum` on the CPU.  That order costs
    about 70 launches a sum, which on the card made the region stage 1.7x
    slower (scripts/ordered_sum_cost.py), so a CUDA tensor takes one
    torch.sum (its float order differs from the CPU's in the last ulp, like
    the solver's float atomics)."""
    if x.device.type != "cpu":
        return torch.sum(x, dim=-1)
    return xla_order_sum(x)


def ordered_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum(x * w) over the last dim in the JAX package's compiled order:
    up to 32 terms, XLA's CPU backend fuses each product into the running
    sum as a fused multiply-add (emulated here: the float32 product is
    exact in float64, and the float64 sum is rounded once to float32);
    longer, the products are rounded first and `xla_order_sum` adds them.
    On the CPU only, as `ordered_sum`."""
    if x.device.type != "cpu":
        return torch.sum(x * w, dim=-1)
    if x.shape[-1] > _WINDOW:
        return xla_order_sum(x * w)
    xs = x.movedim(-1, 0).double()
    ws = w.movedim(-1, 0).double()
    acc = torch.zeros_like(xs[0], dtype=x.dtype)
    for xi, wi in zip(xs, ws):
        acc = (acc.double() + xi * wi).to(x.dtype)
    return acc


def chi_square(a: torch.Tensor, b: torch.Tensor):
    """0.5 * sum (a-b)^2 / (a+b) over the last dim, zero-safe
    (histograms.cpp:396-407)."""
    add = a + b
    sub = a - b
    nz = add.abs() > 1e-12
    return 0.5 * ordered_sum(torch.where(nz, sub * sub, 0.0)
                             / torch.where(nz, add, 1.0))


def normalize_l1(h: torch.Tensor) -> torch.Tensor:
    """L1-normalize over the last dim."""
    s = ordered_sum(h)[..., None]
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


def edge_flow_distance(flow_hist: torch.Tensor, flow_cnt: torch.Tensor,
                       edges: torch.Tensor, batch: int = 8192) -> torch.Tensor:
    """Weighted per-frame chi^2 flow distance for (E,2) pairs over (T,R,B)
    magnitude-weighted angle histograms and (T,R) vector counts: frames
    weigh min(count_a, count_b), frames where either side is absent
    contribute nothing (region_descriptor.cpp:465-498).  Windows are
    gathered along the region axis, (T, batch, B)."""
    out = []
    for s in range(0, edges.shape[0], batch):
        chunk = edges[s:s + batch]
        ha = normalize_l1(flow_hist.index_select(1, chunk[:, 0]))
        hb = normalize_l1(flow_hist.index_select(1, chunk[:, 1]))
        d = chi_square(ha, hb)                                # (T, b)
        wa = flow_cnt.index_select(1, chunk[:, 0])
        wb = flow_cnt.index_select(1, chunk[:, 1])
        w = torch.minimum(wa, wb) * (wa > 0) * (wb > 0)
        ws = ordered_sum(w.T)
        out.append(torch.where(ws > 0, ordered_dot(d.T, w.T)
                               / torch.clamp(ws, min=1.0), 0.0))
    if not out:
        return torch.zeros(0, dtype=flow_hist.dtype, device=flow_hist.device)
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
