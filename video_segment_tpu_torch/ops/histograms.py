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
    slower (the main path timed both ways on one H100), so a CUDA tensor
    takes one torch.sum (its float order differs from the CPU's in the
    last ulp, like the solver's float atomics)."""
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
    edge batches to bound the gathered (batch, bins) windows.  On the CPU
    the native helper computes the same floats in one pass
    (`native.chi_square_edges`; these torch ops where it is unavailable)."""
    if hist.device.type == "cpu":
        from video_segment_tpu_torch import native
        d = native.chi_square_edges(hist.detach().numpy(), edges.numpy(),
                                    torch.get_num_threads())
        if d is not None:
            return torch.from_numpy(d)
    return edge_color_distance_plain(hist, edges, batch)


def edge_color_distance_plain(hist: torch.Tensor, edges: torch.Tensor,
                              batch: int = 8192) -> torch.Tensor:
    """`edge_color_distance` in torch ops on any device."""
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


def edge_color_distance_windowed(whist: torch.Tensor, wcnt: torch.Tensor,
                                 edges: torch.Tensor,
                                 batch: int = 4096) -> torch.Tensor:
    """WindowedAppearanceDescriptor distance for (E,2) region pairs over
    (NW, R, B) per-window gain-calibrated color histograms and (NW, R)
    sample counts: each lhs window w takes the minimum chi-square over the
    rhs windows w-1..w+1 where both sides have samples, weighted by the
    smaller count; the weighted mean over windows
    (region_descriptor.cpp:207-276).  A window with no finite minimum
    contributes nothing.  Edge batches of `batch`, as the JAX package's
    `lax.map`."""
    nw = whist.shape[0]
    out = []
    for s in range(0, edges.shape[0], batch):
        chunk = edges[s:s + batch]
        ha = normalize_l1(whist.index_select(1, chunk[:, 0]))  # (NW, b, B)
        hb = normalize_l1(whist.index_select(1, chunk[:, 1]))
        wa = wcnt.index_select(1, chunk[:, 0])                  # (NW, b)
        wb = wcnt.index_select(1, chunk[:, 1])
        dist_sum = torch.zeros(chunk.shape[0], dtype=whist.dtype,
                               device=whist.device)
        weight_sum = torch.zeros_like(dist_sum)
        for w in range(nw):
            best_d = torch.full_like(dist_sum, torch.inf)
            best_w = torch.zeros_like(dist_sum)
            for m in range(max(w - 1, 0), min(w + 2, nw)):
                ok = (wa[w] > 0) & (wb[m] > 0)
                d = chi_square(ha[w], hb[m])
                take = ok & (d < best_d)
                best_d = torch.where(take, d, best_d)
                best_w = torch.where(take, torch.minimum(wa[w], wb[m]),
                                     best_w)
            valid = torch.isfinite(best_d)
            dist_sum = dist_sum + torch.where(valid, best_d * best_w, 0.0)
            weight_sum = weight_sum + torch.where(valid, best_w, 0.0)
        out.append(torch.where(weight_sum > 0, dist_sum
                               / torch.clamp(weight_sum, min=1e-12), 0.0))
    if not out:
        return torch.zeros(0, dtype=whist.dtype, device=whist.device)
    return torch.cat(out)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once, as a fused multiply-add (the float32
    product is exact in float64; the float64 sum is rounded to float32)."""
    a = a.double()
    b = b.double() if torch.is_tensor(b) else b
    c = c.double() if torch.is_tensor(c) else c
    return (a * b + c).float()


def _f32(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float32))


# XLA's CPU `log_f32` (a Cephes-style polynomial in its LLVM IR), constants
# as the compiled code holds them.
_hex = float.fromhex
_LOG_SQRTHF = _hex("0x1.6a09e6p-1")
_LOG_P = tuple(tuple(map(_hex, p)) for p in (
    ("0x1.204376p-4", "-0x1.d7a370p-4", "0x1.de4a34p-4"),
    ("-0x1.fcba9ep-4", "0x1.23d37ep-3", "-0x1.555ca0p-3"),
    ("0x1.999d58p-3", "-0x1.fffff8p-3", "0x1.555554p-2")))
_LOG_Q1 = _hex("-0x1.bd0106p-13")   # low part of ln 2
_LOG_Q2 = _hex("0x1.63p-1")         # high part of ln 2 (0.693359375)
_INV_LN2 = _hex("0x1.715476p+0")    # float32(1 / ln 2): log2 = log * this
_FLT_MIN = _hex("0x1p-126")


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log, bit for bit as the JAX package's compiled (XLA
    CPU) code computes it: the exponent and a mantissa in [sqrt(1/2),
    sqrt(2)) from the float32 bit pattern, a degree-8 polynomial in three
    Horner chains, each step a fused multiply-add where the object code of
    `jit(combined_distance)` holds one (emulated by `_fma`)."""
    x = x.float()
    xc = torch.clamp(x, min=_FLT_MIN)
    bits = xc.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & 0x807FFFFF) | 0x3F000000).view(torch.float32)
    small = m < _LOG_SQRTHF
    xr = (m - 1.0) + torch.where(small, m, 0.0)
    e = e - small.float()
    z = xr * xr
    z3 = z * xr
    y1, y2, y3 = (_fma(_fma(xr, p0, p1), xr, p2) for p0, p1, p2 in _LOG_P)
    y = _fma(_fma(y1, z3, y2), z3, y3)
    y = _fma(y, z3, e * _LOG_Q1)
    r = _fma(e, _LOG_Q2, _fma(z, -0.5, xr) + y)
    r = torch.where(x == 0, -torch.inf, r)
    r = torch.where(x == torch.inf, torch.inf, r)
    return torch.where((x < 0) | torch.isnan(x), torch.nan, r)


def xla_log2(x: torch.Tensor) -> torch.Tensor:
    """`jax.jit(jnp.log2)` on the CPU bit for bit: `xla_log` times
    float32(1 / ln 2), rounded."""
    return xla_log(x) * _INV_LN2


# XLA's CPU `exp_f32` (Cephes-style: range reduction by a two-part ln 2, a
# degree-5 polynomial), constants as the compiled code holds them.
_EXP_LO = _hex("-0x1.5f3334p+6")      # -87.8: inputs clamp to [LO, HI]
_EXP_HI = _hex("0x1.633334p+6")       # 88.8
_EXP_LOG2E = _hex("0x1.715476p+0")
_EXP_C1 = _hex("0x1.63p-1")           # high part of ln 2 (0.693359375)
_EXP_C2 = _hex("-0x1.bd0106p-13")     # low part of ln 2
_EXP_P = tuple(map(_hex, ("0x1.a0d2cep-13", "0x1.6e879cp-10",
                          "0x1.11121p-7", "0x1.555382p-5",
                          "0x1.555554p-3", "0x1p-1")))


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """float32 exp, bit for bit as the JAX package's compiled (XLA CPU)
    code computes it: n = floor(x * log2(e) + 1/2) clamped to [-127, 127],
    r = x - n * ln 2 in two parts, a degree-5 Horner polynomial in r, then
    1 + r + r^2 * p(r) scaled by 2^n through the exponent bits.  Every
    multiply-add the object code of `jit(exp)` holds as a fused one is
    emulated by `_fma`; results below the smallest normal flush to zero as
    the compiled code runs (flush-to-zero mode)."""
    x = torch.clamp(x.float(), _EXP_LO, _EXP_HI)
    n = torch.clamp(torch.floor(_fma(x, _EXP_LOG2E, 0.5)), -127.0, 127.0)
    r = _fma(n, -_EXP_C1, x)
    r = _fma(n, -_EXP_C2, r)
    y = torch.full_like(r, _EXP_P[0])
    for p in _EXP_P[1:]:
        y = _fma(y, r, p)
    y = _fma(y, r * r, r) + 1.0
    out = y * ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return torch.where(out < _FLT_MIN, torch.zeros_like(out), out)


def combined_distance(color_d, flow_d, size_a, size_b, inv_median_size,
                      penalizer: float = 0.25, use_flow: bool = True):
    """SquaredORDistanceSizePenalized over [appearance, flow] + penalizer,
    in the float order of the JAX package's compiled agglomeration, so that
    the quantized distances match it bit for bit: 1 - (1-c)(1-f) as one
    fused multiply-add, XLA's log polynomial (`xla_log`), penalizer / ln 2
    folded into one float32 factor k = penalizer * float32(1 / ln 2), and
    1 + k ln x as one fused multiply-add.  The same on every device: on the
    card its extra elementwise launches did not lengthen the main path's
    region stage (timed against `torch.log2`; CHANGES.md keeps the run)."""
    prod = 1.0 - color_d
    if use_flow:
        q = _fma(-prod, 1.0 - flow_d, 1.0)
    else:
        q = 1.0 - prod
    min_sz = torch.minimum(size_a, size_b)
    ln = xla_log(torch.clamp(min_sz * inv_median_size, min=1e-20))
    k = _f32(_f32(penalizer) * _INV_LN2)
    scale = torch.clamp(_fma(ln, k, 1.0), max=1.0)
    return torch.clamp(q * q * scale, 0.0, 1.0)
