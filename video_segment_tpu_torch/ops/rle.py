"""Host-side vectorized label-volume post-processing.

Converts the solver's dense label images into the RLE scanline form of the
output protobuf (reference: per-region Rasterization3D assembly in
dense_segmentation_graph.h:432-579), plus region adjacency and life-span
extraction for hierarchy seeding.  All NumPy-vectorized — no per-region
Python loops.
"""

from __future__ import annotations

import numpy as np


def frame_rle(lab: np.ndarray):
    """RLE of one (H,W) int label image.

    Returns (region_ids, interval_counts, ys, lxs, rxs): region ids ascending,
    their intervals contiguous, ordered (y, x) within each region (the proto
    invariant, segmentation.proto:49-57).
    """
    h, w = lab.shape
    flat = lab.ravel()
    start_mask = np.empty(lab.shape, bool)
    start_mask[:, 0] = True
    start_mask[:, 1:] = lab[:, 1:] != lab[:, :-1]
    starts = np.flatnonzero(start_mask)
    run_ids = flat[starts]
    ys, lxs = np.divmod(starts, w)
    ends = np.empty_like(starts)
    ends[:-1] = starts[1:] - 1
    ends[-1] = h * w - 1
    rxs = ends - ys * w

    order = np.argsort(run_ids, kind="stable")  # keeps (y,x) order per id
    run_ids = run_ids[order]
    region_ids, counts = np.unique(run_ids, return_counts=True)
    return region_ids, counts, ys[order], lxs[order], rxs[order]


def region_presence(labels: np.ndarray, num_regions: int):
    """Per-region (start_frame, end_frame, per-frame sizes) over a (T,H,W)
    compact-label volume (labels in [0, num_regions))."""
    t = labels.shape[0]
    sizes = np.stack([np.bincount(labels[f].ravel(), minlength=num_regions)
                      for f in range(t)]).astype(np.int64)
    present = sizes > 0
    start = np.argmax(present, axis=0)
    end = t - 1 - np.argmax(present[::-1], axis=0)
    empty = ~present.any(axis=0)
    start[empty] = -1
    end[empty] = -1
    return start, end, sizes


def region_sizes(labels: np.ndarray, num_regions: int) -> np.ndarray:
    return np.bincount(labels.ravel(), minlength=num_regions).astype(np.int64)


def shape_moments(interval_counts: np.ndarray, ys: np.ndarray,
                  lxs: np.ndarray, rxs: np.ndarray) -> np.ndarray:
    """Per-region ShapeMoments from RLE intervals (closed-form sums).

    Returns (R,6): [size, mean_x, mean_y, E[x^2], E[xy], E[y^2]] — the
    non-central normalized moments the reference stores
    (segmentation_util.cpp:243-280 consumes them as E[..]).
    """
    y = ys.astype(np.float64)
    a = lxs.astype(np.float64)
    b = rxs.astype(np.float64)
    n = b - a + 1.0
    sx = (a + b) * n / 2.0
    # sum_{x=a..b} x^2 = (b(b+1)(2b+1) - (a-1)a(2a-1)) / 6
    sxx = (b * (b + 1) * (2 * b + 1) - (a - 1) * a * (2 * a - 1)) / 6.0
    sy = y * n
    syy = y * y * n
    sxy = y * sx

    r = len(interval_counts)
    idx = np.repeat(np.arange(r), interval_counts)
    out = np.zeros((r, 6), np.float64)
    np.add.at(out, idx, np.stack([n, sx, sy, sxx, sxy, syy], axis=1))
    size = np.maximum(out[:, 0], 1.0)
    return np.stack([out[:, 0], out[:, 1] / size, out[:, 2] / size,
                     out[:, 3] / size, out[:, 4] / size, out[:, 5] / size],
                    axis=1).astype(np.float32)


def neighbor_pairs(labels: np.ndarray) -> np.ndarray:
    """Unique adjacent (a,b) region pairs (a<b) over a (T,H,W) label volume.

    Adjacency: N8 within frames plus temporal identity (the dominant subset
    of the reference's replayed edge set, segmentation_graph.h:466-496).
    """
    # Fused native pass when available (one traversal vs five full-volume
    # NumPy passes — the dense host tail's largest single item at 480p+).
    if labels.ndim == 3 and labels.size and labels.min() >= 0:
        from video_segment_tpu_torch import native

        out = native.neighbor_pairs(labels)
        if out is not None:
            return out

    pairs = []

    def collect(a, b):
        # Boundary pixels only (coherent labels -> a few % of pixels);
        # dedup happens ONCE at the end — per-direction np.unique sorts of
        # full-frame arrays dominated the dense host tail at 720p+.
        m = a != b
        if m.any():
            pa, pb = a[m], b[m]
            lo = np.minimum(pa, pb).astype(np.int64)
            hi = np.maximum(pa, pb).astype(np.int64)
            pairs.append(lo << 32 | hi)

    # Spatial N8 forward offsets.
    collect(labels[:, :, :-1], labels[:, :, 1:])
    collect(labels[:, :-1, :], labels[:, 1:, :])
    collect(labels[:, :-1, 1:], labels[:, 1:, :-1])
    collect(labels[:, :-1, :-1], labels[:, 1:, 1:])
    # Temporal (center).
    if labels.shape[0] > 1:
        collect(labels[:-1], labels[1:])

    if not pairs:
        return np.zeros((0, 2), np.int32)
    packed = np.unique(np.concatenate(pairs))
    return np.stack([packed >> 32, packed & 0xFFFFFFFF], axis=1).astype(
        np.int32)


def compact_labels(labels: np.ndarray):
    """Map arbitrary int labels to [0,R); returns (compact (T,H,W), roots).

    Labels from the solver are bounded non-negative voxel indices, so a
    presence-mask + searchsorted beats np.unique's sort by ~10x."""
    flat = labels.ravel()
    lo = int(flat.min())
    if lo >= 0:
        present = np.zeros(int(flat.max()) + 1, bool)
        present[flat] = True
        roots = np.flatnonzero(present)
        # Dense int32 rank lookup table: one gather instead of a
        # searchsorted over every pixel (int64 gathers are ~7x slower).
        lut = (np.cumsum(present, dtype=np.int64) - 1).astype(np.int32)
        compact = lut[flat]
        return compact.reshape(labels.shape), roots
    roots, inv = np.unique(labels, return_inverse=True)
    return inv.reshape(labels.shape).astype(np.int32), roots


def enforce_n4_connectivity(lab: np.ndarray) -> np.ndarray:
    """Resolve checkerboard diagonal crossings in one (H,W) frame by flipping
    the offending pixel to a 4-neighbor's label (reference
    EnforceN4Connectivity, dense_segmentation_graph.h:1303-1337).

    Pattern: lab[y,x]==lab[y+1,x+1] != lab[y,x+1]==lab[y+1,x] — the two
    diagonals cross with no N4 path.  Flip (y,x) to its right neighbor.
    """
    a = lab[:-1, :-1]
    b = lab[:-1, 1:]
    c = lab[1:, :-1]
    d = lab[1:, 1:]
    cross = (a == d) & (b == c) & (a != b)
    if not cross.any():
        return lab
    out = lab.copy()
    yy, xx = np.nonzero(cross)
    out[yy, xx] = lab[yy, xx + 1]
    return out
