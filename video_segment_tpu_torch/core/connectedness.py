"""Spatial-connectedness enforcement via tube analysis (host).

Equivalent of the reference's EnforceSpatialConnectedness
(dense_segmentation_graph.h:666-904 + tube helpers in
dense_segmentation_graph.cpp:35-212): a spatio-temporal region may be
3D-connected only through other frames, leaving 2D islands within a frame.
Per region, per-frame connected components are linked into tubes by
centroid/area tracking; the largest tube keeps the region's label and every
other tube becomes a new region.

Matching thresholds follow the reference: consecutive components join a tube
when the centroid distance is below 4% of the frame diagonal and the area
ratio exceeds 0.75 (dense_segmentation_graph.h:735-742); temporally abutting
tubes of the same region with matching geometry are merged before
relabeling.  When backward flow is available, the current component's
centroid is advected into the previous frame before the distance test
(dense_segmentation_graph.h:735-742 advects along flow).

The per-frame multi-label connected components run in native C++
(video_segment_tpu_torch.native.multi_label_cc).
"""

from __future__ import annotations

import numpy as np

from video_segment_tpu_torch import native


def _frame_components(frame_labels: np.ndarray):
    """-> (comp_img, per-component (region, area, cx, cy) arrays)."""
    comp, n = native.multi_label_cc(frame_labels.astype(np.int32))
    flat = comp.ravel()
    area = np.bincount(flat, minlength=n).astype(np.float64)
    h, w = frame_labels.shape
    ys = np.repeat(np.arange(h), w).astype(np.float64)
    xs = np.tile(np.arange(w), h).astype(np.float64)
    cy = np.bincount(flat, weights=ys, minlength=n) / np.maximum(area, 1)
    cx = np.bincount(flat, weights=xs, minlength=n) / np.maximum(area, 1)
    region = np.full(n, -1, np.int64)
    region[flat] = frame_labels.ravel()
    return comp, region, area, cx, cy


def enforce_spatial_connectedness(labels: np.ndarray, num_regions: int,
                                  min_avg_tube_area: float = 20.0,
                                  flow: np.ndarray | None = None):
    """Split per-frame islands of each region into per-tube regions.

    Args:
      labels: (T,H,W) compact region indices in [0, num_regions).
      flow: optional (T-1,H,W,2) backward flow; frame f's centroids are
        advected by flow[f-1] before matching against frame f-1 tubes.
    Returns (new_labels, total_regions, origin): origin[r] gives, for every
    region index in the result (old and new), the original region it came
    from — new tube regions inherit descriptors/constraints decisions from
    the caller accordingly (constraints are dropped for split-off tubes,
    matching the reference's relabel-as-new-regions behavior).
    """
    t, h, w = labels.shape
    diag_thresh = 0.04 * np.hypot(h, w)

    comps = []
    regions_l, areas_l, cxs_l, cys_l, mxs_l, mys_l = [], [], [], [], [], []
    offsets = [0]
    for f in range(t):
        comp, region, area, cx, cy = _frame_components(labels[f])
        comps.append(comp)
        # Advect centroids into the previous frame along backward flow
        # before matching (raw centroid when flow is absent).
        mx, my = cx.copy(), cy.copy()
        if flow is not None and f > 0:
            fl = flow[f - 1]
            iy = np.clip(np.round(cy).astype(np.int64), 0, h - 1)
            ix = np.clip(np.round(cx).astype(np.int64), 0, w - 1)
            mx = cx + fl[iy, ix, 0].astype(np.float64)
            my = cy + fl[iy, ix, 1].astype(np.float64)
        regions_l.append(region)
        areas_l.append(area)
        cxs_l.append(cx)
        cys_l.append(cy)
        mxs_l.append(mx)
        mys_l.append(my)
        offsets.append(offsets[-1] + len(region))

    region_a = np.concatenate(regions_l)
    area_a = np.concatenate(areas_l)
    nat = native.link_tubes(region_a, area_a, np.concatenate(cxs_l),
                            np.concatenate(cys_l), np.concatenate(mxs_l),
                            np.concatenate(mys_l), np.asarray(offsets),
                            diag_thresh)
    if nat is not None:
        tube_flat, t_region, t_area, t_count = nat
    else:
        tube_flat, t_region, t_area, t_count = _link_tubes_py(
            region_a, area_a, np.concatenate(cxs_l), np.concatenate(cys_l),
            np.concatenate(mxs_l), np.concatenate(mys_l),
            np.asarray(offsets), diag_thresh)
    n_tubes = len(t_region)

    # Pick the largest tube per region; everything else becomes new regions
    # (tiny tubes are folded into the region's main tube to avoid noise,
    # mirroring the reference's small-tube merging).
    main_area = np.full(num_regions, -1.0)
    np.maximum.at(main_area, t_region, t_area)
    is_main = np.zeros(n_tubes, bool)
    claimed = np.zeros(num_regions, bool)
    for tid in range(n_tubes):  # first max-area tube per region wins
        r = t_region[tid]
        if not claimed[r] and t_area[tid] == main_area[r]:
            is_main[tid] = True
            claimed[r] = True
    tiny = t_area / np.maximum(t_count, 1) < min_avg_tube_area
    keep_with_region = is_main | tiny
    new_ids = np.where(keep_with_region, t_region, 0).astype(np.int64)
    split = np.flatnonzero(~keep_with_region)
    new_ids[split] = num_regions + np.arange(len(split))
    origin = np.concatenate([np.arange(num_regions, dtype=np.int64),
                             t_region[split]])

    if len(split) == 0:
        return labels, num_regions, origin

    out = labels.copy()
    for f in range(t):
        tids = tube_flat[offsets[f]:offsets[f + 1]]
        mapping = np.where(tids >= 0, new_ids[np.maximum(tids, 0)], 0)
        remapped = mapping[comps[f]]
        keep = remapped != labels[f]
        if keep.any():
            out[f] = np.where(keep, remapped, out[f])
    return out, len(origin), origin


def _link_tubes_py(region_a, area_a, cx_a, cy_a, mx_a, my_a, offsets,
                   diag_thresh):
    """Pure-Python fallback of native.link_tubes (same semantics)."""
    n = len(region_a)
    tube_of = np.full(n, -1, np.int64)
    t_region, t_area, t_count = [], [], []
    open_prev: dict = {}
    for f in range(len(offsets) - 1):
        open_now: dict = {}
        for ci in range(int(offsets[f]), int(offsets[f + 1])):
            r = int(region_a[ci])
            if r < 0:
                continue
            best = None
            best_d = diag_thresh
            for tid, px, py, pa in open_prev.get(r, ()):
                d = np.hypot(mx_a[ci] - px, my_a[ci] - py)
                ratio = min(area_a[ci], pa) / max(area_a[ci], pa, 1.0)
                if d < best_d and ratio > 0.75:
                    best = tid
                    best_d = d
            if best is None:
                best = len(t_region)
                t_region.append(r)
                t_area.append(0.0)
                t_count.append(0)
            tube_of[ci] = best
            t_area[best] += float(area_a[ci])
            t_count[best] += 1
            open_now.setdefault(r, []).append(
                (best, float(cx_a[ci]), float(cy_a[ci]),
                 float(area_a[ci])))
        open_prev = open_now
    return (tube_of, np.asarray(t_region, np.int64),
            np.asarray(t_area), np.asarray(t_count, np.int64))
