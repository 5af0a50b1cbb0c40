"""Joint region-boundary tracing and vectorization (host).

Reimplements the reference's Liow-style boundary computation
(segmentation/boundary.{h,cpp}): boundaries live in CORNER space
[0,W]x[0,H] (boundary.h:41-43), vertices are corners where >=3 regions
meet (or the image border turns), segments are maximal crack chains
between vertices with constant (left_region, right_region), and every
shared segment is simplified ONCE with cv2.approxPolyDP
(boundary.cpp:513-570) so adjacent polygons share vertices exactly —
the simplified segment graph still partitions the frame, which makes the
raster -> vector -> raster round trip gap- and overlap-free with no
crack-filling pass.

Directions are (dx, dy) with y down; "left" of a walking direction is 90
degrees counter-clockwise in mathematical orientation, i.e. (dy, -dx) in
y-down coordinates.
"""

from __future__ import annotations

import cv2
import numpy as np

MAX_POLY_ERROR = 1.0   # boundary.cpp approxPolyDP max_error
MIN_SEGMENT_LEN = 4    # points below which a segment is kept verbatim

# Walking directions: index -> (dx, dy).
_DIRS = ((1, 0), (0, 1), (-1, 0), (0, -1))


def _cracks(label_img: np.ndarray):
    """Boolean crack grids.

    vert[y, x] (H, W+1): crack (x,y)-(x,y+1) between pixels (y,x-1)|(y,x).
    horz[y, x] (H+1, W): crack (x,y)-(x+1,y) between pixels (y-1,x)|(y,x).
    Outside the frame counts as region -1, so the border is traced too.
    """
    h, w = label_img.shape
    pad = np.full((h + 2, w + 2), -1, np.int64)
    pad[1:-1, 1:-1] = label_img
    vert = pad[1:-1, :-1] != pad[1:-1, 1:]        # (H, W+1)
    horz = pad[:-1, 1:-1] != pad[1:, 1:-1]        # (H+1, W)
    return vert, horz


def _corner_degree(vert, horz):
    h, wp1 = vert.shape
    deg = np.zeros((h + 1, wp1), np.int8)
    deg[:-1, :] += vert
    deg[1:, :] += vert
    deg[:, :-1] += horz
    deg[:, 1:] += horz
    return deg


def _sides(label_img, cx, cy, d):
    """(left, right) region ids of the crack leaving corner (cx,cy) in
    direction d (index into _DIRS)."""
    h, w = label_img.shape

    def at(py, px):
        if 0 <= py < h and 0 <= px < w:
            return int(label_img[py, px])
        return -1

    if d == 0:    # right: crack (cx,cy)-(cx+1,cy); north pixel left
        return at(cy - 1, cx), at(cy, cx)
    if d == 1:    # down: crack (cx,cy)-(cx,cy+1); east pixel left
        return at(cy, cx), at(cy, cx - 1)
    if d == 2:    # left
        return at(cy, cx - 1), at(cy - 1, cx - 1)
    return at(cy - 1, cx - 1), at(cy - 1, cx)     # up


def _step_exists(vert, horz, cx, cy, d):
    h, wp1 = vert.shape
    w = wp1 - 1
    if d == 0:
        return cy <= h and cx < w and horz[cy, cx]
    if d == 1:
        return cx <= w and cy < h and vert[cy, cx]
    if d == 2:
        return cy <= h and cx > 0 and horz[cy, cx - 1]
    return cx <= w and cy > 0 and vert[cy - 1, cx]


def trace_segments(label_img: np.ndarray):
    """All boundary segments of a label image.

    Returns a list of dicts: points (K,2) int32 corner (x,y) chains
    (including endpoints), left, right region ids (-1 = outside), first
    and last step direction (indices into _DIRS).  The native tracer
    (`native.trace_segments`) walks them where it is built and the labels
    fit in int32; `_trace_segments_py` (the oracle) elsewhere: the same
    segments in the same order.
    """
    from video_segment_tpu_torch import native
    if label_img.size and (int(label_img.min()) >= -2 ** 31
                           and int(label_img.max()) < 2 ** 31):
        out = native.trace_segments(label_img)
        if out is not None:
            pts, ends, sides, dirs = out
            starts = [0] + ends[:-1].tolist()
            return [dict(points=pts[a:b], left=lt, right=rt, first=f,
                         last=la)
                    for a, b, (lt, rt), (f, la) in zip(
                        starts, ends.tolist(), sides.tolist(),
                        dirs.tolist())]
    return _trace_segments_py(label_img)


def _trace_segments_py(label_img: np.ndarray):
    """`trace_segments` in Python: the oracle of the native tracer."""
    vert, horz = _cracks(label_img)
    deg = _corner_degree(vert, horz)
    vvis = np.zeros_like(vert)
    hvis = np.zeros_like(horz)

    def mark(cx, cy, d):
        if d == 0:
            hvis[cy, cx] = True
        elif d == 1:
            vvis[cy, cx] = True
        elif d == 2:
            hvis[cy, cx - 1] = True
        else:
            vvis[cy - 1, cx] = True

    def seen(cx, cy, d):
        if d == 0:
            return hvis[cy, cx]
        if d == 1:
            return vvis[cy, cx]
        if d == 2:
            return hvis[cy, cx - 1]
        return vvis[cy - 1, cx]

    def advance(cx, cy, d):
        dx, dy = _DIRS[d]
        return cx + dx, cy + dy

    junction = deg >= 3
    # Frame corners are forced vertices: simplification preserves segment
    # endpoints, so pinning them keeps the border rasterization exact
    # (otherwise approxPolyDP may cut a frame corner diagonally).
    junction[0, 0] = junction[0, -1] = True
    junction[-1, 0] = junction[-1, -1] = True
    segments = []

    def walk(cx, cy, d):
        """Walk from (cx,cy) along direction d until the next junction (or
        back to the start for loops); marks cracks visited."""
        left, right = _sides(label_img, cx, cy, d)
        pts = [(cx, cy)]
        sx, sy = cx, cy
        first = d
        while True:
            mark(cx, cy, d)
            cx, cy = advance(cx, cy, d)
            pts.append((cx, cy))
            if junction[cy, cx] or (cx, cy) == (sx, sy):
                break
            # Degree-2 corner: continue along the other crack (never the
            # reverse of the one we came on).
            back = (d + 2) % 4
            nxt = None
            for d2 in range(4):
                if d2 != back and _step_exists(vert, horz, cx, cy, d2):
                    nxt = d2
                    break
            if nxt is None:
                break  # dead end: cannot happen on closed crack graphs
            d = nxt
        segments.append(dict(points=np.asarray(pts, np.int32),
                             left=left, right=right, first=first, last=d))

    # Segments between junctions.
    jys, jxs = np.nonzero(junction)
    for cy, cx in zip(jys.tolist(), jxs.tolist()):
        for d in range(4):
            if _step_exists(vert, horz, cx, cy, d) and not seen(cx, cy, d):
                walk(cx, cy, d)
    # Remaining cracks belong to junction-free closed loops.
    for grid, vis, d0 in ((vert, vvis, 1), (horz, hvis, 0)):
        ys, xs = np.nonzero(grid & ~vis)
        for cy, cx in zip(ys.tolist(), xs.tolist()):
            if not (grid[cy, cx] and not vis[cy, cx]):
                continue
            walk(cx, cy, d0)
    return segments


def _simplify(points: np.ndarray, max_error: float) -> np.ndarray:
    if len(points) < MIN_SEGMENT_LEN or max_error <= 0:
        return points
    closed = tuple(points[0]) == tuple(points[-1])
    if closed:
        simp = cv2.approxPolyDP(points[:-1].reshape(-1, 1, 2), max_error,
                                closed=True).reshape(-1, 2)
        if len(simp) < 3:
            simp = points[:-1]
        return np.concatenate([simp, simp[:1]], axis=0)
    simp = cv2.approxPolyDP(points.reshape(-1, 1, 2), max_error,
                            closed=False).reshape(-1, 2)
    return simp


def _assemble(region_segments):
    """Order a region's oriented segments into closed rings.

    region_segments: list of (pts (K,2), first_dir, last_dir, ...) oriented
    so the region is on the LEFT, directions as indices into _DIRS.
    Returns list of rings (each a list of indices into region_segments, in
    traversal order).
    At degree-4 corners a region can own two incoming and two outgoing
    segments; the sharpest-left-turn rule (planar face traversal) picks the
    continuation that keeps the region interior on the left.
    """
    by_start: dict[tuple, list] = {}
    for i, seg in enumerate(region_segments):
        by_start.setdefault(tuple(seg[0][0].tolist()), []).append(i)
    used = [False] * len(region_segments)
    rings = []
    for i0 in range(len(region_segments)):
        if used[i0]:
            continue
        ring = []
        i = i0
        while True:
            used[i] = True
            pts, fd, ld = region_segments[i][:3]
            ring.append(i)
            key = tuple(pts[-1].tolist())
            cands = [j for j in by_start.get(key, []) if not used[j]]
            if not cands:
                break
            if len(cands) == 1:
                i = cands[0]
                continue
            # Sharpest left turn relative to the incoming direction.
            def turn(j):
                # angle of j's first direction measured CCW (math sense,
                # y down) from ld
                return (ld - region_segments[j][1]) % 4
            i = min(cands, key=turn)
        rings.append(ring)
    return rings


def compute_vectorization(label_img: np.ndarray, region_ids=None,
                          interval_counts=None, ys=None, lxs=None, rxs=None,
                          max_error: float = MAX_POLY_ERROR, trace=None):
    """Vectorize all regions of one frame with jointly traced boundaries.

    Signature-compatible with the previous per-region tracer (the RLE
    arguments are unused — the label image has everything).  Returns
    (mesh_coords float32 (2M,), {region_id: [(coord_idx_array, hole)]}) in
    CORNER coordinates [0,W]x[0,H] (boundary.h:41-43), indices referencing
    x positions in the flat mesh.

    Every segment is drawn once, as one polyline that both of its regions
    walk (in opposite directions), so the rings partition the frame: each
    pixel centre lies in exactly one region's rings, and the rings'
    shoelace areas sum to W x H.  A ring that degenerates after
    simplification (a 1-px-wide straight region: its two side segments
    each simplify to the same 2-point diagonal, so the ring has < 3
    points and would vanish) is rebuilt from its crack points, and every
    segment of that ring keeps its crack points in the neighbours' rings
    too.  `trace` (a `runtime.trace.Trace`, or None) counts the rings
    emitted (`encode.rings`) and those rebuilt from crack points
    (`encode.ring_fallbacks`).
    """
    segments = trace_segments(label_img)
    simplified = [_simplify(s["points"], max_error) for s in segments]

    # Oriented views per region: (simplified points, first and last
    # directions, segment index, reversed).  First/last directions are the
    # UNSIMPLIFIED crack steps: simplified segments can enter/leave
    # junctions diagonally, and a snapped direction mis-ranks the
    # sharpest-left-turn rule at degree-4 corners — rings then fail to
    # close (degenerate collinear polygons in raster-free streams).
    # Walked backwards, a segment starts opposite its last step and ends
    # opposite its first.
    per_region: dict[int, list] = {}
    for k, (s, p) in enumerate(zip(segments, simplified)):
        if len(p) < 2:
            continue
        fdir, ldir = s["first"], s["last"]
        if s["left"] >= 0:
            per_region.setdefault(s["left"], []).append(
                (p, fdir, ldir, k, False))
        if s["right"] >= 0:
            per_region.setdefault(s["right"], []).append(
                (p[::-1], (ldir + 2) % 4, (fdir + 2) % 4, k, True))

    # Rings per region; segments of a degenerate ring keep their crack
    # points in every ring that walks them.
    rings = {rid: _assemble(rsegs) for rid, rsegs in per_region.items()}
    cracked: set[int] = set()
    fallbacks = 0
    for rid, rsegs in per_region.items():
        for ring in rings[rid]:
            if sum(len(rsegs[i][0]) - 1 for i in ring) < 3:
                cracked.update(rsegs[i][3] for i in ring)
                fallbacks += 1

    def points(seg):
        pts, _, _, k, rev = seg
        if k not in cracked:
            return pts
        orig = segments[k]["points"]
        return orig[::-1] if rev else orig

    vertex_pool: dict[tuple, int] = {}
    coords: list[float] = []

    def vid(key):
        idx = vertex_pool.get(key)
        if idx is None:
            idx = len(coords)
            vertex_pool[key] = idx
            coords.extend((float(key[0]), float(key[1])))
        return idx

    polys: dict[int, list] = {}
    n_rings = 0
    for rid, rsegs in per_region.items():
        plist = []
        for ring in rings[rid]:
            pts = np.concatenate([points(rsegs[i])[:-1] for i in ring],
                                 axis=0)
            if len(pts) < 3:
                continue
            # Shoelace in y-down coords; region-on-left traversal makes
            # OUTER rings come out with negative shoelace area; holes
            # positive.
            x = pts[:, 0].astype(np.float64)
            y = pts[:, 1].astype(np.float64)
            area2 = np.sum(x * np.concatenate((y[1:], y[:1]))
                           - np.concatenate((x[1:], x[:1])) * y)
            is_hole = area2 > 0
            plist.append((np.asarray([vid(p) for p in map(
                tuple, pts.tolist())], np.int64), bool(is_hole)))
        n_rings += len(plist)
        polys[int(rid)] = plist
    if trace is not None:
        trace.count("encode.rings", n_rings)
        trace.count("encode.ring_fallbacks", fallbacks)
    return np.asarray(coords, np.float32), polys


def rasterize_polygons(h, w, poly_sets):
    """Even-odd scanline rasterization of corner-space polygons.

    poly_sets: iterable of (region_id, [points (K,2) float]) — each
    region's rings (outer + holes together; even-odd handles holes).
    Pixel (y,x) belongs to the region whose rings enclose its center
    (x+.5, y+.5); the half-open crossing rule (ymin <= yc < ymax) makes
    adjacent polygons partition the frame exactly.
    Returns (H,W) int64 label image (-1 where uncovered).
    """
    out = np.full((h, w), -1, np.int64)
    for rid, rings in poly_sets:
        if not rings:
            continue
        exs = []
        eys = []
        for pts in rings:
            p = np.asarray(pts, np.float64)
            q = np.roll(p, -1, axis=0)
            exs.append(np.stack([p[:, 0], q[:, 0]], 1))
            eys.append(np.stack([p[:, 1], q[:, 1]], 1))
        ex = np.concatenate(exs)                  # (E,2) x0,x1
        ey = np.concatenate(eys)                  # (E,2) y0,y1
        nonh = ey[:, 0] != ey[:, 1]
        ex, ey = ex[nonh], ey[nonh]
        if not len(ey):      # degenerate ring (all-horizontal): no pixels
            continue
        ylo = np.minimum(ey[:, 0], ey[:, 1])
        yhi = np.maximum(ey[:, 0], ey[:, 1])
        y0r = max(int(np.floor(ylo.min() - 0.5)), 0)
        y1r = min(int(np.ceil(yhi.max() + 0.5)), h - 1)
        for py in range(y0r, y1r + 1):
            yc = py + 0.5
            act = (ylo <= yc) & (yc < yhi)
            if not act.any():
                continue
            t = (yc - ey[act, 0]) / (ey[act, 1] - ey[act, 0])
            xs = ex[act, 0] + t * (ex[act, 1] - ex[act, 0])
            xs = np.sort(xs)
            for a, b in zip(xs[0::2], xs[1::2]):
                x0 = max(int(np.ceil(a - 0.5)), 0)
                x1 = min(int(np.ceil(b - 0.5)) - 1, w - 1)
                if x1 >= x0:
                    out[py, x0:x1 + 1] = rid
    return out
