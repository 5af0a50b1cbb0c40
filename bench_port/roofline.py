"""Peaks of the card and the work of the port's kernels, counted from the
problem's shapes (a frozen copy of the arithmetic of the repository's
`chip_smoke.bound` and of PERF.md's kernel table).

A kernel's roofline share is its least time over its measured device
time.  The least time is the larger of its bytes over the HBM rate and
its operations over their type's peak rate.  The counts follow the
problem, not the kernel, so a later kernel that does the same work is
held to the same count.
"""

from __future__ import annotations

# One H100 SXM (NVIDIA's data sheet, dense rates, 700 W): HBM bytes/s and
# operations/s outside the tensor cores.
HBM_BYTES_S = 3.35e12
OPS_S = {"f32": 67e12, "i32": 67e12, "f64": 34e12}

TILE_H, TILE_W = 8, 128          # K1's tile
K1_DIRS = ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1),
           (-1, -1))             # K1's in-tile N8 edges, both ways
K1_BYTES_PER_PX = 36             # 12 read (3 float32), 24 written (6 x 4)
K1_F32_OPS_PER_EDGE = 10         # the edge's bucket
K2_DIRECTIONS = 13               # half of the 26-neighbourhood
K2_BYTES_PER_KEY = 4 + 4         # an int32 key read and one written
K2_BYTES_PER_VOXEL = 4 + 4       # the two int32 tile-local label planes


def least_seconds(nbytes: float, ops: dict) -> float:
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = sum(n / OPS_S[k] for k, n in ops.items())
    return max(t_bytes, t_ops)


def k1_in_tile_edges(h: int, w: int) -> int:
    """Directed in-tile N8 edges of one (h, w) frame on the (8, 128)
    tile grid."""
    def span(n, d, tile):
        return sum(1 for x in range(n) if 0 <= x + d < n
                   and x // tile == (x + d) // tile)
    return sum(span(h, dy, TILE_H) * span(w, dx, TILE_W)
               for dy, dx in K1_DIRS)


def k1_least_seconds(frames: int, h: int, w: int) -> float:
    """K1 over `frames` frames of (h, w): 36 bytes a pixel; 10 float32
    operations an in-tile edge.  The float64 merge tests depend on the
    data and are not counted (they can only raise the bound; bytes bound
    K1 ten times over the edge operations)."""
    return frames * least_seconds(
        K1_BYTES_PER_PX * h * w,
        {"f32": K1_F32_OPS_PER_EDGE * k1_in_tile_edges(h, w)})


def k2_least_seconds(solve_frames: list, h: int, w: int) -> float:
    """K2 over chunk solves of `solve_frames` frames each at (h, w): 13
    keys a voxel read and written, two label planes read.  Integer
    minima: bytes bound it."""
    return sum(least_seconds(
        t * h * w * (K2_DIRECTIONS * K2_BYTES_PER_KEY + K2_BYTES_PER_VOXEL),
        {"i32": K2_DIRECTIONS * t * h * w}) for t in solve_frames)
