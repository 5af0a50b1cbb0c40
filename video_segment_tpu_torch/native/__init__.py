"""ctypes bindings for the native host kernels (built on first use).

The helpers (`vst_native.cc` describes each): connected components,
run-length encoding, the threaded Lab histogram fill, a weighted bincount,
tube linking, neighbour pairs, the colour chi-square per edge, the
region stage's BGR->Lab with the frame's channel sums, and the `.pb`
encoder's boundary tracer.

g++ builds `vst_native.cc` into the package's git-ignored `_build/`
directory, named by a hash of the source, so concurrent processes never
load a half-written library.  Falls back to None handles if the toolchain
is unavailable; callers keep a pure-NumPy/SciPy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "vst_native.cc")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread")

_lib = None


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"vst_native-{digest}.so")


def _build() -> str | None:
    """Path of the built library, or None if g++ is missing or fails."""
    try:
        lib = _lib_path()
        if not os.path.exists(lib):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{lib}.{os.getpid()}.tmp"
            subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC], check=True,
                           capture_output=True)
            os.replace(tmp, lib)
        return lib
    except Exception:
        return None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.multi_label_cc.restype = ctypes.c_int32
    lib.multi_label_cc.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32)]
    lib.rle_encode_rows.restype = ctypes.c_int64
    lib.rle_encode_rows.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
    lib.accumulate_lab_hist.restype = None
    lib.accumulate_lab_hist.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float)]
    lib.link_tubes.restype = ctypes.c_int64
    lib.link_tubes.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int32, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64)]
    lib.neighbor_pairs.restype = ctypes.c_int64
    lib.neighbor_pairs.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64]
    lib.weighted_bincount.restype = None
    lib.weighted_bincount.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float)]
    lib.chi_square_edges.restype = None
    lib.chi_square_edges.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float)]
    lib.bgr_to_lab_u8.restype = None
    lib.bgr_to_lab_u8.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64)]
    lib.trace_segments.restype = ctypes.c_int64
    lib.trace_segments.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def multi_label_cc(labels: np.ndarray):
    """(H,W) int32 labels -> (components (H,W) int32, n_components).

    Components are N4-connected within equal labels only."""
    lib = _load()
    h, w = labels.shape
    labels = np.ascontiguousarray(labels, np.int32)
    comp = np.empty((h, w), np.int32)
    if lib is not None:
        n = lib.multi_label_cc(
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), h, w,
            comp.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return comp, int(n)
    # SciPy fallback: per-label ndimage.label over bounding boxes.
    from scipy import ndimage

    comp.fill(-1)
    next_id = 0
    for lab in np.unique(labels):
        mask = labels == lab
        cc, k = ndimage.label(mask)
        comp[mask] = cc[mask] - 1 + next_id
        next_id += k
    return comp, next_id


def rle_encode(labels: np.ndarray):
    """(H,W) int labels -> (ids, ys, lxs, rxs) run arrays (row-major)."""
    lib = _load()
    h, w = labels.shape
    if lib is None:
        raise RuntimeError("native library unavailable")
    labels = np.ascontiguousarray(labels, np.int64)
    cap = h * w
    out = np.empty((cap, 4), np.int64)
    n = lib.rle_encode_rows(
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap)
    runs = out[:n]
    return runs[:, 0], runs[:, 1], runs[:, 2], runs[:, 3]


def accumulate_lab_hist(labels: np.ndarray, lab_u8: np.ndarray,
                        rcap: int, lum_bins: int, color_bins: int,
                        gains: np.ndarray | None = None,
                        win_slot: np.ndarray | None = None,
                        wcap: int = 1,
                        n_threads: int = 0) -> np.ndarray | None:
    """Threaded trilinear Lab histogram fill.

    labels (T,H,W) int32 in [0,rcap); lab_u8 (T,H,W,3) uint8; optional
    per-frame gains (T,3) float32 and window slots (T,) int32 (< wcap).
    Returns (wcap, rcap, nbins) float32, or None when the native library
    is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    t = labels.shape[0]
    hw = int(np.prod(labels.shape[1:]))
    nbins = lum_bins * color_bins * color_bins
    labels = np.ascontiguousarray(labels, np.int32)
    lab_u8 = np.ascontiguousarray(lab_u8, np.uint8)
    if gains is None:
        gains = np.ones((t, 3), np.float32)
    gains = np.ascontiguousarray(gains, np.float32)
    if win_slot is None:
        win_slot = np.zeros(t, np.int32)
    win_slot = np.ascontiguousarray(win_slot, np.int32)
    out = np.zeros(wcap * rcap * nbins, np.float32)
    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)
    lib.accumulate_lab_hist(
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lab_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        t, hw, rcap, lum_bins, color_bins,
        gains.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        win_slot.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out.reshape(wcap, rcap, nbins)


def weighted_bincount(keys: np.ndarray, weights: np.ndarray, m: int,
                      n_threads: int = 0) -> np.ndarray | None:
    """out[k] = sum of weights where keys == k; None if lib unavailable."""
    lib = _load()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys.reshape(-1), np.int64)
    weights = np.ascontiguousarray(weights.reshape(-1), np.float32)
    out = np.zeros(m, np.float32)
    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)
    lib.weighted_bincount(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        weights.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(keys), m, n_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def chi_square_edges(hist: np.ndarray, edges: np.ndarray,
                     n_threads: int = 0) -> np.ndarray | None:
    """(E,) float32 chi-square distances of the L1-normalized rows of
    `hist` (R, B) float32 for the row pairs `edges` (E, 2), bit for bit
    as `ops/histograms.edge_color_distance` computes them on the CPU
    (XLA's summation order); None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    hist = np.ascontiguousarray(hist, np.float32)
    edges = np.ascontiguousarray(edges, np.int32)
    out = np.empty(len(edges), np.float32)
    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)
    if len(edges):
        lib.chi_square_edges(
            hist.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            hist.shape[1],
            edges.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(edges), n_threads,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def bgr_to_lab_u8(frame_bgr_u8: np.ndarray, gamma_tab: np.ndarray,
                  cbrt_tab: np.ndarray, coeffs: np.ndarray):
    """(..., 3) uint8 BGR -> ((..., 3) uint8 Lab, (3,) int64 channel sums)
    in one single-threaded pass over the tables of `core/region.py`, the
    same bytes as that module's NumPy body; None if the library is
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    frame = np.ascontiguousarray(frame_bgr_u8, np.uint8)
    lab = np.empty_like(frame)
    sums = np.zeros(3, np.int64)
    ip = ctypes.POINTER(ctypes.c_int64)
    up = ctypes.POINTER(ctypes.c_uint8)
    tabs = [np.ascontiguousarray(t, np.int64)
            for t in (gamma_tab, cbrt_tab, coeffs)]
    lib.bgr_to_lab_u8(frame.ctypes.data_as(up), frame.size // 3,
                      *(t.ctypes.data_as(ip) for t in tabs),
                      lab.ctypes.data_as(up), sums.ctypes.data_as(ip))
    return lab, sums


def trace_segments(label_img: np.ndarray):
    """The boundary segments of an (H, W) label image (see vst_native.cc),
    as (points (P, 2) int32 corner (x, y) of every segment back to back,
    ends (S,) int64 each segment's end in points, sides (S, 2) int32 left
    and right region, dirs (S, 2) int32 first and last step direction);
    None if the library is unavailable.  Labels must fit in int32."""
    lib = _load()
    if lib is None:
        return None
    h, w = label_img.shape
    lab = np.ascontiguousarray(label_img, np.int32)
    # Each crack lies on one segment; a segment has one point more than
    # it has cracks.
    cracks = h * (w + 1) + (h + 1) * w
    pts = np.empty((2 * cracks, 2), np.int32)
    ends = np.empty(cracks, np.int64)
    sides = np.empty((cracks, 2), np.int32)
    dirs = np.empty((cracks, 2), np.int32)
    i32 = ctypes.POINTER(ctypes.c_int32)
    n = lib.trace_segments(lab.ctypes.data_as(i32), h, w,
                           pts.ctypes.data_as(i32), len(pts),
                           ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                           sides.ctypes.data_as(i32),
                           dirs.ctypes.data_as(i32), cracks)
    if n < 0:
        raise RuntimeError("trace_segments: buffers too small")
    return pts[:ends[n - 1] if n else 0], ends[:n], sides[:n], dirs[:n]


def neighbor_pairs(labels: np.ndarray,
                   n_threads: int = 0) -> np.ndarray | None:
    """Unique adjacent (a,b) pairs (a<b, packed-int64 dedup) over a (T,H,W)
    int32 label volume — fused single-pass version of
    ops/rle.neighbor_pairs; None when the native library is unavailable
    (labels must be non-negative and < 2^31)."""
    lib = _load()
    if lib is None:
        return None
    labels = np.ascontiguousarray(labels, np.int32)
    t, h, w = labels.shape
    cap = 1 << 21
    while True:
        out = np.empty(cap, np.int64)
        n = lib.neighbor_pairs(
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            t, h, w,
            n_threads if n_threads > 0 else min(8, os.cpu_count() or 1),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap)
        if n >= 0:
            packed = out[:n]
            return np.stack([packed >> 32, packed & 0xFFFFFFFF],
                            axis=1).astype(np.int32)
        cap *= 4


def link_tubes(region, area, cx, cy, mx, my, offsets, diag_thresh):
    """Tube matching for spatial-connectedness (see vst_native.cc).

    Concatenated per-frame component tables + frame offsets; returns
    (tube_of (n,), tube_region (T,), tube_area (T,), tube_count (T,))
    or None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(region)
    region = np.ascontiguousarray(region, np.int64)
    area = np.ascontiguousarray(area, np.float64)
    cx = np.ascontiguousarray(cx, np.float64)
    cy = np.ascontiguousarray(cy, np.float64)
    mx = np.ascontiguousarray(mx, np.float64)
    my = np.ascontiguousarray(my, np.float64)
    offsets = np.ascontiguousarray(offsets, np.int64)
    tube_of = np.empty(n, np.int64)
    t_region = np.empty(max(n, 1), np.int64)
    t_area = np.empty(max(n, 1), np.float64)
    t_count = np.empty(max(n, 1), np.int64)
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int64)
    n_tubes = lib.link_tubes(
        region.ctypes.data_as(ip), area.ctypes.data_as(dp),
        cx.ctypes.data_as(dp), cy.ctypes.data_as(dp),
        mx.ctypes.data_as(dp), my.ctypes.data_as(dp),
        offsets.ctypes.data_as(ip), len(offsets) - 1,
        ctypes.c_double(diag_thresh),
        tube_of.ctypes.data_as(ip), t_region.ctypes.data_as(ip),
        t_area.ctypes.data_as(dp), t_count.ctypes.data_as(ip))
    return (tube_of, t_region[:n_tubes], t_area[:n_tubes],
            t_count[:n_tubes])
