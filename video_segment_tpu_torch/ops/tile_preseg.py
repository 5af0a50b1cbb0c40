"""Tile flood pre-segmentation (K4): wrapper, plain version, kernel.

Port of video_segment_tpu/ops/tile_preseg.py (`tile_presegment`, Pallas
`_kernel`).  Inside every (8,128) tile of every frame, labels min-flood
for exactly `iters` Jacobi iterations over the in-tile N4 edges whose
colour distance is <= threshold: each iteration reads all four neighbour
labels from the start-of-iteration labelling, so a region longer than
`iters` pixels keeps label chains.  Tile-local roots become global voxel
ids (unpadded frame geometry) and `cc.pointer_jump` collapses the chains.

Out-of-frame pixels of a ragged edge tile are masked out (the JAX version
pads them with 1e6 colours, which no edge can join).  The distance is the
JAX kernel's float32 formula; the CUDA kernel (`csrc/tile_preseg.cu`, one
warp a tile, labels in registers) rounds each step like the plain version
and stops a tile at its first iteration that changes no label (the fixed
point, which every later iteration repeats), so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from video_segment_tpu_torch import _build
from video_segment_tpu_torch.ops import cc
from video_segment_tpu_torch.ops.tile_felz import (NPIX, TILE_H, TILE_W,
                                                   _dist32, _from_tiles,
                                                   _to_tiles)

_BIG = 2 ** 31 - 1      # "no neighbour" in the plain version's min
TILES_PER_CTA = 2       # WARPS in csrc/tile_preseg.cu: one warp a tile


def _global_ids(lab: torch.Tensor, t: int, h: int, w: int) -> torch.Tensor:
    """(NT,1024) tile-local root cells -> (T,H,W) int32 global voxel ids of
    the roots (unpadded geometry)."""
    nty, ntx = -(-h // TILE_H), -(-w // TILE_W)
    tid = torch.arange(lab.shape[0], device=lab.device)
    tt = tid // (nty * ntx)
    y0 = (tid // ntx) % nty * TILE_H
    x0 = tid % ntx * TILE_W
    labl = lab.long()
    gid = (tt[:, None] * (h * w) + (y0[:, None] + labl // TILE_W) * w
           + x0[:, None] + labl % TILE_W)
    return _from_tiles(gid.to(torch.int32), t, h, w)


def flood_plain(vol: torch.Tensor, threshold: float, metric: str,
                iters: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (T,H,W) int32 global voxel ids
    of the tile-local flood roots, chains not yet collapsed."""
    t, h, w, _ = vol.shape
    dev = vol.device
    col = _to_tiles(vol.float())                            # (NT,1024,3)
    inb = _to_tiles(torch.ones((t, h, w), dtype=torch.bool, device=dev),
                    fill=False)                             # (NT,1024)
    nt = col.shape[0]
    cols = torch.arange(NPIX, device=dev) % TILE_W
    # Admissible edges to the pixel below / to the right, at their upper /
    # left end (threshold compared in float32, as the JAX kernel does).
    thr = torch.tensor(threshold, dtype=torch.float32)
    down = torch.zeros((nt, NPIX), dtype=torch.bool, device=dev)
    right = torch.zeros_like(down)
    down[:, :-TILE_W] = ((_dist32(col[:, :-TILE_W], col[:, TILE_W:], metric)
                          <= thr) & inb[:, :-TILE_W] & inb[:, TILE_W:])
    right[:, :-1] = ((_dist32(col[:, :-1], col[:, 1:], metric) <= thr)
                     & inb[:, :-1] & inb[:, 1:] & (cols[:-1] < TILE_W - 1))
    up = torch.zeros_like(down)
    up[:, TILE_W:] = down[:, :-TILE_W]
    left = torch.zeros_like(down)
    left[:, 1:] = right[:, :-1]

    lab = torch.arange(NPIX, dtype=torch.int32, device=dev)[None] \
        .expand(nt, NPIX).contiguous()
    big = torch.full_like(lab, _BIG)
    for _ in range(iters):
        nb = torch.minimum(
            torch.minimum(
                torch.where(up, torch.roll(lab, TILE_W, 1), big),
                torch.where(down, torch.roll(lab, -TILE_W, 1), big)),
            torch.minimum(
                torch.where(left, torch.roll(lab, 1, 1), big),
                torch.where(right, torch.roll(lab, -1, 1), big)))
        lab = torch.minimum(lab, nb)
    return _global_ids(lab, t, h, w)


@functools.lru_cache(maxsize=64)
def flood_key(threshold: float) -> float:
    """The largest float32 q >= 0 whose correctly rounded float32 square
    root is <= float32(threshold) (-1 if there is none, +inf if every q
    qualifies).  The square root is monotone, so `sqrt32(q) <= threshold`
    holds exactly when `q <= flood_key(threshold)`: the kernel's l2 edge
    test needs no square root.  Found by bisection over the bit patterns of
    non-negative float32 values (ordered like the values), with NumPy's
    correctly rounded float32 square root."""
    thr = np.float32(threshold)

    def ok(bits: int) -> bool:
        return bool(np.sqrt(np.array(bits, np.int32).view(np.float32))
                    <= thr)

    lo, hi = 0, 0x7F800000                  # +0.0, +inf
    if not ok(lo):
        return -1.0
    if ok(hi):
        return float("inf")
    while hi - lo > 1:                      # ok(lo), not ok(hi)
        mid = (lo + hi) // 2
        if ok(mid):
            lo = mid
        else:
            hi = mid
    return float(np.array(lo, np.int32).view(np.float32))


def _collapse(roots: torch.Tensor) -> torch.Tensor:
    return cc.pointer_jump(roots.reshape(-1)).reshape(roots.shape)


def tile_presegment_plain(vol: torch.Tensor, threshold: float = 0.002,
                          metric: str = "l2", iters: int = 48
                          ) -> torch.Tensor:
    """Plain PyTorch version of `tile_presegment` (same signature and
    output), vectorized over all tiles of the volume."""
    return _collapse(flood_plain(vol, threshold, metric, iters))


# ---------------------------------------------------------------------------
# CUDA kernel wrapper.


def _lib():
    lib = _build.load("tile_preseg")
    if not getattr(lib, "_vst_typed", False):
        vp = ctypes.c_void_p
        ci = ctypes.c_int
        lib.tile_preseg_launch.argtypes = [vp, vp, vp, ci, ci, ci,
                                           ctypes.c_float, ci, ci, vp]
        lib.tile_preseg_launch.restype = ctypes.c_int
        lib._vst_typed = True
    return lib


def tile_presegment(vol: torch.Tensor, threshold: float = 0.002,
                    metric: str = "l2", iters: int = 48) -> torch.Tensor:
    """(T,H,W,3) float32 volume -> (T,H,W) int32 labels: global voxel ids
    of tile-local roots after `iters` flooding iterations, chains
    collapsed.  Pixels whose in-tile N4 colour distance is <= `threshold`
    share a label; everything else keeps its own voxel id.

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs
    `tile_presegment_plain`.
    """
    if vol.ndim != 4 or vol.shape[-1] != 3:
        raise ValueError(f"expected (T,H,W,3), got {tuple(vol.shape)}")
    if vol.dtype != torch.float32:
        raise TypeError(f"expected float32, got {vol.dtype}")
    if metric not in ("l1", "l2"):
        raise ValueError(f"unknown metric {metric!r}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if vol.device.type == "cpu":
        return tile_presegment_plain(vol, threshold, metric, iters)
    return _collapse(flood_kernel(vol, threshold, metric, iters))


def flood_kernel(vol: torch.Tensor, threshold: float, metric: str,
                 iters: int, tile_iters: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """Launch the CUDA kernel: `flood_plain`'s output, on the card.  With
    `tile_iters` (int32, one entry per (frame, tile) in row-major tile
    order), the kernel also writes how many iterations changed a label in
    each tile."""
    if vol.device.type != "cuda":
        raise ValueError(f"unsupported device {vol.device}")
    if not vol.is_contiguous():
        raise ValueError("vol must be contiguous")
    t, h, w, _ = vol.shape
    if t * h * w >= 2 ** 31:
        raise ValueError("volume too large for int32 voxel ids")
    n_tiles = t * -(-h // TILE_H) * -(-w // TILE_W)
    if tile_iters is not None and (
            tile_iters.device != vol.device or tile_iters.dtype != torch.int32
            or tile_iters.numel() != n_tiles
            or not tile_iters.is_contiguous()):
        raise ValueError(f"tile_iters must be {n_tiles} contiguous int32 on "
                         f"{vol.device}")
    out = torch.empty((t, h, w), dtype=torch.int32, device=vol.device)
    lib = _lib()
    with torch.cuda.device(vol.device):
        stream = torch.cuda.current_stream(vol.device).cuda_stream
        err = lib.tile_preseg_launch(
            vol.data_ptr(), out.data_ptr(),
            None if tile_iters is None else tile_iters.data_ptr(), t, h, w,
            float(threshold) if metric == "l1" else flood_key(threshold),
            int(metric == "l1"), int(iters), stream)
    if err:
        raise RuntimeError(f"tile_preseg kernel launch failed: CUDA error "
                           f"{err}")
    _build.count_launch(tile_presegment)
    return out


tile_presegment.launches = 0
