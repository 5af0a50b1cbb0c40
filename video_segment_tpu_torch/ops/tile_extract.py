"""Per-tile edge-key minima (K2): wrapper, plain version, kernel.

Port of video_segment_tpu/ops/tile_extract.py (`tile_reduce_min`, Pallas
`_kernel`).  After the tile pre-solve every (non-head) region is local to
one (8,128) tile and its label IS its root cell's (row % 8, col % 128), so
the edge-table extraction's per-(region, direction) minima of packed
(bucket << bits | partner) keys reduce inside the tile; the table then
gathers each slot's minima from its root cell.  Exact int32 work.
"""

from __future__ import annotations

import ctypes

import torch

from video_segment_tpu_torch import _build
from video_segment_tpu_torch.ops.tile_felz import TILE_H, TILE_W, NPIX

I32MAX = 2 ** 31 - 1


def tile_reduce_min_plain(labr: torch.Tensor, labc: torch.Tensor,
                          keys: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `tile_reduce_min`: one scatter-min over
    (direction, tile, cell) segments, then a gather at each pixel's cell."""
    d_cols, t, h, w = keys.shape
    dev = keys.device
    nty, ntx = -(-h // TILE_H), -(-w // TILE_W)
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    tiles = ((torch.arange(t, device=dev)[:, None, None] * nty + ys // TILE_H)
             * ntx + xs // TILE_W)                          # (T,H,W)
    n_seg = t * nty * ntx * NPIX
    ok = (labr >= 0) & (labr < TILE_H) & (labc >= 0) & (labc < TILE_W)
    seg = torch.where(ok, tiles * NPIX + labr.long() * TILE_W + labc.long(),
                      n_seg).reshape(-1)                    # n_seg: dump row
    table = torch.full((d_cols, n_seg + 1), I32MAX, dtype=torch.int32,
                       device=dev)
    table.scatter_reduce_(1, seg[None].expand(d_cols, -1),
                          keys.reshape(d_cols, -1), "amin")
    own = (tiles * NPIX + (ys % TILE_H) * TILE_W + xs % TILE_W).reshape(-1)
    return table[:, own].reshape(d_cols, t, h, w)


def _lib():
    lib = _build.load("tile_extract")
    if not getattr(lib, "_vst_typed", False):
        vp = ctypes.c_void_p
        ci = ctypes.c_int
        lib.tile_reduce_min_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci,
                                               ci, vp]
        lib.tile_reduce_min_launch.restype = ctypes.c_int
        lib._vst_typed = True
    return lib


def tile_reduce_min(labr: torch.Tensor, labc: torch.Tensor,
                    keys: torch.Tensor) -> torch.Tensor:
    """Per-(tile, label, direction) minima of packed edge keys.

    labr/labc: (T,H,W) int32 tile-local label of each pixel's region root
    (its root cell's row % 8 / col % 128).  keys: (D,T,H,W) int32 packed
    (bucket, partner), I32MAX where absent.  Returns (D,T,H,W) int32: at
    each region's root cell, the minimum key over the region's pixels for
    that direction; I32MAX at cells that root no region.

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs
    `tile_reduce_min_plain`.
    """
    if keys.ndim != 4 or labr.shape != keys.shape[1:] \
            or labc.shape != keys.shape[1:]:
        raise ValueError(f"shape mismatch: labr {tuple(labr.shape)}, labc "
                         f"{tuple(labc.shape)}, keys {tuple(keys.shape)}")
    for name, x in (("labr", labr), ("labc", labc), ("keys", keys)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if x.device != keys.device:
            raise ValueError(f"{name} on {x.device}, keys on {keys.device}")
    if keys.device.type == "cpu":
        return tile_reduce_min_plain(labr, labc, keys)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    if not (labr.is_contiguous() and labc.is_contiguous()
            and keys.is_contiguous()):
        raise ValueError("labr, labc and keys must be contiguous")
    d_cols, t, h, w = keys.shape
    out = torch.empty_like(keys)
    lib = _lib()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = lib.tile_reduce_min_launch(labr.data_ptr(), labc.data_ptr(),
                                         keys.data_ptr(), out.data_ptr(),
                                         d_cols, t, h, w, stream)
    if err:
        raise RuntimeError(f"tile_extract kernel launch failed: CUDA error "
                           f"{err}")
    _build.count_launch(tile_reduce_min)
    return out


tile_reduce_min.launches = 0
