"""Tile-local Felzenszwalb pre-solve (K1): wrapper, plain version, kernel.

Port of video_segment_tpu/ops/tile_felz.py (`tile_felzenszwalb`, Pallas
`_kernel` -> `_solve_subtile`).  Inside every (8,128) tile of every frame
it runs the reference's bucket-schedule merge semantics on in-tile N8
edges (segmentation_graph.h:339-463): ascending bucket levels, Boruvka
rounds with parity hooking and one pointer jump, the mean-colour gate,
eager / gated finalization, and a final chain resolution that
min-propagates the exported finalize levels.

The round structure follows the NumPy mirror `tile_felz_reference`
(ops/tile_felz.py:556-713), not the TPU's one-hot MXU formulation:
per-label colour sums are float64 (exact for <= 1024 f32 addends in
[0,1], so summation order cannot move a mean), region means and the merge
gate distance are float64, and edge buckets are the f32
`int(sqrt((d0*d0 + d1*d1 + d2*d2) * (1/3)) * 2048)` of the JAX kernel.
The CUDA kernel (`csrc/tile_felz.cu`) and `tile_felzenszwalb_plain`
compute the same values bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from video_segment_tpu_torch import _build

TILE_H = 8
TILE_W = 128
NPIX = TILE_H * TILE_W
NUM_BUCKETS = 2048
_BIG = 1 << 30           # "no candidate" (the mirror's BIG)
_OPEN = 2 ** 31 - 1      # fin-table identity (any value >= NUM_BUCKETS)
_MAX_LEVELS = 16         # schedule length the kernel's parameter block holds

# In-tile N8 directions as (dy, dx); every edge is proposed from both ends.
DIRS = ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1))


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt on any device (torch's vectorized CPU
    sqrt is not; a float64 sqrt rounded to float32 is)."""
    return torch.sqrt(x.double()).float()


def sqrt64(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float64 sqrt (CUDA's is; the CPU path uses
    NumPy's because torch's vectorized CPU sqrt is off by an ulp)."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _rounds(schedule, rounds_per_level) -> tuple:
    rounds = ((rounds_per_level,) * len(schedule)
              if isinstance(rounds_per_level, int)
              else tuple(rounds_per_level))
    if len(rounds) != len(schedule):
        raise ValueError(f"rounds_per_level {rounds} does not match "
                         f"schedule {schedule}")
    return rounds


# ---------------------------------------------------------------------------
# Plain PyTorch version (vectorized over tiles).


def _to_tiles(x: torch.Tensor, fill=0) -> torch.Tensor:
    """(T,H,W,...) -> (T*nty*ntx, 1024, ...) padded tiles."""
    t, h, w = x.shape[:3]
    rest = tuple(x.shape[3:])
    nty, ntx = -(-h // TILE_H), -(-w // TILE_W)
    pad = [0, 0] * len(rest) + [0, ntx * TILE_W - w, 0, nty * TILE_H - h]
    xp = F.pad(x, pad, value=fill) if any(pad) else x
    xp = xp.reshape(t, nty, TILE_H, ntx, TILE_W, *rest)
    xp = xp.permute(0, 1, 3, 2, 4, *range(5, 5 + len(rest)))
    return xp.reshape(t * nty * ntx, NPIX, *rest)


def _from_tiles(x: torch.Tensor, t: int, h: int, w: int) -> torch.Tensor:
    """Inverse of _to_tiles for (NT, 1024) planes."""
    nty, ntx = -(-h // TILE_H), -(-w // TILE_W)
    x = x.reshape(t, nty, ntx, TILE_H, TILE_W).permute(0, 1, 3, 2, 4)
    return x.reshape(t, nty * TILE_H, ntx * TILE_W)[:, :h, :w].contiguous()


def _neighbors(device):
    """Per direction: in-tile neighbor cell index (self where outside) and
    the in-tile mask, each (8, 1024)."""
    rows = torch.arange(TILE_H, device=device)[:, None].expand(TILE_H, TILE_W)
    cols = torch.arange(TILE_W, device=device)[None, :].expand(TILE_H, TILE_W)
    own = (rows * TILE_W + cols).reshape(-1)
    nbr, inside = [], []
    for dy, dx in DIRS:
        r2, c2 = rows + dy, cols + dx
        ok = ((r2 >= 0) & (r2 < TILE_H) & (c2 >= 0) & (c2 < TILE_W)).reshape(-1)
        q = (r2 * TILE_W + c2).reshape(-1)
        nbr.append(torch.where(ok, q, own))
        inside.append(ok)
    return torch.stack(nbr), torch.stack(inside)


def _dist32(a, b, metric):
    d0, d1, d2 = (a[..., i] - b[..., i] for i in range(3))
    if metric == "l1":
        return (d0.abs() + d1.abs() + d2.abs()) * (1.0 / 3.0)
    return sqrt32((d0 * d0 + d1 * d1 + d2 * d2) * (1.0 / 3.0))


def _dist64(a, b, metric):
    d0, d1, d2 = (a[..., i] - b[..., i] for i in range(3))
    if metric == "l1":
        return (d0.abs() + d1.abs() + d2.abs()) / 3.0
    return sqrt64((d0 * d0 + d1 * d1 + d2 * d2) / 3.0)


def tile_felzenszwalb_plain(vol: torch.Tensor,
                            schedule: tuple = (4, 32, 192, 1024),
                            rounds_per_level: int | tuple = 2,
                            merge_threshold: float = 0.05,
                            metric: str = "l2",
                            fin_margin: float = 1.0,
                            fin_eager: bool = False,
                            fin_gated: bool = False,
                            pair_merge: bool = False,
                            gate_tests: list | None = None):
    """Plain PyTorch version of `tile_felzenszwalb` (same signature and
    outputs), vectorized over all tiles of the volume.  Where `gate_tests`
    is a list, the number of merge tests of each scan (edges within the
    level's threshold between two different labels, past the fin gate:
    the float64 mean distances the kernel computes) is appended to it."""
    t, h, w, _ = vol.shape
    dev = vol.device
    rounds = _rounds(schedule, rounds_per_level)
    col = _to_tiles(vol.float())                            # (NT,1024,3)
    inb = _to_tiles(torch.ones((t, h, w), dtype=torch.bool, device=dev),
                    fill=False)                             # (NT,1024)
    nt = col.shape[0]
    nbr, inside = _neighbors(dev)
    base = (torch.arange(nt, device=dev) * NPIX)[:, None]
    own = torch.arange(NPIX, device=dev)[None].expand(nt, NPIX)
    col64 = col.double()
    strong_thr = merge_threshold * fin_margin

    buckets, valids = [], []
    for k in range(len(DIRS)):
        q = nbr[k]
        d = _dist32(col, col[:, q], metric)
        buckets.append(torch.clamp((d * NUM_BUCKETS).to(torch.int32), 0,
                                   NUM_BUCKETS - 1))
        valids.append(inb & inb[:, q] & inside[k][None])

    def seg_min(vals, lab, init):
        out = torch.full((nt * NPIX,), init, dtype=torch.int32, device=dev)
        out.scatter_reduce_(0, (base + lab).reshape(-1),
                            vals.reshape(-1).to(torch.int32), "amin")
        return out.reshape(nt, NPIX)

    def label_sums(lab):
        seg = (base + lab)[inb]
        size = torch.zeros(nt * NPIX, dtype=torch.float64, device=dev)
        size.index_add_(0, seg, torch.ones_like(seg, dtype=torch.float64))
        csum = torch.zeros((nt * NPIX, 3), dtype=torch.float64, device=dev)
        csum.index_add_(0, seg, col64[inb])
        return size.reshape(nt, NPIX), csum.reshape(nt, NPIX, 3)

    def mean_px(lab):
        size, csum = label_sums(lab)
        mean = csum / torch.clamp(size, min=1.0)[..., None]
        return torch.gather(mean, 1, lab[..., None].expand(nt, NPIX, 3))

    def scan(lab, fin, theta, gated):
        """Per pixel: min (bucket<<10 | nb_label) admissible candidate,
        and min failing / strongly failing bucket of the tested edges."""
        mp = mean_px(lab)
        fin_px = torch.gather(fin, 1, lab)
        best = torch.full_like(lab, _BIG)
        fail = torch.full_like(lab, _OPEN)
        strong = torch.full_like(lab, _OPEN)
        n_tests = 0
        for k in range(len(DIRS)):
            q = nbr[k]
            bkt = buckets[k]
            nb_lab = lab[:, q]
            dd = _dist64(mp, mp[:, q], metric)
            act = valids[k] & (bkt <= theta) & (nb_lab != lab)
            if gated:
                act = act & (bkt < fin_px) & (bkt < fin_px[:, q])
            if gate_tests is not None:
                n_tests += int(act.sum())
            best = torch.minimum(best, torch.where(
                act & (dd < merge_threshold), (bkt << 10) | nb_lab, _BIG))
            fail = torch.minimum(fail, torch.where(
                act & (dd >= merge_threshold), bkt, _OPEN))
            strong = torch.minimum(strong, torch.where(
                act & (dd >= strong_thr), bkt, _OPEN))
        if gate_tests is not None:
            gate_tests.append(n_tests)
        return best, fail, strong

    lab = own.to(torch.int32).clone()
    fin = torch.full((nt, NPIX), _OPEN, dtype=torch.int32, device=dev)
    fin_x = fin.clone()
    own32 = own.to(torch.int32)
    for lvl, theta in enumerate(schedule):
        for rnd in range(rounds[lvl]):
            # Merge candidates are always gated by fin (the mirror's adm).
            best, fail, strong = scan(lab, fin, theta, gated=True)
            if fin_eager:
                fin = seg_min(torch.minimum(fail, fin), lab, _OPEN)
                fin_x = seg_min(torch.minimum(strong, fin_x), lab, _OPEN)
            best_t = seg_min(best, lab, _BIG)
            partner = best_t & (NPIX - 1)
            have = best_t < _BIG
            hook = have & ((partner > own32) == (rnd % 2 == 0))
            if pair_merge:
                hook = hook & ~torch.gather(hook, 1, partner.long())
            parent = torch.where(hook, partner, own32).long()
            parent = torch.gather(parent, 1, parent)
            lab = torch.gather(parent, 1, lab.long()).to(torch.int32)
        _, fail, strong = scan(lab, fin, theta, gated=fin_gated)
        if fin_eager:
            fin = seg_min(torch.minimum(fail, fin), lab, _OPEN)
            fin_x = seg_min(torch.minimum(strong, fin_x), lab, _OPEN)
        else:
            fin = torch.minimum(fin, seg_min(fail, lab, _OPEN))
            fin_x = torch.minimum(fin_x, seg_min(strong, lab, _OPEN))

    # Chain resolution, min-propagating exported fins along the pointers.
    while True:
        fin_x = seg_min(fin_x, lab, _OPEN)
        nf = torch.gather(lab, 1, lab.long())
        done = torch.equal(nf, lab)
        lab = nf
        if done:
            break

    size, csum = label_sums(lab)
    fin_out = torch.clamp(torch.gather(fin_x, 1, lab.long()),
                          max=NUM_BUCKETS)
    nty, ntx = -(-h // TILE_H), -(-w // TILE_W)
    tid = torch.arange(nt, device=dev)
    tt = tid // (nty * ntx)
    y0 = (tid // ntx) % nty * TILE_H
    x0 = tid % ntx * TILE_W
    labl = lab.long()
    gid = (tt[:, None] * (h * w) + (y0[:, None] + labl // TILE_W) * w
           + x0[:, None] + labl % TILE_W)
    stats = (size.float(), csum[..., 0].float(), csum[..., 1].float(),
             csum[..., 2].float())
    return (_from_tiles(gid.to(torch.int32), t, h, w),
            _from_tiles(fin_out, t, h, w),
            tuple(_from_tiles(s, t, h, w) for s in stats))


# ---------------------------------------------------------------------------
# CUDA kernel wrapper.


@functools.lru_cache(maxsize=64)
def gate_key(threshold: float, metric: str) -> float:
    """The least float64 key k >= 0 whose gate distance reaches
    `threshold`, where the distance is sqrt(k / 3) for "l2" (k the sum of
    squared mean differences) and k / 3 for "l1" (k the sum of absolute
    differences), each operation rounded to nearest.  Both are monotone in
    k, so `distance < threshold` holds exactly when `k < gate_key`: the
    kernel's gate needs no divide or square root.  Found by bisection over
    the bit patterns of non-negative float64 values (ordered like the
    values), with NumPy's correctly rounded division and square root."""
    def dist(bits: int) -> float:
        d = np.array(bits, np.int64).view(np.float64) / 3.0
        return float(np.sqrt(d) if metric == "l2" else d)

    lo, hi = 0, 0x7FF0000000000000          # +0.0, +inf
    if dist(lo) >= threshold:
        return 0.0
    while hi - lo > 1:                      # dist(lo) < threshold <= dist(hi)
        mid = (lo + hi) // 2
        if dist(mid) >= threshold:
            hi = mid
        else:
            lo = mid
    return float(np.array(hi, np.int64).view(np.float64))


class _Params(ctypes.Structure):
    """Mirror of `FelzParams` in csrc/tile_felz.cu."""
    _fields_ = [("schedule", ctypes.c_int * _MAX_LEVELS),
                ("rounds", ctypes.c_int * _MAX_LEVELS),
                ("n_levels", ctypes.c_int),
                ("metric_l1", ctypes.c_int),
                ("fin_eager", ctypes.c_int),
                ("fin_gated", ctypes.c_int),
                ("pair_merge", ctypes.c_int),
                ("merge_key", ctypes.c_double),
                ("strong_key", ctypes.c_double)]


def _lib():
    lib = _build.load("tile_felz")
    if not getattr(lib, "_vst_typed", False):
        vp = ctypes.c_void_p
        lib.tile_felz_launch.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int,
                                         ctypes.POINTER(_Params), vp]
        lib.tile_felz_launch.restype = ctypes.c_int
        lib._vst_typed = True
    return lib


def tile_felzenszwalb(vol: torch.Tensor,
                      schedule: tuple = (4, 32, 192, 1024),
                      rounds_per_level: int | tuple = 2,
                      merge_threshold: float = 0.05,
                      metric: str = "l2",
                      fin_margin: float = 1.0,
                      fin_eager: bool = False,
                      fin_gated: bool = False,
                      pair_merge: bool = False):
    """(T,H,W,3) float32 volume -> (labels, fin, (size, c0, c1, c2)).

    labels: (T,H,W) int32 global voxel id of each pixel's in-tile region
    root (self-rooted).  fin: (T,H,W) int32 finalize level of the pixel's
    region (minimum bucket of a strong failed merge test; NUM_BUCKETS =
    open).  Stats: (T,H,W) float32 voxel count and colour sums of each
    region, stored at the region's root cell (0 elsewhere).

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs
    `tile_felzenszwalb_plain`.
    """
    if vol.ndim != 4 or vol.shape[-1] != 3:
        raise ValueError(f"expected (T,H,W,3), got {tuple(vol.shape)}")
    if vol.dtype != torch.float32:
        raise TypeError(f"expected float32, got {vol.dtype}")
    if metric not in ("l1", "l2"):
        raise ValueError(f"unknown metric {metric!r}")
    rounds = _rounds(schedule, rounds_per_level)
    kw = dict(schedule=schedule, rounds_per_level=rounds_per_level,
              merge_threshold=merge_threshold, metric=metric,
              fin_margin=fin_margin, fin_eager=fin_eager,
              fin_gated=fin_gated, pair_merge=pair_merge)
    if vol.device.type == "cpu":
        return tile_felzenszwalb_plain(vol, **kw)
    if vol.device.type != "cuda":
        raise ValueError(f"unsupported device {vol.device}")
    if len(schedule) > _MAX_LEVELS:
        raise ValueError(f"schedule longer than {_MAX_LEVELS} levels")
    if not vol.is_contiguous():
        raise ValueError("vol must be contiguous")
    t, h, w, _ = vol.shape
    if t * h * w >= 2 ** 31:
        raise ValueError("volume too large for int32 voxel ids")
    prm = _Params()
    for i, (th, r) in enumerate(zip(schedule, rounds)):
        prm.schedule[i] = int(th)
        prm.rounds[i] = int(r)
    prm.n_levels = len(schedule)
    prm.metric_l1 = int(metric == "l1")
    prm.fin_eager = int(fin_eager)
    prm.fin_gated = int(fin_gated)
    prm.pair_merge = int(pair_merge)
    prm.merge_key = gate_key(float(merge_threshold), metric)
    prm.strong_key = gate_key(float(merge_threshold * fin_margin), metric)
    labels = torch.empty((t, h, w), dtype=torch.int32, device=vol.device)
    fin = torch.empty_like(labels)
    stats = tuple(torch.empty((t, h, w), dtype=torch.float32,
                              device=vol.device) for _ in range(4))
    lib = _lib()
    with torch.cuda.device(vol.device):
        stream = torch.cuda.current_stream(vol.device).cuda_stream
        err = lib.tile_felz_launch(
            vol.data_ptr(), labels.data_ptr(), fin.data_ptr(),
            *(s.data_ptr() for s in stats), t, h, w, ctypes.byref(prm),
            stream)
    if err:
        raise RuntimeError(f"tile_felz kernel launch failed: CUDA error {err}")
    _build.count_launch(tile_felzenszwalb)
    return labels, fin, stats


tile_felzenszwalb.launches = 0
