"""Supertile-table merge rounds (K3): wrapper, plain version, kernel.

Port of video_segment_tpu/ops/tile_table.py (`tile_table_rounds`, Pallas
`_kernel`; oracle `blocked_rounds_reference`) and its XLA helper
`blocked_layout`.  The solve's table slots are re-blocked per (st_h, st_w)
supertile of the chunk volume (slots of one supertile contiguous, in
global-id order), and one launch runs a whole gated schedule level's
Boruvka rounds for every supertile: statistics re-aggregate from the seed
slots every round, each slot's top-K edges come from planes that hold only
same-supertile partners, the best admissible (bucket, partner root) per
region wins by packed key, roots hook by alternating parity and pointer
jumping resolves the chains.  A supertile stops when a round finds no
candidate, after two rounds that moved nothing, or after `rounds` rounds.

Per-label colour sums are float64 (one sum per label, rounded to float32,
then divided by the float32 size): float64 sums of the seeds' float32
statistics are exact, so neither the kernel's atomic order nor its
carrying of the sums from round to round (a moving label adds its sums to
its new root) can move a mean, and the CUDA kernel (`csrc/tile_table.cu`)
and `tile_table_rounds_plain` agree bit for bit.  A region is blocked iff
its root slot is (blocked regions never merge, so that is the region's
flag).
Packed keys are int32 `bucket << 12 | partner` (the TPU kernel's float
packing was an artefact of its one-hot contractions), hence at most 4096
slots per supertile.
"""

from __future__ import annotations

import ctypes

import torch

from video_segment_tpu_torch import _build
from video_segment_tpu_torch.ops.tile_felz import sqrt32

L = 128            # lane width of the (SR, 128) slot grid
NUM_BUCKETS = 2048
PBITS = 12         # partner bits of packed (bucket << PBITS | partner) keys
MAX_SLOTS = 1 << PBITS
MAX_K = 32         # edges a slot (the kernel's live-edge mask has 32 bits)
I32MAX = 2 ** 31 - 1


def blocked_layout(sup: torch.Tensor, n_sup: int, s_cap: int):
    """Order-preserving per-supertile blocking of table slots.

    sup: (nseg,) int32 supertile id per slot (the sink slot carries an id
    >= n_sup).  Returns (g2b, b2g): g2b (nseg,) int32 blocked position per
    slot (-1 if the slot overflowed its supertile's `s_cap` or sup >=
    n_sup); b2g (n_sup*s_cap,) int32 global slot per blocked position
    (nseg-1, the sink, where empty).  Equal to the JAX `blocked_layout`.
    """
    nseg = sup.shape[0]
    dev = sup.device
    order = torch.argsort(sup, stable=True)
    sorted_sup = sup[order].to(torch.int32)
    starts = torch.searchsorted(
        sorted_sup, torch.arange(n_sup, dtype=torch.int32, device=dev))
    rank = torch.arange(nseg, device=dev) - starts[
        torch.clamp(sorted_sup, max=n_sup - 1).long()]
    ok = (rank < s_cap) & (sorted_sup < n_sup)
    dump = n_sup * s_cap
    blk = torch.where(ok, sorted_sup.long() * s_cap + rank, dump)
    g2b = torch.full((nseg,), -1, dtype=torch.int32, device=dev)
    g2b[order] = torch.where(ok, blk, -1).to(torch.int32)
    b2g = torch.full((dump + 1,), nseg - 1, dtype=torch.int32, device=dev)
    b2g[blk] = order.to(torch.int32)
    return g2b, b2g[:-1]


def _dist(a, b, metric):
    d0, d1, d2 = (a[..., i] - b[..., i] for i in range(3))
    if metric == "l1":
        return (d0.abs() + d1.abs() + d2.abs()) * (1.0 / 3.0)
    return sqrt32((d0 * d0 + d1 * d1 + d2 * d2) * (1.0 / 3.0))


def tile_table_rounds_plain(labr, labc, size, c0, c1, c2, fin, blocked,
                            edges, *, theta: int, rounds: int,
                            merge_threshold: float,
                            force_merge_weight: float, metric: str):
    """Plain PyTorch version of `tile_table_rounds` (same arguments and
    outputs): `blocked_rounds_reference` batched over the supertiles, each
    frozen once it has finished its rounds."""
    n, sr, _ = labr.shape
    s = sr * L
    k = edges.shape[1]
    dev = labr.device
    lab = (labr.long() * L + labc.long()).reshape(n, s)
    base = (torch.arange(n, device=dev) * s)[:, None]
    seeds = torch.stack([size, c0, c1, c2], -1).reshape(n * s, 4).double()
    fin_f = fin.reshape(n * s).to(torch.int32)
    blk = (blocked.reshape(n * s) != 0)
    e = edges.reshape(n, k, s)
    valid = e != I32MAX
    bkt = torch.where(valid, e >> PBITS, NUM_BUCKETS)
    ptn = torch.clamp(e & (MAX_SLOTS - 1), max=s - 1).long()
    w_eff = bkt.to(torch.float32) * (1.0 / NUM_BUCKETS)
    slots = torch.arange(s, device=dev)[None]
    idle = torch.zeros(n, dtype=torch.int64, device=dev)
    for i in range(rounds):
        act = idle < 2
        if not bool(act.any()):
            break
        seg = (base + lab).reshape(-1)
        sums = torch.zeros((n * s, 4), dtype=torch.float64, device=dev) \
            .index_add_(0, seg, seeds).float()
        mean = sums[:, 1:4] / torch.clamp(sums[:, 0], min=1.0)[:, None]
        fin_t = torch.full((n * s,), I32MAX, dtype=torch.int32, device=dev) \
            .scatter_reduce_(0, seg, fin_f, "amin")
        om = mean[seg].reshape(n, 1, s, 3)
        ofin = fin_t[seg].reshape(n, 1, s)
        oblk = blk[seg].reshape(n, 1, s)
        a2 = torch.gather(lab, 1, ptn.reshape(n, k * s)).reshape(n, k, s)
        a2g = (base[:, :, None] + a2).reshape(-1)
        nm = mean[a2g].reshape(n, k, s, 3)
        nfin = fin_t[a2g].reshape(n, k, s)
        nblk = blk[a2g].reshape(n, k, s)
        d = _dist(om, nm, metric)
        d = torch.where((w_eff < force_merge_weight) & (d < 0.2),
                        torch.zeros_like(d), d)
        adm = (valid & (bkt <= theta) & (a2 != lab[:, None, :])
               & (bkt < ofin) & (bkt < nfin) & (d < merge_threshold)
               & ~oblk & ~nblk)
        pk = torch.where(adm, (bkt.long() << PBITS) | a2, I32MAX)
        best = pk.min(dim=1).values.reshape(-1)
        best_t = torch.full((n * s,), I32MAX, dtype=torch.int64, device=dev) \
            .scatter_reduce_(0, seg, best, "amin").reshape(n, s)
        have = best_t < I32MAX
        p_t = best_t & (MAX_SLOTS - 1)
        hook = have & ((p_t > slots) == (i % 2 == 0))
        parent = torch.where(hook, p_t, slots)
        while True:
            nxt = torch.gather(parent, 1, parent)
            if torch.equal(nxt, parent):
                break
            parent = nxt
        new_lab = torch.gather(parent, 1, lab)
        moved = (new_lab != lab).any(dim=1)
        new_idle = torch.where(~have.any(dim=1), 2,
                               torch.where(moved, 0, idle + 1))
        lab = torch.where(act[:, None], new_lab, lab)
        idle = torch.where(act, new_idle, idle)
    lab = lab.reshape(n, sr, L)
    return (lab // L).to(torch.int32), (lab % L).to(torch.int32)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper.


class _Params(ctypes.Structure):
    """Mirror of `TableParams` in csrc/tile_table.cu."""
    _fields_ = [("theta", ctypes.c_int),
                ("rounds", ctypes.c_int),
                ("metric_l1", ctypes.c_int),
                ("merge_threshold", ctypes.c_float),
                ("force_merge_weight", ctypes.c_float)]


def _lib():
    lib = _build.load("tile_table")
    if not getattr(lib, "_vst_typed", False):
        vp = ctypes.c_void_p
        ci = ctypes.c_int
        lib.tile_table_launch.argtypes = [vp] * 11 + [
            ci, ci, ci, ctypes.POINTER(_Params), vp]
        lib.tile_table_launch.restype = ctypes.c_int
        lib._vst_typed = True
    return lib


def tile_table_rounds(labr, labc, size, c0, c1, c2, fin, blocked, edges,
                      *, theta: int, rounds: int, merge_threshold: float,
                      force_merge_weight: float, metric: str):
    """One gated level's merge rounds over blocked supertile tables.

    All (N, SR, 128) except edges (N, K, SR, 128): labr/labc int32 local
    root (row, column) per slot, size/c0..c2 float32 seed statistics, fin
    int32 finalize level of each slot's region, blocked int32 (1 = the
    slot's region may not merge; read at the root slot), edges int32 packed
    bucket << 12 | partner slot (I32MAX absent; cross-supertile edges
    already absent).  SR * 128 <= 4096, K <= 32.  Returns (labr, labc)
    after the rounds.

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs
    `tile_table_rounds_plain`.
    """
    if labr.ndim != 3 or labr.shape[2] != L:
        raise ValueError(f"expected (N, SR, {L}) planes, got "
                         f"{tuple(labr.shape)}")
    n, sr, _ = labr.shape
    if sr * L > MAX_SLOTS:
        raise ValueError(f"{sr * L} slots per supertile exceed the packable "
                         f"{MAX_SLOTS}")
    if edges.ndim != 4 or edges.shape[0] != n or edges.shape[2:] != (sr, L):
        raise ValueError(f"edges {tuple(edges.shape)} do not match planes "
                         f"{tuple(labr.shape)}")
    planes = dict(labr=labr, labc=labc, size=size, c0=c0, c1=c1, c2=c2,
                  fin=fin, blocked=blocked)
    for name, x in planes.items():
        if x.shape != labr.shape:
            raise ValueError(f"{name} {tuple(x.shape)} != {tuple(labr.shape)}")
        want = torch.float32 if name in ("size", "c0", "c1", "c2") \
            else torch.int32
        if x.dtype != want:
            raise TypeError(f"{name} must be {want}, got {x.dtype}")
    if edges.dtype != torch.int32:
        raise TypeError(f"edges must be int32, got {edges.dtype}")
    if edges.shape[1] > MAX_K:
        raise ValueError(f"{edges.shape[1]} edges a slot exceed {MAX_K}")
    for name, x in (*planes.items(), ("edges", edges)):
        if x.device != labr.device:
            raise ValueError(f"{name} on {x.device}, labr on {labr.device}")
    if metric not in ("l1", "l2"):
        raise ValueError(f"unknown metric {metric!r}")
    kw = dict(theta=theta, rounds=rounds, merge_threshold=merge_threshold,
              force_merge_weight=force_merge_weight, metric=metric)
    if labr.device.type == "cpu":
        return tile_table_rounds_plain(labr, labc, size, c0, c1, c2, fin,
                                       blocked, edges, **kw)
    if labr.device.type != "cuda":
        raise ValueError(f"unsupported device {labr.device}")
    if not all(x.is_contiguous() for x in (*planes.values(), edges)):
        raise ValueError("all inputs must be contiguous")
    prm = _Params(theta=int(theta), rounds=int(rounds),
                  metric_l1=int(metric == "l1"),
                  merge_threshold=float(merge_threshold),
                  force_merge_weight=float(force_merge_weight))
    outr = torch.empty_like(labr)
    outc = torch.empty_like(labc)
    lib = _lib()
    with torch.cuda.device(labr.device):
        stream = torch.cuda.current_stream(labr.device).cuda_stream
        err = lib.tile_table_launch(
            *(x.data_ptr() for x in planes.values()), edges.data_ptr(),
            outr.data_ptr(), outc.data_ptr(), n, sr, edges.shape[1],
            ctypes.byref(prm), stream)
    if err:
        raise RuntimeError(f"tile_table kernel launch failed: CUDA error "
                           f"{err}")
    _build.count_launch(tile_table_rounds)
    return outr, outc


tile_table_rounds.launches = 0
