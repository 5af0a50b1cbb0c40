"""Over-segmentation solver: the bucketized region merging, in PyTorch
(the edge-table solver, and the v1 pixel solver).

Port of video_segment_tpu/core/oversegmentation.py (see its module
docstring for the semantics): ascending bucket-threshold schedule levels,
Boruvka merge rounds to a fixed point over an O(regions) edge table, the
mean-colour gate with the force-merge shortcut, level-end finalization /
unconstraining, min-region-size forcing and the final constraint
association.  Scope: the edge-table solver (spatial + temporal
directions, the temporal ones displaced along backward optical flow when a
flow volume is given), monolithic or split into row bands (`bands>1`: the
pixel phases run one band at a time, a boundary pass restores the
adjacency across the seams, the table phases run on the glued global
table), with the supertile-gated early levels
(`st_levels>0`) either as K3 launches (`ops/tile_table`, the default) or
as masked global rounds (`st_kernel=False`).  The two admit the same
merges; they differ only in the float order of the region statistics, in
seeds beyond `st_slots` (unmerged in K3) and in a table recompaction that
falls inside the gated levels (the masked rounds then see the shrunk
table's top-K edges).  Every off-default knob runs: the variance
descriptor, the gradient trait (`ops/pixel_distance`) and the two-stage
solve's spatial pre-pass, each with the masked rounds for gated levels as
in the JAX package.  The v1 pixel solver (`edge_table=False`,
`_solve_pixel`) folds the stencil over the voxels in every round, compacts
its region slots after `compact_after_levels` levels, and refuses the
descriptor traits and the gradient trait as the JAX package does.

JAX's segment reductions become `scatter_reduce_` / `index_add_` into
tensors pre-filled with the same empty-segment identities (INT32_MAX /
+inf for minima, INT32_MIN for maxima); its `while_loop` merge rounds
become Python loops whose exit tests sync with the device once per round.
Packed (bucket << bits | partner) keys stay int32.  Gathers by sentinel or
partner values are clamped exactly where the JAX code clamps.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from video_segment_tpu_torch.ops import cc
from video_segment_tpu_torch.ops import pixel_distance as pd
from video_segment_tpu_torch.ops.histograms import _fma
from video_segment_tpu_torch.ops.tile_felz import sqrt32

NUM_BUCKETS = 2048
I32MAX = 2 ** 31 - 1
I32MIN = -2 ** 31

SPATIAL_FWD = ((0, 1), (1, 0), (1, -1), (1, 1))
SPATIAL_ALL = SPATIAL_FWD + ((0, -1), (-1, 0), (-1, 1), (-1, -1))
TEMPORAL_DIRS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))

MODE_MERGE = 0
MODE_MIN_SIZE = 1

class OversegParams(NamedTuple):
    """Solver parameters; fields and defaults identical to the JAX
    package's OversegParams (see its comments for each knob)."""
    merge_threshold: float = 0.05
    split_threshold: float = 0.15
    force_merge_weight: float = 0.001
    min_region_size: int = 100
    metric: str = "l2"
    max_constraints: int = 1 << 16
    descriptor: str = "color_mean"
    gradient_trait: bool = False
    aggregator: str = "independent"
    linear_weight: float = 0.5
    schedule: tuple = (4, 16, 48, 128, 256, 512, 896, 1408, 2047)
    max_rounds_per_level: int = 5
    max_final_rounds: int = 12
    min_size_rounds: int = 12
    compact_after_levels: int = 1
    compact_divisor: int = 2
    two_stage: bool = False
    edge_table: bool = True
    edge_topk: int = 12
    table_divisor: int = 8
    preseg_threshold: float = 0.01
    table_slots: int = 0
    bands: int = 1
    band_table_slots: int = 0
    bands_vmap: bool = False
    preseg_schedule: tuple = (4, 32, 96)
    carry_preseg_fin: bool = True
    preseg_fin_margin: float = 1.0
    min_size_interleave: int = 0
    fin_every_round: bool = False
    preseg_fin_eager: bool = True
    preseg_fin_gated: bool = True
    preseg_rounds_per_level: int | tuple = 2
    preseg_pair_merge: bool = False
    pair_merge: bool = False
    pair_merge_minsize: bool = False
    st_levels: int = 0
    st_h: int = 64
    st_w: int = 256
    st_kernel: bool | None = None
    st_slots: int = 4096
    # None = auto: the tile kernel (ops/tile_extract) whenever the preseg's
    # init labels and slot roots exist (the JAX package picks it on TPU).
    extract_tile: bool | None = None


def params_from_jax(p) -> OversegParams:
    """Map a JAX OversegParams (or its `_asdict()`, values numpy or
    python) to the port's OversegParams."""
    d = p._asdict() if hasattr(p, "_asdict") else dict(p)
    out = {}
    for name in OversegParams._fields:
        if name not in d:
            continue
        v = d[name]
        if isinstance(v, np.ndarray):
            v = tuple(v.tolist()) if v.ndim else v.item()
        elif isinstance(v, np.generic):
            v = v.item()
        elif isinstance(v, list):
            v = tuple(v)
        out[name] = v
    return OversegParams(**out)


class SolverState(NamedTuple):
    label: torch.Tensor   # (N,) int32: root slot per slot / voxel
    csum: torch.Tensor    # (N,3) f32: color sums at root slots
    size: torch.Tensor    # (N,)  f32: voxel counts at root slots
    constr: torch.Tensor  # (N,)  int32: compact constraint id, -1 free
    fin: torch.Tensor     # (N,)  int32: finalize level (NUM_BUCKETS open)
    frozen: torch.Tensor  # (N,)  bool: virtual-node role
    # (N,3) f32 color square sums under the variance descriptor, else None
    # (the JAX package carries zeros there).
    sqsum: torch.Tensor | None = None
    # (N,2) f32 sign-normalized gradient sums under the gradient trait.
    gsum: torch.Tensor | None = None


class OversegResult(NamedTuple):
    """Solver output (slot-spaced region attributes; see the JAX
    OversegResult).  `label16` holds the final slot per voxel as int32 in
    this port (the JAX package ships it as uint16 for its host link)."""
    label: torch.Tensor
    constr: torch.Tensor
    size: torch.Tensor
    orig: torch.Tensor
    label16: torch.Tensor | None = None
    lut: torch.Tensor | None = None
    nsink: torch.Tensor | None = None
    # Per schedule level [table cap (the v1 solver: its segment-domain
    # size), merge rounds used, live regions after the level] (always
    # filled: the round loop syncs anyway).
    diag: np.ndarray | None = None


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def region_attrs(res: OversegResult, roots):
    """(constr, size) for original-root ids `roots`.  Roots with no live
    slot (sink overflow) come back unconstrained with size 0."""
    orig = _np(res.orig)
    order = np.argsort(orig)
    so = orig[order]
    pos = np.minimum(np.searchsorted(so, roots), len(so) - 1)
    ok = so[pos] == roots
    idx = order[pos]
    constr = np.where(ok, _np(res.constr)[idx], -1)
    size = np.where(ok, _np(res.size)[idx], 0.0)
    return constr, size


# ---------------------------------------------------------------------------
# Segment reductions with JAX's empty-segment identities.


def _arange(n, like):
    return torch.arange(n, dtype=torch.int32, device=like.device)


def seg_min(data, ids, n, identity=I32MAX):
    out = torch.full((n,) + tuple(data.shape[1:]), identity,
                     dtype=data.dtype, device=data.device)
    idx = ids.long()
    if data.ndim > 1:
        idx = idx.reshape(-1, *([1] * (data.ndim - 1))).expand_as(data)
    return out.scatter_reduce_(0, idx, data, "amin")


def seg_max(data, ids, n, identity=I32MIN):
    out = torch.full((n,) + tuple(data.shape[1:]), identity,
                     dtype=data.dtype, device=data.device)
    return out.scatter_reduce_(0, ids.long(), data, "amax")


def seg_sum(data, ids, n):
    out = torch.zeros((n,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, ids, data)


def _take(table, idx):
    """table[idx] for any-shaped int idx (JAX-style row gather)."""
    flat = table.index_select(0, idx.reshape(-1))
    return flat.reshape(tuple(idx.shape) + tuple(table.shape[1:]))


# ---------------------------------------------------------------------------
# Distances, buckets, stencil directions.


def _dist(a, b, metric):
    d = a - b
    d0, d1, d2 = d[..., 0], d[..., 1], d[..., 2]
    if metric == "l1":
        return (d0.abs() + d1.abs() + d2.abs()) * (1.0 / 3.0)
    return sqrt32((d0 * d0 + d1 * d1 + d2 * d2) * (1.0 / 3.0))


def _bucketize(d):
    return torch.clamp((d * NUM_BUCKETS).to(torch.int32), 0,
                       NUM_BUCKETS - 1)


def _shift_dir_list(temporal_undisplaced: bool, spatial_dirs=SPATIAL_FWD,
                    temporal_fwd: bool = False):
    """[(dt,dy,dx)] of the shift-expressible directions: `spatial_dirs`,
    plus every backward temporal one when the volume has more than one
    frame and no flow (with flow they are displaced: `_fold_dirs_raw`),
    plus every forward temporal one, undisplaced even with flow, when
    `temporal_fwd` (the pixel solver's level-end view, as in the JAX
    package)."""
    dirs = [(0, dy, dx) for dy, dx in spatial_dirs]
    if temporal_undisplaced:
        dirs += [(-1, dy, dx) for dy, dx in TEMPORAL_DIRS]
    if temporal_fwd:
        dirs += [(1, dy, dx) for dy, dx in TEMPORAL_DIRS]
    return dirs


class _RawDir(NamedTuple):
    """One direction's raw neighbor view (all (T,H,W)-shaped); `temporal`
    says whether the direction crosses frames."""
    valid: torch.Tensor
    bucket: torch.Tensor
    nb_label: torch.Tensor
    temporal: bool


def _fold_dirs_raw(feats, label3, metric, fold_fn, carry, flow=None,
                   pair_dist=None, spatial_dirs=SPATIAL_FWD,
                   temporal_fwd: bool = False):
    """Fold `fold_fn(carry, _RawDir) -> carry` over every incident
    direction: the shift-expressible ones (`_shift_dir_list`: by default
    the forward spatial and the backward temporal directions the edge
    extraction reads) as halo-padded views of the (T,H,W,C) feature volume,
    then, with `flow` ((T-1,H,W,2) backward flow of frames 1..T-1), the
    nine flow-displaced backward directions, in TEMPORAL_DIRS order.
    Buckets come from `pair_dist(own, neighbor)` (`_pair_dist_fn`; default
    the color distance of channels 0:3)."""
    t, h, w, _ = feats.shape
    if pair_dist is None:
        pair_dist = lambda a, b: _dist(a, b, metric)  # noqa: E731
    dev = feats.device
    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None, :]
    ts = torch.arange(t, device=dev)[:, None, None]
    dirs = _shift_dir_list(flow is None and t > 1, spatial_dirs,
                           temporal_fwd and t > 1)
    fpad = torch.nn.functional.pad(feats, (0, 0, 1, 1, 1, 1, 1, 1))
    lpad = torch.nn.functional.pad(label3, (1, 1, 1, 1, 1, 1))
    for dt, dy, dx in dirs:
        fn = fpad[1 + dt:1 + dt + t, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
        labn = lpad[1 + dt:1 + dt + t, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
        valid = ((ts + dt >= 0) & (ts + dt < t) & (ys + dy >= 0)
                 & (ys + dy < h) & (xs + dx >= 0) & (xs + dx < w))
        bucket = _bucketize(pair_dist(feats, fn))
        carry = fold_fn(carry, _RawDir(valid=valid, bucket=bucket,
                                       nb_label=labn, temporal=dt != 0))
    if flow is None or t == 1:
        return carry
    return _fold_flow_dirs(feats, label3, flow, pair_dist, fold_fn, carry)


def _fold_flow_dirs(feats, label3, flow, pair_dist, fold_fn, carry):
    """Flow-displaced backward edges: voxel (t,y,x), t>=1, anchors at
    clamp(trunc((y,x)+flow[t-1])) in frame t-1 (C truncation toward zero:
    float32 sums, then a truncating int32 cast).  The nine neighbours are
    the flat indices anchor + dy*w + dx clamped to the frame, gathered in
    one stacked gather (so at x = w-1 an index may wrap into the next row,
    as in JAX); validity is tested on the anchor-relative (y,x) only.
    Frame 0 has no backward partner: its rows are invalid."""
    t, h, w, nf = feats.shape
    n = h * w
    dev = feats.device
    ysf = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xsf = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    px = torch.clamp((xsf + flow[..., 0]).to(torch.int32), 0, w - 1)
    py = torch.clamp((ysf + flow[..., 1]).to(torch.int32), 0, h - 1)
    anchor = py * w + px                                  # (T-1,H,W)
    offs = torch.tensor([dy * w + dx for dy, dx in TEMPORAL_DIRS],
                        dtype=torch.int32, device=dev)
    flat_all = torch.clamp(anchor[None] + offs[:, None, None, None],
                           0, n - 1)                      # (9,T-1,H,W)
    # Global voxel index into frames 0..T-2.
    gidx = (flat_all.long() + (torch.arange(t - 1, device=dev) * n)
            [None, :, None, None]).reshape(-1)
    fn_all = feats[:-1].reshape(-1, nf).index_select(0, gidx) \
        .reshape(len(TEMPORAL_DIRS), t - 1, h, w, nf)
    labn_all = label3[:-1].reshape(-1).index_select(0, gidx) \
        .reshape(len(TEMPORAL_DIRS), t - 1, h, w)

    def pad_first(x, fill=0):
        return torch.cat([torch.full((1,) + tuple(x.shape[1:]), fill,
                                     dtype=x.dtype, device=dev), x])

    for k, (dy, dx) in enumerate(TEMPORAL_DIRS):
        ny = py + dy
        nx = px + dx
        valid2 = (ny >= 0) & (ny < h) & (nx >= 0) & (nx < w)
        bucket = _bucketize(pair_dist(feats[1:], fn_all[k]))
        carry = fold_fn(carry, _RawDir(valid=pad_first(valid2, False),
                                       bucket=pad_first(bucket),
                                       nb_label=pad_first(labn_all[k]),
                                       temporal=True))
    return carry


def _desc_distance(own_mean, nb_mean, bucket, p: OversegParams):
    d = _dist(own_mean, nb_mean, p.metric)
    w_eff = bucket.to(torch.float32) * (1.0 / NUM_BUCKETS)
    force = (w_eff < p.force_merge_weight) & (d < 0.2)
    return torch.where(force, torch.zeros_like(d), d)


def _variance(ts: SolverState, mean):
    """Per-slot color variance sqsum/size - mean^2 (one fused multiply-add
    in the JAX package's compiled code)."""
    return _fma(-mean, mean,
                ts.sqsum / torch.clamp(ts.size, min=1.0)[:, None])


def _trait_distance(mean_a, var_a, mean_b, var_b, bucket, p: OversegParams):
    """Descriptor-trait merge distance: color_mean is `_desc_distance`;
    color_mean_variance the z-score of the mean difference over the pooled
    per-channel variance, scaled by 0.2 and clamped to 1
    (pixel_distance.h:571-587, no force-merge shortcut)."""
    if p.descriptor == "color_mean_variance":
        mv = torch.clamp(0.5 * (var_a + var_b), min=1e-4)
        diff = mean_a - mean_b
        q = diff * diff / mv
        d = sqrt32(q[..., 0] + q[..., 1] + q[..., 2]) * 0.2
        return torch.clamp(d, max=1.0)
    return _desc_distance(mean_a, mean_b, bucket, p)


def _thresholds(p: OversegParams):
    """Effective (merge, split) thresholds: with the gradient trait the
    per-trait thresholds aggregate like the distances
    (AggregatedDescriptorTraits, pixel_distance.h:762-772)."""
    if not p.gradient_trait:
        return p.merge_threshold, p.split_threshold
    return (pd.aggregate_scalar(p.merge_threshold,
                                pd.GRADIENT_MERGE_THRESHOLD, p.aggregator,
                                p.linear_weight),
            pd.aggregate_scalar(p.split_threshold,
                                pd.GRADIENT_SPLIT_THRESHOLD, p.aggregator,
                                p.linear_weight))


def _pair_dist_fn(p: OversegParams, nf: int):
    """Pixel-edge distance over packed (..., nf) features (color in
    channels 0:3, gradient in 3:5 when present): the bucket source of edge
    extraction, aggregated per AggregatedDistance."""
    if not p.gradient_trait or nf < 5:
        return lambda a, b: _dist(a[..., 0:3], b[..., 0:3], p.metric)

    def fn(a, b):
        dc = _dist(a[..., 0:3], b[..., 0:3], p.metric)
        dg = pd.gradient_distance(a[..., 3:5], b[..., 3:5], p.metric)
        return pd.aggregate(dc, dg, p.aggregator, p.linear_weight)

    return fn


def _merge_distance(ts: SolverState, own, a2, bucket, p: OversegParams):
    """Merge-gate distance between the regions at slots `own` and `a2`
    (index tensors that broadcast, e.g. (nseg,1) roots against (nseg,K)
    partner roots): the descriptor trait, aggregated with the
    gradient-mean distance under the gradient trait."""
    size = torch.clamp(ts.size, min=1.0)[:, None]
    mean = ts.csum / size
    var_a = var_b = None
    if p.descriptor == "color_mean_variance":
        var = _variance(ts, mean)
        var_a, var_b = _take(var, own), _take(var, a2)
    dd = _trait_distance(_take(mean, own), var_a, _take(mean, a2), var_b,
                         bucket, p)
    if p.gradient_trait:
        gmean = ts.gsum / size
        dd = pd.aggregate(dd, pd.gradient_trait_distance(
            _take(gmean, own), _take(gmean, a2)), p.aggregator,
            p.linear_weight)
    return dd


def _pair_gate(p: OversegParams, is_min_size: bool):
    """Pair-cancellation gate for _apply_merge (None = off)."""
    if p.pair_merge and p.pair_merge_minsize:
        return True
    if p.pair_merge:
        return not is_min_size
    if p.pair_merge_minsize:
        return is_min_size
    return None


def _select_partners(best_bucket, best_partner, label_flat, n):
    """Region-level Boruvka selection from per-pixel (bucket, partner)
    bests: min bucket, then min partner at that bucket."""
    r_bucket = seg_min(best_bucket, label_flat, n)
    at_min = ((best_bucket == _take(r_bucket, label_flat))
              & (best_bucket < I32MAX))
    key2 = torch.where(at_min, best_partner, I32MAX)
    return seg_min(key2, label_flat, n)


def _apply_merge(state: SolverState, partner, n, up=None, pair_gate=None):
    """Hook roots onto partners (I32MAX = no hook), re-aggregate.  `up`
    restricts hooks to larger (True) / smaller (False) slots; `pair_gate`
    cancels hooks whose target also hooks.  Returns (state, moved,
    candidates) with the counts as 0-d tensors."""
    slots = _arange(n, partner)
    have = partner < I32MAX
    hook = have
    if up is not None:
        hook = hook & ((partner > slots) == up)
    if pair_gate:
        tgt = torch.clamp(partner, max=n - 1)
        hook = hook & ~_take(hook, tgt)
    parent = torch.where(hook, partner, slots)
    root = cc.pointer_jump(parent)
    stats = _seg_sum_stats(state, root, n,
                           state.frozen.to(torch.float32), state.csum,
                           state.size)
    constr = seg_max(state.constr, root, n)
    fin = seg_min(state.fin, root, n)
    label = _take(root, state.label)
    moved = (root != slots).sum()
    return (SolverState(label, stats[:, 0:3], stats[:, 3], constr, fin,
                        stats[:, 4] > 0, *_extra_stats(state, stats)),
            moved, have.sum())


def _seg_sum_stats(state: SolverState, seg, n, frozen_f, csum, size):
    """One segment sum of [csum, size, frozen, sqsum?, gsum?] by `seg`
    (the optional columns where the state carries them)."""
    cols = [csum, size[:, None], frozen_f[:, None]]
    cols += [x for x in (state.sqsum, state.gsum) if x is not None]
    return seg_sum(torch.cat(cols, dim=1), seg, n)


def _extra_stats(state: SolverState, stats):
    """(sqsum, gsum) columns of a `_seg_sum_stats` result."""
    off = 5
    sq = g = None
    if state.sqsum is not None:
        sq, off = stats[:, off:off + 3], off + 3
    if state.gsum is not None:
        g = stats[:, off:off + 2]
    return sq, g


# ---------------------------------------------------------------------------
# Edge-table solver.

_PARTNER_BITS = 20
_PARTNER_MASK = (1 << _PARTNER_BITS) - 1
_MAX_TABLE = 1 << 22


def _pack_spec(nseg: int):
    """(partner_bits, bucket_shift) of the packed int32 keys by table size."""
    if nseg <= (1 << _PARTNER_BITS):
        return _PARTNER_BITS, 0
    if nseg > _MAX_TABLE:
        raise ValueError(f"edge table {nseg} exceeds packable {_MAX_TABLE}; "
                         "split the solve into more spatial bands")
    return 22, 2


def _extract_edges(memb3, vol, nseg, sink, p, init_label=None,
                   orig_slot=None, head_planes: int = 0, flow=None,
                   global_base: int = 0, pack_domain: int | None = None):
    """One-time region-adjacency extraction (see the JAX docstring);
    `flow` displaces the temporal directions (`_fold_dirs_raw`); `vol`
    carries the gradient channels 3:5 under the gradient trait, which the
    pair distance aggregates into the buckets.
    `global_base` offsets the packed partner ids and `pack_domain` sizes
    the key layout: a band of a banded solve extracts with band-local own
    slots but partners addressed in, and packed for, the global table.

    Returns packed (2*n_dirs, nseg) int32, I32MAX where absent: forward
    per-(slot, direction) minima in rows [0, n_dirs), the reverse view
    re-scattered in table space in rows [n_dirs, 2*n_dirs).  With the tile
    path (p.extract_tile not False and init_label/orig_slot given) the
    forward minima reduce per (8,128) tile in `tile_reduce_min` (K2) and
    gather from root cells; head planes keep the scatter path.  Flow
    partners may lie in another tile (or frame t-1 of another tile): only
    the own label must be tile-local, which the preseg guarantees.
    """
    t, h, w, _ = vol.shape
    dev = vol.device
    bits, bshift = _pack_spec(pack_domain if pack_domain is not None
                              else nseg)
    pmask = (1 << bits) - 1
    memb_flat = memb3.reshape(-1)
    n_dirs = len(SPATIAL_FWD) + (len(TEMPORAL_DIRS) if t > 1 else 0)
    d_cols = 2 * n_dirs
    use_tile = p.extract_tile if p.extract_tile is not None else True
    tile_path = use_tile and init_label is not None and orig_slot is not None
    pair_dist = _pair_dist_fn(p, vol.shape[-1])

    def packed(d: _RawDir):
        ok = (d.valid & (d.nb_label != memb3) & (memb3 != sink)
              & (d.nb_label != sink))
        bkt = torch.clamp(d.bucket, max=NUM_BUCKETS - 2) >> bshift
        return torch.where(ok, (bkt << bits) | (d.nb_label + global_base),
                           I32MAX)

    tab = torch.full((d_cols, nseg), I32MAX, dtype=torch.int32, device=dev)
    if tile_path:
        head_n = head_planes * h * w
        planes = torch.empty((n_dirs, t, h, w), dtype=torch.int32,
                             device=dev)
        head_tab = torch.full((n_dirs, nseg), I32MAX, dtype=torch.int32,
                              device=dev)

        def fold(k, d: _RawDir):
            pk_a = packed(d)
            planes[k] = pk_a
            if head_n:
                head_tab[k] = seg_min(pk_a.reshape(-1)[:head_n],
                                      memb_flat[:head_n], nseg)
            return k + 1

        _fold_dirs_raw(vol, memb3, p.metric, fold, 0, flow, pair_dist)
        if head_planes:
            # Head pixels' labels are not tile-local: their reduction is
            # the scatter above, never the tile pass.
            planes[:, :head_planes] = I32MAX

        from video_segment_tpu_torch.ops import tile_extract
        from video_segment_tpu_torch.ops.tile_felz import TILE_H, TILE_W
        yx = init_label % (h * w)
        labr = ((yx // w) % TILE_H).reshape(t, h, w).to(torch.int32)
        labc = (yx % w % TILE_W).reshape(t, h, w).to(torch.int32)
        red = tile_extract.tile_reduce_min(labr.contiguous(),
                                           labc.contiguous(), planes)
        gathered = red.reshape(n_dirs, -1)[:, orig_slot.long()]
        # A slot's gather is meaningful only if orig_slot really roots it
        # (overflow/sink slots carry orig_slot 0).
        slots_i = _arange(nseg, vol)
        real = ((_take(memb_flat, orig_slot) == slots_i)
                & (slots_i != sink))[None]
        fwd_t = torch.where(real, gathered, I32MAX)
        tab[:n_dirs] = torch.minimum(fwd_t, head_tab)
    else:
        def fold(k, d: _RawDir):
            tab[k] = seg_min(packed(d).reshape(-1), memb_flat, nseg)
            return k + 1

        _fold_dirs_raw(vol, memb3, p.metric, fold, 0, flow, pair_dist)

    # Reverse view: column k's entry at slot a, packed (bucket, partner b),
    # re-scatters as (bucket, a) onto slot b.  Partner ids are clamped into
    # the table (JAX drops out-of-range scatter updates; valid partners are
    # always in range).
    fwd = tab[:n_dirs]
    valid = fwd < I32MAX
    ploc = torch.clamp((fwd & pmask) - global_base, 0, nseg - 1)
    own_g = _arange(nseg, vol)[None] + global_base
    rev_val = torch.where(valid, ((fwd >> bits) << bits) | own_g, I32MAX)
    kidx = _arange(n_dirs, vol)[:, None].long()
    rev = seg_min(rev_val.reshape(-1), (kidx * nseg + ploc).reshape(-1),
                  n_dirs * nseg).reshape(n_dirs, nseg)
    tab[n_dirs:] = rev
    return tab


def _topk_edges(tab, k):
    """(D, nseg) packed table -> per-slot K smallest distinct edges:
    (partner (nseg,K) int32 with I32MAX absent, bucket (nseg,K) int32 with
    NUM_BUCKETS absent)."""
    nseg = tab.shape[1]
    bits, bshift = _pack_spec(nseg)
    pmask = (1 << bits) - 1
    cur = tab.t().contiguous()
    k = min(k, cur.shape[1])
    parts, bkts = [], []
    for _ in range(k):
        m = cur.min(dim=1).values
        cur = torch.where(cur == m[:, None], I32MAX, cur)
        valid = m < I32MAX
        parts.append(torch.where(valid, m & pmask, I32MAX))
        bkts.append(torch.where(valid, (m >> bits) << bshift, NUM_BUCKETS))
    return torch.stack(parts, dim=1), torch.stack(bkts, dim=1)


def _table_round(ts: SolverState, ptn, pbk, theta, up, mode, nseg, sink,
                 p: OversegParams, sup=None, st_on: bool = False):
    """One Boruvka round over the region edge table (see the JAX
    `_table_round`).

    With `sup` (per-slot supertile id) and `st_on` (a gated level, below
    `p.st_levels`), regular merges are admitted only between FREE regions
    whose roots lie in the same supertile: cross-supertile pairs and every
    pair with a constrained side wait for level `st_levels`, where the
    ungated rounds re-test them with the merged statistics.
    """
    root = ts.label
    bits, bshift = _pack_spec(nseg)

    own = root
    own_size = _take(ts.size, own)
    own_constr = _take(ts.constr, own)
    own_fin = _take(ts.fin, own)

    ptn_c = torch.clamp(ptn, max=nseg - 1)
    a2 = _take(root, ptn_c)                      # (nseg,K) partner roots
    nb_constr = _take(ts.constr, a2)
    nb_fin = _take(ts.fin, a2)

    live = ((ptn < I32MAX) & (a2 != own[:, None]) & (own[:, None] != sink)
            & (a2 != sink))
    dd = _merge_distance(ts, own[:, None], a2, pbk, p)
    mthr, sthr = _thresholds(p)

    either_free = (own_constr[:, None] < 0) | (nb_constr < 0)
    regular = (either_free & (pbk < own_fin[:, None]) & (pbk < nb_fin)
               & (dd < mthr))
    constr_same = (~either_free & (own_constr[:, None] == nb_constr)
                   & (dd <= sthr))
    adm_merge = (pbk <= theta) & (regular | constr_same)
    if sup is not None and st_on:
        adm_merge = (adm_merge & (_take(sup, own)[:, None] == _take(sup, a2))
                     & (own_constr[:, None] < 0) & (nb_constr < 0))
    both_constr_diff = (~either_free) & (own_constr[:, None] != nb_constr)
    own_small = own_size < p.min_region_size
    adm_small = own_small[:, None] & ~both_constr_diff & (pbk <= theta)
    is_min_size = mode == MODE_MIN_SIZE
    adm = live & (adm_small if is_min_size else adm_merge)

    packed = torch.where(
        adm, ((torch.clamp(pbk, max=NUM_BUCKETS - 2) >> bshift) << bits) | a2,
        I32MAX)
    best_slot = packed.min(dim=1).values
    r_best = seg_min(best_slot, own, nseg)
    partner = torch.where(r_best < I32MAX, r_best & ((1 << bits) - 1),
                          I32MAX)
    return _apply_merge(ts, partner, nseg, up=up,
                        pair_gate=_pair_gate(p, is_min_size))


def _table_level_end(ts: SolverState, tab, theta, nseg, sink,
                     p: OversegParams):
    """Level-end finalization / unconstraining over the full edge table."""
    root = ts.label
    bits, bshift = _pack_spec(nseg)
    own = root
    own_size = _take(ts.size, own)
    own_constr = _take(ts.constr, own)
    own_fin = _take(ts.fin, own)
    own_frozen = _take(ts.frozen, own)

    pk = tab.t()                                 # (nseg, D)
    has = pk < I32MAX
    ptn = torch.where(has, pk & ((1 << bits) - 1), 0)
    bkt = torch.where(has, (pk >> bits) << bshift, NUM_BUCKETS)
    a2 = _take(root, ptn)
    nb_constr = _take(ts.constr, a2)
    nb_fin = _take(ts.fin, a2)
    nb_size = _take(ts.size, a2)

    live = has & (a2 != own[:, None]) & (own[:, None] != sink) & (a2 != sink)
    act = live & (bkt <= theta)
    dd = _merge_distance(ts, own[:, None], a2, bkt, p)
    mthr, sthr = _thresholds(p)

    either_free = (own_constr[:, None] < 0) | (nb_constr < 0)
    fail = (act & either_free & (bkt < own_fin[:, None]) & (bkt < nb_fin)
            & (dd >= mthr))
    split = (act & ~either_free & (own_constr[:, None] == nb_constr)
             & (dd > sthr))
    uncon = (split & ~(nb_size < 0.3 * own_size[:, None])
             & ~own_frozen[:, None])

    fail_slot = torch.where(fail, bkt, I32MAX).min(dim=1).values
    uncon_slot = uncon.any(dim=1)
    fail_r = seg_min(fail_slot, own, nseg)
    uncon_r = seg_max(uncon_slot.to(torch.int32), own, nseg) > 0
    return ts._replace(fin=torch.minimum(ts.fin, fail_r),
                       constr=torch.where(uncon_r, -1, ts.constr))


def _merge_constrained(state: SolverState, num_constraints: int, n: int,
                       p: OversegParams):
    """Final constraint association (MergeConstrainedRegions): frozen
    regions always merge into their group's representative; real regions
    merge when within the split threshold and are unconstrained otherwise."""
    slots = _arange(n, state.label)
    is_root = state.size > 0
    cid = torch.where(is_root & (state.constr >= 0), state.constr,
                      num_constraints)
    frozen_slot = torch.where(state.frozen, slots, I32MAX)
    rep_frozen = seg_min(frozen_slot, cid, num_constraints + 1)
    rep_any = seg_min(slots, cid, num_constraints + 1)
    rep = torch.where(rep_frozen < I32MAX, rep_frozen, rep_any)

    target = _take(rep, torch.clamp(state.constr, 0, num_constraints - 1))
    active = (cid < num_constraints) & (target != slots)
    # `target` may hold rep's I32MAX identity for inactive slots; clamp the
    # gather (JAX clamps out-of-range gathers).  Bucket NUM_BUCKETS: no
    # force-merge shortcut.
    d = _merge_distance(state, slots, torch.clamp(target, max=n - 1),
                        torch.full_like(slots, NUM_BUCKETS), p)
    merge = active & (state.frozen | (d <= _thresholds(p)[1]))
    uncon = active & ~merge & ~state.frozen

    state = state._replace(constr=torch.where(uncon, -1, state.constr))
    partner = torch.where(merge, target, I32MAX)
    state, _, _ = _apply_merge(state, partner, n)
    return state


def _table_cap(params: OversegParams, n_pix: int, h: int, w: int,
               has_constraints: bool) -> int:
    """Static table size: caller-provided live-count bucket, or the
    worst-case pixel-fraction fallback."""
    if params.table_slots:
        return min(params.table_slots, n_pix, _MAX_TABLE - 2)
    extra = ((h * w) // 4 + params.max_constraints) if has_constraints \
        else 0
    return min(max(n_pix // params.table_divisor, 1 << 14) + extra, n_pix,
               _MAX_TABLE - 2)


def _init_table(vol, init_label, constr_init, frozen_init, fin_init,
                r_cap: int, has_constraints: bool, cell_stats=None,
                head_planes: int = 0, params: OversegParams | None = None):
    """Fused seed compaction: renumber self-rooted init labels into table
    slots and aggregate region statistics there (gathered from root cells
    with `cell_stats`, except for the first `head_planes` planes).  Under
    the variance descriptor or the gradient trait (`params`; `vol` then
    carries the gradient in channels 3:5) every statistic is a segment sum
    over the pixels, with color squares and sign-normalized gradients as
    extra columns; the cell stats are not used.

    Returns (table SolverState with identity labels, per-pixel membership,
    per-slot original root voxel id)."""
    n_pix = init_label.shape[0]
    h_, w_ = vol.shape[1], vol.shape[2]
    nseg = r_cap + 1
    dev = vol.device
    slots = _arange(n_pix, vol)
    is_root = init_label == slots
    cidx_all = torch.cumsum(is_root.to(torch.int32), 0,
                            dtype=torch.int32) - 1
    ok = is_root & (cidx_all < r_cap)
    cidx = torch.where(ok, cidx_all, r_cap)
    memb = _take(cidx, init_label)
    orig_slot = torch.zeros(nseg, dtype=torch.int32, device=dev) \
        .scatter_reduce_(0, cidx.long(), torch.where(ok, slots, 0), "amax")

    volf = vol.reshape(n_pix, -1)
    color = volf[:, 0:3]
    ones = torch.ones((n_pix, 1), dtype=torch.float32, device=dev)
    use_var = params is not None and params.descriptor == "color_mean_variance"
    use_grad = (params is not None and params.gradient_trait
                and volf.shape[1] >= 5)
    sqsum = gsum = None

    if cell_stats is not None and not use_var and not use_grad:
        head_n = head_planes * h_ * w_
        size_c, c0, c1, c2 = (x.reshape(n_pix) for x in cell_stats)
        n_active = ok.to(torch.int32).sum()
        valid = _arange(nseg, vol) < n_active

        def zero_head(x):
            if not head_n:
                return x
            return torch.cat([torch.zeros(head_n, dtype=x.dtype, device=dev),
                              x[head_n:]])

        size = torch.where(valid, _take(zero_head(size_c), orig_slot), 0.0)
        csum = torch.stack([_take(zero_head(c), orig_slot)
                            for c in (c0, c1, c2)], dim=1) \
            * valid[:, None].to(torch.float32)
        fin = torch.where(valid, _take(fin_init, orig_slot), I32MAX)
        if head_n:
            hstats = seg_sum(torch.cat([color[:head_n], ones[:head_n]], 1),
                             memb[:head_n], nseg)
            csum = csum + hstats[:, 0:3]
            size = size + hstats[:, 3]
        if has_constraints:
            hm = memb[:head_n]
            constr = torch.clamp(seg_max(constr_init[:head_n], hm, nseg),
                                 min=-1)
            frozen = seg_max(frozen_init[:head_n].to(torch.int32), hm,
                             nseg) > 0
        else:
            constr = torch.full((nseg,), -1, dtype=torch.int32, device=dev)
            frozen = torch.zeros(nseg, dtype=torch.bool, device=dev)
    else:
        cols = [color, ones]
        if use_var:
            cols.append(color * color)
        if use_grad:
            cols.append(pd.sign_normalize(volf[:, 3:5]))
        stats = seg_sum(torch.cat(cols, dim=1), memb, nseg)
        csum = stats[:, 0:3]
        size = stats[:, 3]
        if use_var:
            sqsum = stats[:, 4:7]
        if use_grad:
            gsum = stats[:, 7:9] if use_var else stats[:, 4:6]
        if has_constraints:
            constr = seg_max(constr_init, memb, nseg)
            frozen = seg_max(frozen_init.to(torch.int32), memb, nseg) > 0
        else:
            constr = torch.full((nseg,), -1, dtype=torch.int32, device=dev)
            frozen = torch.zeros(nseg, dtype=torch.bool, device=dev)
        fin = seg_min(fin_init, memb, nseg)
    # Sink must never merge: finalize level 0, unconstrained.
    fin[r_cap] = 0
    constr[r_cap] = -1
    ts = SolverState(_arange(nseg, vol), csum, size, constr, fin, frozen,
                     sqsum, gsum)
    return ts, memb, orig_slot


def _solve_edge_table(vol, init_label, constr_init, frozen_init,
                      fin_init, params, n_pix, thetas, level_rounds,
                      has_constraints, cell_stats=None,
                      head_planes: int = 0, flow=None):
    """Edge-table phases: table init, edge extraction, table solve.  The
    gradient trait appends the luminance gradient to the volume first."""
    t, h, w, _ = vol.shape
    if params.gradient_trait:
        vol = torch.cat([vol, pd.gradient_features(vol)], dim=-1)
    if params.bands > 1:
        return _solve_banded(vol, flow, init_label, constr_init, frozen_init,
                             fin_init, params, thetas, level_rounds,
                             has_constraints, cell_stats, head_planes)
    r_cap = _table_cap(params, n_pix, h, w, has_constraints)
    nseg = r_cap + 1
    ts, memb, orig_slot = _init_table(vol, init_label, constr_init,
                                      frozen_init, fin_init, r_cap,
                                      has_constraints, cell_stats,
                                      head_planes, params)
    tab = _extract_edges(memb.reshape(t, h, w), vol, nseg, r_cap, params,
                         init_label=init_label, orig_slot=orig_slot,
                         head_planes=head_planes, flow=flow)
    return _finish_table_solve(ts, tab, memb, orig_slot, init_label,
                               (t, h, w), params, thetas, level_rounds,
                               has_constraints)


_PHASE_Q = 1 << 14      # phase-cap quantization
_PHASE_FLOOR = 1 << 15  # smallest recompacted table


def _table_phase_caps(nseg0: int) -> tuple:
    """Shrinking table caps for the schedule phases (halving to a floor,
    16k-quantized).  These caps are semantics (sink overflow, recompaction
    points), so they equal the JAX package's exactly."""
    caps = [nseg0]
    while True:
        tgt = max(caps[-1] // 2, _PHASE_FLOOR)
        nxt = -(-tgt // _PHASE_Q) * _PHASE_Q + 1
        if nxt >= caps[-1]:
            return tuple(caps)
        caps.append(nxt)


def _recompact_table(ts, tab, o2n, fb_slot, orig_slot, new_cap: int):
    """Mid-schedule table shrink: renumber live roots into a `new_cap`-slot
    table (last slot = sink), remap and re-min the edge table, compose the
    original-slot chain `o2n`, and record dying regions' merged-so-far
    labels in `fb_slot`."""
    old_cap = ts.label.shape[0]
    old_sink = old_cap - 1
    new_sink = new_cap - 1
    dev = tab.device
    root = ts.label
    slots = _arange(old_cap, tab)
    is_root = (root == slots) & (ts.size > 0) & (slots != old_sink)
    cidx_all = torch.cumsum(is_root.to(torch.int32), 0,
                            dtype=torch.int32) - 1
    ok = is_root & (cidx_all < new_sink)
    cidx = torch.where(ok, cidx_all, new_sink)
    new_of = _take(cidx, root)
    n_active = ok.to(torch.int32).sum()

    orig_min = seg_min(orig_slot, root, old_cap)

    new_slots = _arange(new_cap, tab)
    inv = torch.zeros(new_cap, dtype=torch.int32, device=dev) \
        .scatter_reduce_(0, cidx.long(), torch.where(ok, slots, 0), "amax")
    valid_new = new_slots < n_active
    vf = valid_new.to(torch.float32)[:, None]

    def rows(x):
        return None if x is None else _take(x, inv) * vf

    ts2 = SolverState(
        label=new_slots,
        csum=rows(ts.csum),
        size=_take(ts.size, inv) * vf[:, 0],
        constr=torch.where(valid_new, _take(ts.constr, inv), -1),
        fin=torch.where(valid_new, _take(ts.fin, inv), 0),
        frozen=valid_new & _take(ts.frozen, inv),
        sqsum=rows(ts.sqsum), gsum=rows(ts.gsum))

    bits_o, bshift_o = _pack_spec(old_cap)
    bits_n, bshift_n = _pack_spec(new_cap)
    valid_e = tab < I32MAX
    ptn_o = torch.clamp(tab & ((1 << bits_o) - 1), max=old_cap - 1)
    bkt = (tab >> bits_o) << bshift_o
    p_new = _take(new_of, ptn_o)
    ok_e = (valid_e & (p_new != new_sink) & (new_of[None, :] != new_sink)
            & (p_new != new_of[None, :]))
    pk_new = torch.where(
        ok_e,
        ((torch.clamp(bkt, max=NUM_BUCKETS - 2) >> bshift_n) << bits_n)
        | p_new, I32MAX)
    d_cols = tab.shape[0]
    seg2 = (new_of[None, :].long()
            + (torch.arange(d_cols, device=dev) * new_cap)[:, None])
    tab2 = seg_min(pk_new.reshape(-1), seg2.reshape(-1),
                   d_cols * new_cap).reshape(d_cols, new_cap)

    r_o = _take(root, o2n)
    died = (r_o != old_sink) & ~_take(ok, r_o)
    fb_slot2 = torch.where(died, _take(orig_min, r_o), fb_slot)
    o2n2 = _take(new_of, o2n)
    orig2 = torch.where(valid_new, _take(orig_min, inv), 0)
    return ts2, tab2, o2n2, fb_slot2, orig2


def _sup_ids_hw(orig, h, w, params: OversegParams):
    """Per-slot supertile id (frame, st_h row band, st_w column band) from
    the slot's original root voxel."""
    n_sx = -(-w // params.st_w)
    tt = orig // (h * w)
    rem = orig % (h * w)
    sid = ((tt * -(-h // params.st_h) + (rem // w) // params.st_h) * n_sx
           + (rem % w) // params.st_w)
    return torch.clamp(sid, max=I32MAX - 1)


def _use_st_kernel(p: OversegParams) -> bool:
    """Whether the gated levels run as K3 launches rather than masked
    global rounds.  `st_kernel=None` means the kernel on every device.
    The kernel gates on the color mean alone, so the two-stage solve, the
    variance descriptor and the gradient trait take the masked rounds (the
    JAX package's gate); it carries neither pair cancellation nor
    per-round failure scans nor interleaved min-size rounds, so those knobs
    take them too (the kernel path must equal them)."""
    if p.st_levels <= 0 or p.st_kernel is False:
        return False
    if p.two_stage or p.descriptor != "color_mean" or p.gradient_trait:
        return False
    return not (p.pair_merge or p.fin_every_round or p.min_size_interleave)


class _Supertiles(NamedTuple):
    """Blocked layout of the table slots for the K3 levels."""
    g2b: torch.Tensor       # (nseg,) blocked position per slot, -1 unplaced
    b2g: torch.Tensor       # (n_sup*s_cap,) slot per position (sink: empty)
    seeds: tuple            # (size, c0, c1, c2) blocked seed planes
    edges: torch.Tensor     # (n_sup, K, SR, 128) same-supertile top-K edges
    n_sup: int
    s_cap: int


def _st_layout(ts: SolverState, ptn, pbk, orig_slot, shape3,
               params: OversegParams) -> _Supertiles:
    """Block the fresh table (every row a seed) per supertile and build the
    edge planes from the global per-slot top-K: only same-supertile pairs
    with both ends placed stay; the rest wait for the global levels."""
    from video_segment_tpu_torch.ops import tile_table as tt

    t, h, w = shape3
    nseg0 = ts.label.shape[0]
    sink = nseg0 - 1
    n_sup = t * -(-h // params.st_h) * -(-w // params.st_w)
    s_cap = params.st_slots
    sr = s_cap // tt.L
    sup = _sup_ids_hw(orig_slot, h, w, params)
    sup[sink] = n_sup
    g2b, b2g = tt.blocked_layout(sup, n_sup, s_cap)
    seed_size = _take(ts.size, b2g)
    c_b = _take(ts.csum, b2g)
    seeds = tuple(x.reshape(n_sup, sr, tt.L).contiguous()
                  for x in (seed_size, c_b[:, 0], c_b[:, 1], c_b[:, 2]))

    k_edges = ptn.shape[1]
    pg = _take(g2b, torch.clamp(ptn, max=sink))
    own_b = g2b[:, None]
    same = ((ptn < I32MAX) & (pg >= 0) & (own_b >= 0)
            & (pg // s_cap == own_b // s_cap))
    packed = torch.where(
        same, (torch.clamp(pbk, max=NUM_BUCKETS - 2) << tt.PBITS)
        | (pg % s_cap), I32MAX)
    dump = n_sup * s_cap
    e_scatter = torch.full((dump + 1, k_edges), I32MAX, dtype=torch.int32,
                           device=ptn.device)
    e_scatter[torch.where(g2b >= 0, g2b, dump).long()] = packed
    edges = e_scatter[:-1].reshape(n_sup, sr, tt.L, k_edges) \
        .permute(0, 3, 1, 2).contiguous()
    return _Supertiles(g2b, b2g, seeds, edges, n_sup, s_cap)


def _st_level_planes(st: _Supertiles, ts: SolverState):
    """K3's per-level planes from the current state: launch-time local
    roots, region finalize levels, and the blocked plane, rebuilt from the
    CURRENT constraint ids (a region that a level end unconstrained is
    free at the next gated level, as in the masked rounds)."""
    from video_segment_tpu_torch.ops import tile_table as tt

    shape = (st.n_sup, st.s_cap // tt.L, tt.L)
    pos = torch.arange(st.n_sup * st.s_cap, dtype=torch.int32,
                       device=st.g2b.device)
    root_g = _take(ts.label, st.b2g)
    root_b = _take(st.g2b, root_g)
    ok = (root_b >= 0) & (root_b // st.s_cap == pos // st.s_cap)
    loc = torch.where(ok, root_b % st.s_cap, pos % st.s_cap)
    blocked = ((_take(ts.constr, root_g) >= 0) | _take(ts.frozen, root_g)
               | (st.seeds[0].reshape(-1) <= 0.0)).to(torch.int32)
    return ((loc // tt.L).reshape(shape), (loc % tt.L).reshape(shape),
            _take(ts.fin, root_g).reshape(shape), blocked.reshape(shape))


def _k3_args(st: _Supertiles, ts: SolverState, params: OversegParams,
             lvl: int) -> dict:
    """`tile_table_rounds` arguments of gated level `lvl`."""
    labr, labc, fin_b, blocked_b = _st_level_planes(st, ts)
    size, c0, c1, c2 = st.seeds
    return dict(labr=labr, labc=labc, size=size, c0=c0, c1=c1, c2=c2,
                fin=fin_b, blocked=blocked_b, edges=st.edges,
                theta=int(params.schedule[lvl]),
                rounds=int(params.max_rounds_per_level),
                merge_threshold=params.merge_threshold,
                force_merge_weight=params.force_merge_weight,
                metric=params.metric)


def _end_table(tab, ptn, pbk, cap: int):
    """Level-end scans sweep the full extraction table when it is
    affordable; larger tables fall back to the per-slot top-K edges."""
    if cap <= (1 << _PARTNER_BITS):
        return tab
    bits, bshift = _pack_spec(cap)
    return torch.where(
        ptn < I32MAX,
        ((torch.clamp(pbk, max=NUM_BUCKETS - 2) >> bshift) << bits) | ptn,
        I32MAX).t()


def _st_kernel_levels(ts, tab, orig_slot, shape3, params, diag):
    """Run schedule levels 0..st_levels-1 as one K3 launch each (merge
    rounds per supertile), then sync the labels into the global table,
    re-aggregate every region's statistics from the seed rows and run the
    level end GLOBALLY over the full edge table (fins must see
    cross-supertile edges)."""
    from video_segment_tpu_torch.ops import tile_table as tt

    nseg0 = ts.label.shape[0]
    sink = nseg0 - 1
    ptn, pbk = _topk_edges(tab, params.edge_topk)
    st = _st_layout(ts, ptn, pbk, orig_slot, shape3, params)
    seed_csum, seed_size, seed_ts = ts.csum, ts.size, ts
    end_tab = _end_table(tab, ptn, pbk, nseg0)
    blk_idx = (torch.arange(st.n_sup, dtype=torch.int32,
                            device=tab.device)[:, None] * st.s_cap)
    for lvl in range(params.st_levels):
        labr, labc = tt.tile_table_rounds(**_k3_args(st, ts, params, lvl))
        new_root_pos = (blk_idx + (labr * tt.L + labc)
                        .reshape(st.n_sup, st.s_cap)).reshape(-1)
        new_root_g = _take(st.b2g, new_root_pos)
        new_label = torch.where(
            st.g2b >= 0, _take(new_root_g, torch.clamp(st.g2b, min=0)),
            ts.label)
        old_root = ts.label
        stats = _seg_sum_stats(
            seed_ts, new_label, nseg0,
            _take(ts.frozen, old_root).to(torch.float32), seed_csum,
            seed_size)
        ts = SolverState(new_label, stats[:, 0:3], stats[:, 3],
                         seg_max(_take(ts.constr, old_root), new_label,
                                 nseg0),
                         seg_min(_take(ts.fin, old_root), new_label, nseg0),
                         stats[:, 4] > 0, *_extra_stats(seed_ts, stats))
        ts = _table_level_end(ts, end_tab, int(params.schedule[lvl]), nseg0,
                              sink, params)
        act = int(((ts.label == _arange(nseg0, tab)) & (ts.size > 0)).sum())
        # K3 does not report its round count: the diag row says 0.
        diag[lvl] = (st.s_cap, 0, act)
    return ts


def supertile_level_inputs(vol, init_label, fin, cell_stats,
                           params: OversegParams) -> dict:
    """The K3 arguments of the first gated level of an unconstrained chunk
    solve (table init, edge extraction, blocked layout), for holding the
    kernel against its plain version at a real chunk's shapes."""
    t, h, w, _ = vol.shape
    n = t * h * w
    r_cap = _table_cap(params, n, h, w, False)
    fin_init = fin.reshape(n).to(torch.int32)
    ts, memb, orig_slot = _init_table(
        vol, init_label.reshape(n), torch.full_like(fin_init, -1),
        torch.zeros(n, dtype=torch.bool, device=vol.device), fin_init,
        r_cap, False, cell_stats)
    tab = _extract_edges(memb.reshape(t, h, w), vol, r_cap + 1, r_cap,
                         params, init_label=init_label.reshape(n),
                         orig_slot=orig_slot)
    ptn, pbk = _topk_edges(tab, params.edge_topk)
    st = _st_layout(ts, ptn, pbk, orig_slot, (t, h, w), params)
    return _k3_args(st, ts, params, 0)


def _finish_table_solve(ts, tab, memb, orig_slot, init_label, shape3,
                        params, thetas, level_rounds, has_constraints):
    """Top-K edges, the supertile-gated levels (K3 or masked rounds),
    schedule levels over shrinking table phases, min-size forcing,
    constraint association, label reconstruction."""
    t, h, w = shape3
    nseg0 = ts.label.shape[0]
    n_levels = len(thetas)
    dev = tab.device
    diag = np.zeros((n_levels, 3), np.int32)

    def live_count(st, cap):
        return int(((st.label == _arange(cap, tab)) & (st.size > 0)).sum())

    def run_rounds(st, theta, max_rounds, mode, p_tab, b_tab, end_tab=None,
                   sup=None, st_on=False):
        cap = p_tab.shape[0]
        sink = cap - 1
        scan_each = end_tab is not None and params.fin_every_round
        i = idle = 0
        while idle < 2 and i < max_rounds:
            if scan_each:
                st = _table_level_end(st, end_tab, theta, cap, sink, params)
            st, moved, cands = _table_round(st, p_tab, b_tab, theta,
                                            (i % 2) == 0, mode, cap, sink,
                                            params, sup=sup, st_on=st_on)
            moved, cands = torch.stack([moved, cands]).tolist()
            idle = 2 if cands == 0 else (0 if moved > 0 else idle + 1)
            i += 1
        return st, i

    if params.two_stage:
        # Spatial-only pre-pass over the whole schedule
        # (SegmentGraphSpatially, dense_segmentation_graph.h:406-416): the
        # spatial directions are extraction rows [0:4] (forward view) and
        # [nd:nd+4] (reverse view); a banded table's boundary rows follow
        # the band rows and stay out.  Its finalizations do not carry into
        # the full pass; the sink stays blocked.
        nd = len(SPATIAL_FWD) + (len(TEMPORAL_DIRS) if t > 1 else 0)
        sp = len(SPATIAL_FWD)
        tab_sp = torch.cat([tab[:sp], tab[nd:nd + sp]], dim=0)
        ptn_s, pbk_s = _topk_edges(tab_sp, params.edge_topk)
        for lvl in range(n_levels):
            ts, _ = run_rounds(ts, thetas[lvl], level_rounds[lvl],
                               MODE_MERGE, ptn_s, pbk_s, end_tab=tab_sp)
            ts = _table_level_end(ts, tab_sp, thetas[lvl], nseg0,
                                  nseg0 - 1, params)
        fin = torch.full_like(ts.fin, NUM_BUCKETS)
        fin[nseg0 - 1] = 0
        ts = ts._replace(fin=fin)

    use_kernel = _use_st_kernel(params)
    lvl = 0
    if use_kernel:
        ts = _st_kernel_levels(ts, tab, orig_slot, shape3, params, diag)
        lvl = params.st_levels
    caps = _table_phase_caps(nseg0)
    o2n = _arange(nseg0, tab)
    fb_slot = torch.zeros(nseg0, dtype=torch.int32, device=dev)
    ptn = pbk = None
    for pi, cap in enumerate(caps):
        sink = cap - 1
        if pi > 0:
            ts, tab, o2n, fb_slot, orig_slot = _recompact_table(
                ts, tab, o2n, fb_slot, orig_slot, cap)
        ptn, pbk = _topk_edges(tab, params.edge_topk)
        end_tab = _end_table(tab, ptn, pbk, cap)
        next_cap = caps[pi + 1] if pi + 1 < len(caps) else 0
        # Masked supertile gating, per phase from the (recompacted)
        # original roots, unless K3 already ran the gated levels.
        sup = (_sup_ids_hw(orig_slot, h, w, params)
               if params.st_levels > 0 and not use_kernel else None)
        act = live_count(ts, cap)
        while lvl < n_levels and (not next_cap or act > next_cap - 2):
            ts, n_used = run_rounds(ts, thetas[lvl], level_rounds[lvl],
                                    MODE_MERGE, ptn, pbk, end_tab=end_tab,
                                    sup=sup, st_on=lvl < params.st_levels)
            ts = _table_level_end(ts, end_tab, thetas[lvl], cap, sink,
                                  params)
            if params.min_size_interleave and params.min_region_size > 1:
                ts, _ = run_rounds(ts, thetas[lvl],
                                   params.min_size_interleave,
                                   MODE_MIN_SIZE, ptn, pbk)
            act = live_count(ts, cap)
            diag[lvl] = (cap, n_used, act)
            lvl += 1

    cap_f = caps[-1]
    sink_f = cap_f - 1
    if params.min_region_size > 1:
        ts, _ = run_rounds(ts, NUM_BUCKETS, params.min_size_rounds,
                           MODE_MIN_SIZE, ptn, pbk)

    if has_constraints:
        ts = _merge_constrained(ts, params.max_constraints, cap_f, params)

    # Labels in original root-voxel space: each live region takes its
    # minimum original root; sink pixels keep their merged-so-far label
    # (fallback), or their pre-table root if they overflowed at seed time.
    orig_min = seg_min(orig_slot, ts.label, cap_f)
    root_px = _take(ts.label, _take(o2n, memb))
    fb_px = torch.where(memb == nseg0 - 1, init_label, _take(fb_slot, memb))
    final = torch.where(root_px == sink_f, fb_px,
                        _take(orig_min, root_px))
    live = (ts.size > 0) & (_arange(cap_f, tab) != sink_f)
    can16 = cap_f <= (1 << 16)
    return OversegResult(
        label=final.reshape(t, h, w),
        constr=torch.where(live, ts.constr, -1),
        size=torch.where(live, ts.size, 0.0),
        orig=torch.where(live, orig_min, -1),
        label16=root_px.reshape(t, h, w) if can16 else None,
        lut=orig_min if can16 else None,
        nsink=(root_px == sink_f).to(torch.int32).sum() if can16 else None,
        diag=diag)


# ---------------------------------------------------------------------------
# Banded solve: row bands in the pixel phases, one global table.


def _boundary_edges(vol, memb_g, B: int, bh: int, G: int,
                    params: OversegParams, include_temporal: bool):
    """Cross-band adjacency: per-slot min edges across the B-1 band seams.

    Returns a (D_bd, G+1) packed table in the `_extract_edges` layout.
    Crossing directions: spatial (dy=1, dx in {-1,0,1}) between the last
    row of band b and the first row of band b+1, plus -- when flow is
    absent and t>1 -- undisplaced temporal (dt=-1, dy=+-1, dx in
    {-1,0,1}).  Flow-displaced temporal edges stay clamped within their
    band (a one-row approximation at each seam)."""
    t, h, w, nf = vol.shape
    nseg_g = G + 1
    bits, bshift = _pack_spec(nseg_g)
    pair_dist = _pair_dist_fn(params, nf)
    volr = vol.reshape(t, B, bh, w, nf)
    membr = memb_g.reshape(t, B, bh, w)
    lo_c = volr[:, :-1, -1]      # (t, B-1, w, 3): last row of band b
    hi_c = volr[:, 1:, 0]        # first row of band b+1
    lo_m = membr[:, :-1, -1]     # (t, B-1, w)
    hi_m = membr[:, 1:, 0]
    xs = torch.arange(w, device=vol.device)[None, None, :]

    def one(a_c, a_m, b_c, b_m, dx):
        if dx:
            # The roll wraps; `valid` removes the wrapped column.
            b_c = torch.roll(b_c, -dx, dims=2)
            b_m = torch.roll(b_m, -dx, dims=2)
        valid = (xs + dx >= 0) & (xs + dx < w)
        bkt = torch.clamp(_bucketize(pair_dist(a_c, b_c)),
                          max=NUM_BUCKETS - 2) >> bshift
        ok = valid & (a_m != G) & (b_m != G) & (a_m != b_m)
        pk_a = torch.where(ok, (bkt << bits) | b_m, I32MAX).reshape(-1)
        pk_b = torch.where(ok, (bkt << bits) | a_m, I32MAX).reshape(-1)
        return [seg_min(pk_a, a_m.reshape(-1), nseg_g),
                seg_min(pk_b, b_m.reshape(-1), nseg_g)]

    cols = []
    for dx in (-1, 0, 1):
        cols += one(lo_c, lo_m, hi_c, hi_m, dx)
    if include_temporal and t > 1:
        for dx in (-1, 0, 1):
            # (t, lo row) -> (t-1, hi row): down-backward
            cols += one(lo_c[1:], lo_m[1:], hi_c[:-1], hi_m[:-1], dx)
            # (t, hi row) -> (t-1, lo row): up-backward
            cols += one(hi_c[1:], hi_m[1:], lo_c[:-1], lo_m[:-1], dx)
    return torch.stack(cols, dim=0)


def _banded_dims(t: int, h: int, w: int, params: OversegParams):
    """Band-decomposition geometry: (B, bh, cap_b, nseg_b, G, nseg_g)."""
    B = params.bands
    if h % B or (h // B) % 8:
        raise ValueError(f"height {h} not divisible into {B} bands of "
                         f"8-row-aligned height")
    bh = h // B
    n_band = t * bh * w
    cap_b = params.band_table_slots or min(
        max(n_band // params.table_divisor, 1 << 14), n_band)
    nseg_b = cap_b + 1
    G = B * cap_b
    nseg_g = G + 1
    _pack_spec(nseg_g)  # validate packability
    return B, bh, cap_b, nseg_b, G, nseg_g


def _banded_split_inputs(vol, flow, init_label, constr_init, frozen_init,
                         fin_init, params: OversegParams, cell_stats=None):
    """Band-split every per-pixel solver input: (tt,h,w[,C]) ->
    (B,tt,bh,w[,C]) views, with init labels localized to band-local voxel
    ids.  Returns (vol_b, flow_b or None, init_local, constr_b, frozen_b,
    fin_b, cells_b or None)."""
    t, h, w, nf = vol.shape
    B, bh, _, _, _, _ = _banded_dims(t, h, w, params)

    def band_split(x, ch=0):
        tt = x.shape[0]
        shape = (tt, B, bh, w) + ((ch,) if ch else ())
        perm = (1, 0, 2, 3, 4) if ch else (1, 0, 2, 3)
        return x.reshape(shape).permute(perm)

    init_bs = band_split(init_label.reshape(t, h, w))
    # Localize init values (global voxel ids, in-band by construction) to
    # band-local voxel ids.
    band_of = _arange(B, vol)[:, None, None, None]
    init_local = (init_bs // (h * w)) * (bh * w) \
        + (init_bs % (h * w) - band_of * (bh * w))
    cells_b = (tuple(band_split(x.reshape(t, h, w)) for x in cell_stats)
               if cell_stats is not None else None)
    return (band_split(vol, nf),
            band_split(flow, 2) if flow is not None else None,
            init_local, band_split(constr_init.reshape(t, h, w)),
            band_split(frozen_init.reshape(t, h, w)),
            band_split(fin_init.reshape(t, h, w)), cells_b)


def _make_band_fn(t: int, h: int, w: int, params: OversegParams,
                  has_constraints: bool, head_planes: int):
    """Per-band pixel phase (seed compaction + edge extraction) of the
    banded solver: band b's inputs -> (table state, membership, packed
    edge table with global partner ids, original roots in the global voxel
    numbering)."""
    B, bh, cap_b, nseg_b, G, nseg_g = _banded_dims(t, h, w, params)

    def band_fn(b, vb, flb, il, cb, fb, finb, cls):
        vb = vb.contiguous()
        il = il.reshape(-1)
        cls_flat = (tuple(x.reshape(-1) for x in cls) if cls is not None
                    else None)
        ts_b, memb_b, orig_b = _init_table(
            vb, il, cb.reshape(-1), fb.reshape(-1), finb.reshape(-1), cap_b,
            has_constraints, cls_flat, head_planes, params)
        tab_b = _extract_edges(
            memb_b.reshape(t, bh, w), vb, nseg_b, cap_b, params,
            init_label=il, orig_slot=orig_b, head_planes=head_planes,
            flow=None if flb is None else flb.contiguous(),
            global_base=b * cap_b, pack_domain=nseg_g)
        # Delocalize original-root voxel ids.
        orig_g = (orig_b // (bh * w)) * (h * w) + b * (bh * w) \
            + orig_b % (bh * w)
        return ts_b, memb_b, tab_b, orig_g

    return band_fn


def _band_phase(vol, flow, init_label, constr_init, frozen_init, fin_init,
                params: OversegParams, has_constraints, cell_stats=None,
                head_planes: int = 0, devices=None) -> list:
    """The banded solve's pixel phase: per band, its `_make_band_fn`
    outputs on vol's device.  Bands run one after another, so a band's key
    planes are freed before the next starts; every band's outputs (table
    state, membership, packed edge table, original roots) stay until
    `_solve_banded` glues them.  With `devices` (one mesh row) band b runs
    on devices[b // (B / len(devices))], contiguous blocks of bands a
    device as shard_map splits them: its inputs are copied there and its
    outputs gathered back.  The port ignores `bands_vmap`."""
    t, h, w, _ = vol.shape
    B = params.bands
    devices = list(devices) if devices is not None else [vol.device]
    if B % len(devices):
        raise ValueError(f"{B} bands do not split over a space axis of "
                         f"{len(devices)} devices")
    band_fn = _make_band_fn(t, h, w, params, has_constraints, head_planes)
    split = _banded_split_inputs(vol, flow, init_label, constr_init,
                                 frozen_init, fin_init, params, cell_stats)
    home = vol.device
    outs = []
    for b in range(B):
        ts_b, memb_b, tab_b, orig_g = band_fn(
            b, *_band_args(split, b, devices[b // (B // len(devices))]))
        outs.append((SolverState(*[None if x is None else x.to(home)
                                   for x in ts_b]),
                     memb_b.to(home), tab_b.to(home), orig_g.to(home)))
    return outs


def _band_args(split, b: int, device) -> list:
    """Band b's slice of `_banded_split_inputs`' output on `device`."""
    return [None if x is None
            else (tuple(c[b].to(device) for c in x) if isinstance(x, tuple)
                  else x[b].to(device)) for x in split]


def _solve_banded(vol, flow, init_label, constr_init, frozen_init, fin_init,
                  params: OversegParams, thetas, level_rounds,
                  has_constraints, cell_stats=None, head_planes: int = 0,
                  band_outputs=None):
    """Row-banded pixel phases + global table phases (OversegParams.bands).

    Each band runs seed compaction and edge extraction on its own
    (`_band_phase`), with its table slots mapped into a disjoint global
    range; a boundary pass restores cross-band adjacency; the schedule,
    min-size and constraint phases then run on the glued global table
    exactly as in the monolithic solve.  A mesh caller (parallel/mesh.py)
    supplies `band_outputs`, `_band_phase`'s result with each band run on
    its own device: the global phases here are the same either way."""
    t, h, w, _ = vol.shape
    B, bh, cap_b, nseg_b, G, nseg_g = _banded_dims(t, h, w, params)
    dev = vol.device
    if band_outputs is None:
        band_outputs = _band_phase(vol, flow, init_label, constr_init,
                                   frozen_init, fin_init, params,
                                   has_constraints, cell_stats, head_planes)
    states, membs, tabs, origs = [], [], [], []
    for b, (ts_b, memb_b, tab_b, orig_g) in enumerate(band_outputs):
        states.append(ts_b)
        membs.append(torch.where(memb_b == cap_b, G, memb_b + b * cap_b))
        tabs.append(tab_b[:, :cap_b])
        origs.append(orig_g)

    def glue(rows, sink_val):
        """Per-band (nseg_b, ...) tables -> (G+1, ...) global."""
        if rows[0] is None:
            return None
        sink_row = torch.full((1,) + tuple(rows[0].shape[1:]), sink_val,
                              dtype=rows[0].dtype, device=dev)
        return torch.cat([r[:cap_b] for r in rows] + [sink_row])

    ts = SolverState(
        label=_arange(nseg_g, vol),
        csum=glue([s.csum for s in states], 0.0),
        size=glue([s.size for s in states], 0.0),
        constr=glue([s.constr for s in states], -1),
        fin=glue([s.fin for s in states], 0),
        frozen=glue([s.frozen for s in states], False),
        sqsum=glue([s.sqsum for s in states], 0.0),
        gsum=glue([s.gsum for s in states], 0.0))
    orig_slot = glue(origs, 0)
    memb_g = torch.stack(membs).reshape(B, t, bh, w).permute(1, 0, 2, 3) \
        .reshape(-1)
    d_band = tabs[0].shape[0]
    tab_g = torch.cat(tabs + [torch.full((d_band, 1), I32MAX,
                                         dtype=torch.int32, device=dev)],
                      dim=1)
    tab_bd = _boundary_edges(vol, memb_g.reshape(t, h, w), B, bh, G, params,
                             include_temporal=flow is None)
    tab = torch.cat([tab_g, tab_bd], dim=0)
    return _finish_table_solve(ts, tab, memb_g, orig_slot, init_label,
                               (t, h, w), params, thetas, level_rounds,
                               has_constraints)


# ---------------------------------------------------------------------------
# Pixel solver (v1, edge_table=False): every round folds the stencil over
# the voxels; after `compact_after_levels` levels the region slots are
# renumbered into a table of r_cap slots plus an inert sink.


def _features(state: SolverState, label3):
    """Per-slot [mean, size, constr, fin, frozen] gathered at each voxel's
    root (the JAX package packs them into one float32 slab; constraint ids
    and finalize levels ride there exactly, so separate gathers are the
    same values)."""
    mean = state.csum / torch.clamp(state.size, min=1.0)[:, None]
    return (mean, _take(mean, label3), _take(state.size, label3),
            _take(state.constr, label3), _take(state.fin, label3),
            _take(state.frozen, label3))


def _round(state: SolverState, vol, flow, theta, up, mode, n, sink,
           p: OversegParams, use_temporal: bool = True):
    """One Boruvka round over the voxels (JAX `_round`): each voxel folds
    its forward spatial and backward temporal (flow-displaced with flow)
    neighbours into the lexicographic minimum (bucket, partner) admissible
    edge, then regions select and hook.  `n` is the segment-domain size,
    `sink` the inert overflow slot (-1 before compaction): sink regions
    never merge.  `use_temporal=False` drops the temporal directions (the
    two-stage spatial pre-pass).  A neighbour's region attributes are
    gathered by its label, and every use sits under `valid`, so the
    zero-filled first frame of the flow directions is never read."""
    t, h, w, _ = vol.shape
    label3 = state.label.reshape(t, h, w)
    mean, own_mean, own_size, own_constr, own_fin, _ = \
        _features(state, label3)
    is_min_size = mode == MODE_MIN_SIZE
    own_small = own_size < p.min_region_size
    own_live = label3 != sink

    def fold(carry, d: _RawDir):
        if d.temporal and not use_temporal:
            return carry
        best_bucket, best_partner = carry
        nb = d.nb_label
        act = d.valid & (nb != label3) & own_live & (nb != sink)
        nb_constr = _take(state.constr, nb)
        either_free = (own_constr < 0) | (nb_constr < 0)
        if is_min_size:
            both_constr_diff = ~either_free & (own_constr != nb_constr)
            adm = own_small & ~both_constr_diff & (d.bucket <= theta)
        else:
            dd = _desc_distance(own_mean, _take(mean, nb), d.bucket, p)
            regular = (either_free & (d.bucket < own_fin)
                       & (d.bucket < _take(state.fin, nb))
                       & (dd < p.merge_threshold))
            constr_same = (~either_free & (own_constr == nb_constr)
                           & (dd <= p.split_threshold))
            adm = (d.bucket <= theta) & (regular | constr_same)
        adm = act & adm
        bkt = torch.where(adm, d.bucket, I32MAX)
        take = adm & ((bkt < best_bucket)
                      | ((bkt == best_bucket) & (nb < best_partner)))
        return (torch.where(take, bkt, best_bucket),
                torch.where(take, nb, best_partner))

    init = (torch.full((t, h, w), I32MAX, dtype=torch.int32,
                       device=vol.device),) * 2
    best_bucket, best_partner = _fold_dirs_raw(vol, label3, p.metric, fold,
                                               init, flow)
    partner = _select_partners(best_bucket.reshape(-1),
                               best_partner.reshape(-1), state.label, n)
    return _apply_merge(state, partner, n, up=up,
                        pair_gate=_pair_gate(p, is_min_size))


def _level_end(state: SolverState, vol, flow, theta, n, p: OversegParams,
               use_temporal: bool = True):
    """Level-end finalization and unconstraining over the voxels (JAX
    `_level_end`): both views of every edge, i.e. all eight spatial
    directions, the backward temporal ones (flow-displaced with flow) and
    the forward temporal ones, which stay undisplaced even with flow, as
    in the JAX package."""
    t, h, w, _ = vol.shape
    label3 = state.label.reshape(t, h, w)
    mean, own_mean, own_size, own_constr, own_fin, own_frozen = \
        _features(state, label3)

    def fold(carry, d: _RawDir):
        if d.temporal and not use_temporal:
            return carry
        fail_min, uncon_any = carry
        nb = d.nb_label
        act = d.valid & (nb != label3) & (d.bucket <= theta)
        dd = _desc_distance(own_mean, _take(mean, nb), d.bucket, p)
        nb_constr = _take(state.constr, nb)
        either_free = (own_constr < 0) | (nb_constr < 0)
        fail = (act & either_free & (d.bucket < own_fin)
                & (d.bucket < _take(state.fin, nb))
                & (dd >= p.merge_threshold))
        split = (act & ~either_free & (own_constr == nb_constr)
                 & (dd > p.split_threshold))
        # The own side is unconstrained unless the neighbour is much
        # smaller (it then unconstrains itself from its own view); frozen
        # regions never are.
        uncon = (split & ~(_take(state.size, nb) < 0.3 * own_size)
                 & ~own_frozen)
        return (torch.minimum(fail_min, torch.where(fail, d.bucket, I32MAX)),
                uncon_any | uncon)

    init = (torch.full((t, h, w), I32MAX, dtype=torch.int32,
                       device=vol.device),
            torch.zeros((t, h, w), dtype=torch.bool, device=vol.device))
    fail_min, uncon_any = _fold_dirs_raw(vol, label3, p.metric, fold, init,
                                         flow, spatial_dirs=SPATIAL_ALL,
                                         temporal_fwd=True)
    fail_r = seg_min(fail_min.reshape(-1), state.label, n)
    uncon_r = seg_max(uncon_any.reshape(-1).to(torch.int32), state.label,
                      n) > 0
    return state._replace(fin=torch.minimum(state.fin, fail_r),
                          constr=torch.where(uncon_r, -1, state.constr))


def _compact(state: SolverState, n_pix: int, r_cap: int):
    """Renumber the roots, in slot order, into a table of r_cap slots plus
    the sink slot r_cap, where roots beyond the table go (JAX `_compact`).
    Returns the compact state (per-voxel compact memberships) and the
    per-voxel root before compaction, for the final labels."""
    slots = _arange(n_pix, state.label)
    is_root = state.label == slots
    cidx_all = torch.cumsum(is_root.to(torch.int32), 0,
                            dtype=torch.int32) - 1
    ok = is_root & (cidx_all < r_cap)
    cidx = torch.where(ok, cidx_all, r_cap)
    nseg = r_cap + 1
    # Colour sums are summed over every slot (non-roots hold zeros), the
    # other statistics over roots only, as in the JAX package.
    csum = seg_sum(state.csum, cidx, nseg)
    size = seg_sum(torch.where(is_root, state.size, 0.0), cidx, nseg)
    constr = seg_max(torch.where(is_root, state.constr, -1), cidx, nseg)
    fin = seg_min(torch.where(is_root, state.fin, I32MAX), cidx, nseg)
    frozen = seg_max((is_root & state.frozen).to(torch.int32), cidx,
                     nseg) > 0
    # The sink never merges: finalize level 0, unconstrained.
    fin[r_cap] = 0
    constr[r_cap] = -1
    return (SolverState(_take(cidx, state.label), csum, size, constr, fin,
                        frozen), state.label)


def _solve_pixel(vol, flow, init_label, constr_init, frozen_init, fin_init,
                 params: OversegParams, thetas, level_rounds,
                 has_constraints: bool):
    """The v1 pixel solver (the `edge_table=False` body of JAX `_solve`):
    seed sums over `init_label`, the optional two-stage spatial pre-pass,
    phase A's levels in voxel slot space, compaction, phase B's levels
    over compact memberships, the final min-size pass, the constraint
    merge and the labels in original root-voxel space.  The result has no
    `label16`; its diag holds per level [segment-domain size, merge rounds
    used, live regions after the level]."""
    t, h, w, _ = vol.shape
    n_pix = t * h * w
    dev = vol.device
    n_levels = len(thetas)
    diag = np.zeros((n_levels, 3), np.int32)

    stats = seg_sum(torch.cat([vol.reshape(n_pix, 3),
                               torch.ones((n_pix, 1), dtype=torch.float32,
                                          device=dev)], 1), init_label, n_pix)
    state = SolverState(
        init_label, stats[:, 0:3], stats[:, 3],
        seg_max(constr_init, init_label, n_pix),
        seg_min(fin_init, init_label, n_pix),
        seg_max(frozen_init.to(torch.int32), init_label, n_pix) > 0)

    def run_rounds(st, theta, max_rounds, mode, n, sink, use_temporal=True,
                   fin_each=False):
        # Hook parity alternates per round and restarts with every call;
        # the phase ends once no admissible edge remains, or after two
        # merge-free rounds (both parities blocked).
        scan_each = fin_each and params.fin_every_round
        i = idle = 0
        while idle < 2 and i < max_rounds:
            if scan_each:
                st = _level_end(st, vol, flow, theta, n, params, use_temporal)
            st, moved, cands = _round(st, vol, flow, theta, (i % 2) == 0,
                                      mode, n, sink, params, use_temporal)
            moved, cands = torch.stack([moved, cands]).tolist()
            idle = 2 if cands == 0 else (0 if moved > 0 else idle + 1)
            i += 1
        return st, i

    def level(st, lvl, n, sink, use_temporal=True):
        st, used = run_rounds(st, thetas[lvl], level_rounds[lvl], MODE_MERGE,
                              n, sink, use_temporal, fin_each=True)
        st = _level_end(st, vol, flow, thetas[lvl], n, params, use_temporal)
        if params.min_size_interleave and params.min_region_size > 1:
            st, _ = run_rounds(st, thetas[lvl], params.min_size_interleave,
                               MODE_MIN_SIZE, n, sink, use_temporal)
        live = (st.size > 0) & (_arange(n, vol) != sink)
        diag[lvl] = (n, used, int(live.sum()))
        return st

    if params.two_stage:
        # Spatial-only pre-pass over the whole schedule
        # (SegmentGraphSpatially, dense_segmentation_graph.h:406-416); its
        # finalizations carry into the full pass.
        for lvl in range(n_levels):
            state = level(state, lvl, n_pix, -1, use_temporal=False)

    n_a = min(max(params.compact_after_levels, 0), n_levels)
    for lvl in range(n_a):
        state = level(state, lvl, n_pix, -1)

    r_cap = min(max(n_pix // params.compact_divisor, 1 << 14), n_pix)
    nseg = r_cap + 1
    state, orig_label = _compact(state, n_pix, r_cap)
    for lvl in range(n_a, n_levels):
        state = level(state, lvl, nseg, r_cap)

    if params.min_region_size > 1:
        state, _ = run_rounds(state, NUM_BUCKETS, params.min_size_rounds,
                              MODE_MIN_SIZE, nseg, r_cap)
    if has_constraints:
        state = _merge_constrained(state, params.max_constraints, nseg,
                                   params)

    # Each compact region takes its minimum original root; sink voxels keep
    # their phase-A root.  The sink pools unrelated overflow regions, so
    # its attributes are dropped (they come out unconstrained, size 0).
    orig_min = seg_min(orig_label, state.label, nseg)
    final = torch.where(state.label == r_cap, orig_label,
                        _take(orig_min, state.label))
    live = (state.size > 0) & (_arange(nseg, vol) != r_cap)
    return OversegResult(label=final.reshape(t, h, w),
                         constr=torch.where(live, state.constr, -1),
                         size=torch.where(live, state.size, 0.0),
                         orig=torch.where(live, orig_min, -1), diag=diag)


def _check_scope(params: OversegParams) -> None:
    """Raise for the solver configurations the JAX package refuses, and
    for supertile settings the K3 levels cannot hold (the pixel solver has
    no supertile levels)."""
    if not params.edge_table:
        if params.descriptor != "color_mean":
            raise ValueError("descriptor traits other than color_mean "
                             "require the edge-table solver "
                             "(edge_table=True)")
        if params.gradient_trait:
            raise ValueError("the gradient trait requires the edge-table "
                             "solver (edge_table=True)")
        return
    if params.st_levels > 0:
        # Packed K3 keys hold 12 partner bits; the slot grid is 128 wide.
        if not (0 < params.st_slots <= 4096 and params.st_slots % 128 == 0):
            raise ValueError(f"st_slots={params.st_slots}: supertile tables "
                             "need a multiple of 128, at most 4096")
        # The last level must be global: every level below st_levels defers
        # cross-supertile and constrained merges.
        if params.st_levels >= len(params.schedule):
            raise ValueError(f"st_levels={params.st_levels} leaves no global "
                             f"level of the {len(params.schedule)}-level "
                             "schedule")


def _solve_schedule(params: OversegParams):
    """(thetas, level_rounds) of params.schedule."""
    thetas = [int(x) for x in params.schedule]
    return thetas, ([params.max_rounds_per_level] * (len(thetas) - 1)
                    + [params.max_final_rounds])


def oversegment(vol, flow=None, constraints=None, init_label=None,
                frozen=None, fin=None,
                params: OversegParams = OversegParams(),
                cell_stats=None, head_planes: int = 0) -> OversegResult:
    """Over-segment a chunk volume: the edge-table solver, or the v1
    pixel solver with `params.edge_table=False`.

    Args mirror the JAX `oversegment`: vol (T,H,W,3) float32 smoothed BGR
    in [0,1]; optional (T-1,H,W,2) float32 backward `flow` of frames
    1..T-1; optional (T,H,W) constraints (int, -1 free), init_label,
    frozen (bool), fin (int levels or bool); `cell_stats` (size, c0, c1,
    c2) cell-positioned at root voxels as `tile_felzenszwalb` exports;
    `head_planes` leading planes of host-built constraint groups (the
    pixel solver ignores both, as in the JAX package).  All tensors live
    on vol's device; the solve runs there.
    """
    _check_scope(params)
    t, h, w, _ = vol.shape
    n = t * h * w
    dev = vol.device
    if init_label is None:
        init_label = torch.arange(n, dtype=torch.int32, device=dev)
    else:
        init_label = init_label.reshape(n).to(torch.int32)
    has_constraints = constraints is not None
    constr_init = (constraints.reshape(n).to(torch.int32) if has_constraints
                   else torch.full((n,), -1, dtype=torch.int32, device=dev))
    frozen_init = (frozen.reshape(n).to(torch.bool) if frozen is not None
                   else torch.zeros(n, dtype=torch.bool, device=dev))
    if fin is None:
        fin_init = torch.full((n,), NUM_BUCKETS, dtype=torch.int32,
                              device=dev)
    elif fin.dtype == torch.bool:
        fin_init = torch.where(fin.reshape(n), 0, NUM_BUCKETS) \
            .to(torch.int32)
    else:
        fin_init = fin.reshape(n).to(torch.int32)
    thetas, level_rounds = _solve_schedule(params)
    if not params.edge_table:
        return _solve_pixel(vol, None if flow is None
                            else flow.to(torch.float32), init_label,
                            constr_init, frozen_init, fin_init, params,
                            thetas, level_rounds, has_constraints)
    return _solve_edge_table(vol, init_label, constr_init, frozen_init,
                             fin_init, params, n, thetas, level_rounds,
                             has_constraints, cell_stats, head_planes,
                             None if flow is None else flow.to(torch.float32))
