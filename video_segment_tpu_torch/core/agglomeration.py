"""Batched hierarchical region agglomeration on torch tensors.

Port of video_segment_tpu/core/agglomeration.py (see its docstring):
budgeted parallel merge subrounds per hierarchy level over SquaredOR
appearance distances scaled by the size penalizer, counterpart-constraint
forcing, and static phases of shrinking table size with per-subround
re-evaluation in the small phases.  The JAX program's `while_loop` /
`fori_loop` levels become Python loops (one host sync per subround).
Edge weights combine the appearance chi-square (of the region histograms,
or of the per-window histograms under windowed appearance,
`edge_color_distance_windowed`) with the per-frame flow chi-square
(`edge_flow_distance`) when flow tables are given and `use_flow` is set;
per-frame flow and per-window tables merge with the other statistics.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from video_segment_tpu_torch import device as devmod
from video_segment_tpu_torch.core.oversegmentation import (I32MAX, seg_max,
                                                          seg_min, seg_sum)
from video_segment_tpu_torch.ops import cc, histograms as hops
from video_segment_tpu_torch.runtime.trace import Trace

_DQ = 1 << 20  # distance quantization for integer keys
_I64MAX = 2 ** 63 - 1


class AggloState(NamedTuple):
    label: torch.Tensor      # (C,) slot -> current root (C = phase cap)
    hist: torch.Tensor       # (C,B) color histograms (unnormalized)
    flow_hist: torch.Tensor  # (T,C,FB) per-frame flow histograms
    flow_cnt: torch.Tensor   # (T,C) per-frame flow vector counts
    sizes: torch.Tensor      # (C,) f32
    win_hist: torch.Tensor   # (NW,C,B) windowed appearance (NW=0: unused)
    win_cnt: torch.Tensor    # (NW,C) window sample counts


def _arange(n, like):
    return torch.arange(n, dtype=torch.int32, device=like.device)


def _wrap32(x: int) -> int:
    """Python int -> int32 two's-complement value (JAX int32 arithmetic)."""
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


def _eval_distances(state: AggloState, edges, evalid, inv_median, use_flow,
                    penalizer):
    ra = state.label.index_select(0, edges[:, 0])
    rb = state.label.index_select(0, edges[:, 1])
    pairs = torch.stack([ra, rb], dim=1)
    if state.win_hist.shape[0] > 0:
        # WindowedAppearanceDescriptor replaces the single-histogram
        # appearance distance (region_descriptor.cpp:207-276).
        color_d = hops.edge_color_distance_windowed(state.win_hist,
                                                    state.win_cnt, pairs)
    else:
        color_d = hops.edge_color_distance(state.hist, pairs)
    # Without flow tables, or with flow disabled, the JAX package combines
    # a zero flow distance, which leaves the appearance term unchanged.
    use_flow = use_flow and state.flow_hist.shape[0] > 0
    flow_d = (hops.edge_flow_distance(state.flow_hist, state.flow_cnt, pairs)
              if use_flow else None)
    d = hops.combined_distance(color_d, flow_d, state.sizes[ra.long()],
                               state.sizes[rb.long()], inv_median,
                               penalizer=penalizer, use_flow=use_flow)
    return torch.where(evalid & (ra != rb), d, torch.inf)


def _kth_smallest(key, budget: int) -> int:
    """`budget`-th smallest (1-based) of int32 `key` (entries in [0,_DQ] or
    I32MAX) via the two-pass radix histogram select of the JAX package."""
    n = key.shape[0]
    budget = min(max(budget, 1), n)
    nb = (_DQ >> 10) + 2
    coarse = torch.clamp(key >> 10, max=(_DQ >> 10) + 1)
    c1 = torch.cumsum(torch.bincount(coarse, minlength=nb), 0)
    b = int(torch.searchsorted(c1, torch.tensor([budget],
                                                device=key.device)))
    rank = budget - (int(c1[b - 1]) if b > 0 else 0)
    fine = torch.where(coarse == b, key & 1023, 1024)
    c2 = torch.cumsum(torch.bincount(fine, minlength=1025), 0)
    f = int(torch.searchsorted(c2, torch.tensor([rank], device=key.device)))
    return I32MAX if b > (_DQ >> 10) else (b << 10) | f


def _label_subround(label, edges, d, budget: int, up: bool):
    """One label-only merge subround over distances d."""
    r = label.shape[0]
    ra = label.index_select(0, edges[:, 0])
    rb = label.index_select(0, edges[:, 1])
    act = torch.isfinite(d) & (ra != rb)
    dq = torch.where(act, d * _DQ, 0.0)
    key = torch.where(act, torch.clamp(dq.to(torch.int32), 0, _DQ), I32MAX)

    seg = torch.cat([ra, rb])
    k2 = torch.cat([key, key])
    partner2 = torch.cat([rb, ra])
    best = seg_min(k2, seg, r)
    at_min = (k2 == best.index_select(0, seg)) & (k2 < I32MAX)
    partner = seg_min(torch.where(at_min, partner2, I32MAX), seg, r)

    kth = _kth_smallest(torch.where(partner < I32MAX, best, I32MAX), budget)
    admit = ((partner < I32MAX) & (best <= kth) & (best < I32MAX)
             & (budget > 0))
    slots = _arange(r, label)
    hook = admit & ((partner > slots) == up)
    root = cc.pointer_jump(torch.where(hook, partner, slots))
    moved = int((root != slots).sum())
    return root.index_select(0, label), moved


def _reaggregate(state: AggloState) -> AggloState:
    """Re-aggregate every statistics table onto current roots."""
    r = state.label.shape[0]
    seg = state.label
    def by_root(x):
        return torch.zeros_like(x).index_add_(1, seg, x)

    return AggloState(state.label, seg_sum(state.hist, seg, r),
                      by_root(state.flow_hist), by_root(state.flow_cnt),
                      seg_sum(state.sizes, seg, r), by_root(state.win_hist),
                      by_root(state.win_cnt))


def _force_constraints(label, constr, b2c):
    """Force-merge current roots whose base members share a counterpart
    constraint, iterated to a fixed point (at most 32 passes)."""
    cap = label.shape[0]
    rcap = constr.shape[0]
    slots = _arange(cap, label)
    has_c = constr >= 0
    cid = torch.clamp(constr, 0, rcap - 1)
    for _ in range(32):
        root_b = label.index_select(0, b2c)
        rep = seg_min(torch.where(has_c, root_b, I32MAX), cid, rcap)
        tgt = torch.where(has_c, rep.index_select(0, cid), I32MAX)
        partner = seg_min(torch.where(has_c & (tgt != root_b), tgt, I32MAX),
                          root_b, cap)
        hook = (partner < I32MAX) & (partner < slots)
        lab2 = cc.pointer_jump(torch.where(hook, partner, slots)) \
            .index_select(0, label)
        changed = not torch.equal(lab2, label)
        label = lab2
        if not changed:
            break
    return label


def _level_step(state: AggloState, edges, evalid, constr, b2c,
                is_level0: bool, max_region_num: int, min_region_num: int,
                cutoff_fraction: float, use_flow: bool, penalizer: float,
                max_subrounds: int, reeval: bool):
    """One hierarchy level (see the JAX `_level_step`)."""
    cap = state.label.shape[0]
    rcap = constr.shape[0]
    slots = _arange(cap, state.label)
    active_mask = (state.label == slots) & (state.sizes > 0)
    active = int(active_mask.sum())

    if is_level0 and active > max_region_num:
        cut_target = max_region_num
    else:
        cut_target = max(min_region_num, int(np.float32(active)
                                             * np.float32(cutoff_fraction)))
    has_c = constr >= 0
    cid = torch.clamp(constr, 0, rcap - 1)
    root_b = state.label.index_select(0, b2c)
    # The JAX package sums segment_max over ALL segments, empty ones
    # included (identity INT32_MIN), in wrapping int32 arithmetic; the
    # port reproduces that value exactly (ROADMAP.md, Queue 3, R5).
    n_croots = _wrap32(int(seg_max(has_c.to(torch.int32),
                                   torch.where(has_c, root_b, 0),
                                   cap).sum()))
    n_cids = _wrap32(int(seg_max(has_c.to(torch.int32), cid, rcap).sum()))
    anticipated = max(_wrap32(n_croots - n_cids), 0)
    budget_total = max(active - cut_target - anticipated, 0)

    sz_sorted = torch.sort(torch.where(active_mask, state.sizes,
                                       torch.inf)).values
    median = sz_sorted[min(max(active // 2, 0), cap - 1)]
    inv_median = 1.0 / torch.clamp(median, min=1.0)

    label = state.label
    merged = 0
    if reeval:
        for k in range(max_subrounds):
            st_k = _reaggregate(state._replace(label=label))
            d = _eval_distances(st_k, edges, evalid, inv_median, use_flow,
                                penalizer)
            rem_rounds = max_subrounds - k
            quota = (budget_total - merged + rem_rounds - 1) // rem_rounds
            label, moved = _label_subround(label, edges, d, quota,
                                           (k % 2) == 0)
            merged += moved
    else:
        dd = _eval_distances(state, edges, evalid, inv_median, use_flow,
                             penalizer)
        for k in range(max_subrounds):
            label, moved = _label_subround(label, edges, dd,
                                           budget_total - merged,
                                           (k % 2) == 0)
            merged += moved
            ra = label.index_select(0, edges[:, 0])
            rb = label.index_select(0, edges[:, 1])
            dd = torch.where(ra != rb, dd, torch.inf)

    label = _force_constraints(label, constr, b2c)
    state = _reaggregate(state._replace(label=label))
    active_after = int(((state.label == slots) & (state.sizes > 0)).sum())
    return state, active_after


def _compact_phase(state: AggloState, b2c, c2o, edges, evalid,
                   new_cap: int, new_ecap: int):
    """Renumber live roots into a `new_cap`-slot table, gather statistics
    rows, and deduplicate the edge list into `new_ecap` rows."""
    old_cap = state.label.shape[0]
    root = state.label
    slots = _arange(old_cap, root)
    is_root = (root == slots) & (state.sizes > 0)
    cidx_all = torch.cumsum(is_root.to(torch.int32), 0,
                            dtype=torch.int32) - 1
    ok = is_root & (cidx_all < new_cap)
    cidx = torch.where(ok, cidx_all, new_cap - 1)
    n_active = int(ok.sum())

    inv = torch.zeros(new_cap, dtype=torch.int32, device=root.device) \
        .scatter_reduce_(0, torch.where(ok, cidx_all, 0).long(),
                         torch.where(ok, slots, 0), "amax")
    valid_new = _arange(new_cap, root) < n_active
    vf = valid_new.to(torch.float32)
    new_state = AggloState(
        _arange(new_cap, root),
        state.hist.index_select(0, inv) * vf[:, None],
        state.flow_hist.index_select(1, inv) * vf[None, :, None],
        state.flow_cnt.index_select(1, inv) * vf[None, :],
        state.sizes.index_select(0, inv) * vf,
        state.win_hist.index_select(1, inv) * vf[None, :, None],
        state.win_cnt.index_select(1, inv) * vf[None, :])
    b2c_new = cidx.index_select(0, root.index_select(0, b2c))
    c2o_new = c2o.index_select(0, inv)

    ea = cidx.index_select(0, root.index_select(0, edges[:, 0]))
    eb = cidx.index_select(0, root.index_select(0, edges[:, 1]))
    lo = torch.minimum(ea, eb)
    hi = torch.maximum(ea, eb)
    valid = evalid & (lo != hi)
    # The JAX package forms this key in int32, which wraps once lo * new_cap
    # passes 2^31 (sets of more than 262144 regions, ROADMAP.md Queue 3,
    # R8); the port keys in int64, which orders every smaller set alike.
    key = torch.where(valid, lo.long() * new_cap + hi, _I64MAX)
    key_s = torch.sort(key).values
    first = torch.ones_like(key_s, dtype=torch.bool)
    first[1:] = key_s[1:] != key_s[:-1]
    key_u = torch.sort(torch.where(first, key_s, _I64MAX)).values[:new_ecap]
    evalid_new = key_u < _I64MAX
    ea2 = torch.where(evalid_new, key_u // new_cap, 0).to(torch.int32)
    eb2 = torch.where(evalid_new, key_u % new_cap, 0).to(torch.int32)
    return (new_state, b2c_new, c2o_new, torch.stack([ea2, eb2], dim=1),
            evalid_new)


def _next_pow2(x: int) -> int:
    return 1 << max(0, (int(x) - 1).bit_length())


def _phase_specs(rcap: int, ecap: int, reeval_cap: int, floor: int,
                 edge_degree: int) -> tuple:
    """Static (cap, edge_cap, reeval) per phase (see the JAX package)."""
    if rcap <= 2048:
        return ((rcap, ecap, True),)
    caps = [rcap]
    while caps[-1] // 2 >= floor:
        caps.append(caps[-1] // 2)
    specs = []
    for i, c in enumerate(caps):
        e = ecap if i == 0 else min(ecap, _next_pow2(c * edge_degree))
        specs.append((c, e, c <= reeval_cap))
    return tuple(specs)


def _run_all_levels(state: AggloState, edges, evalid, constr_stack,
                    max_region_num, min_region_num, cutoff_fraction,
                    use_flow, penalizer, max_subrounds: int,
                    max_levels: int, phases: tuple):
    """Every hierarchy level over the static shrinking phases.  Returns
    (per-level labels over the original slots, per-level active counts)."""
    rcap = state.label.shape[0]
    slots0 = _arange(rcap, state.label)
    active = int(((state.label == slots0) & (state.sizes > 0)).sum())
    labels_out = torch.zeros((max_levels, rcap), dtype=torch.int32,
                             device=state.label.device)
    actives = np.zeros(max_levels, np.int32)
    b2c = slots0
    c2o = slots0
    lvl = 0
    for p, (cap, ecap_p, reeval) in enumerate(phases):
        if p > 0:
            state, b2c, c2o, edges, evalid = _compact_phase(
                state, b2c, c2o, edges, evalid, cap, ecap_p)
        next_cap = phases[p + 1][0] if p + 1 < len(phases) else 0
        while (lvl < max_levels and active > min_region_num
               and (not next_cap or active >= next_cap)):
            state, active = _level_step(
                state, edges, evalid, constr_stack[lvl], b2c, lvl == 0,
                max_region_num, min_region_num, cutoff_fraction, use_flow,
                penalizer, max_subrounds, reeval)
            labels_out[lvl] = c2o.index_select(
                0, state.label.index_select(0, b2c))
            actives[lvl] = active
            lvl += 1
    return labels_out.cpu().numpy(), actives


def _upload(dev, hist, flow_hist, flow_cnt, sizes, win_hist,
            win_cnt) -> AggloState:
    """The chunk set's statistics tables on `dev`, copied dense.

    The JAX package uploads each table of 2^20 elements or more as COO
    (int32 keys and float32 values) and scatters it on the device
    (`_scatter_table`, `_to_device_sparse`): its host reached the TPU over
    a remote link of 30-60 MB/s, where the dense (rows, 4000) histograms,
    about 95% zeros, were the largest cost of agglomeration.  Its int32
    keys also stop it at 2^31 elements, so at any set of 524,288 regions
    or more (ROADMAP.md Queue 3, R10).  The card here sits on the host's
    own PCIe link, so the port copies every table dense: no key limit, no
    scatter, no second table-sized buffer on the card.  Bench config 4's
    full set (729,214 regions, a (1048576, 4000) table of 15.6 GiB) took
    3.764 s to upload from pageable memory, 4.46 GB/s, against 108.2 s in
    the region stage over the 140-frame stream (one run of that stream,
    NVIDIA H100 80GB HBM3, 700.00 W; CHANGES.md keeps it, and
    `chip_smoke.py` phase 29 still runs the stream as a check); finding
    the table's nonzeros for COO is itself a host pass over all 16.8 GB."""
    def put(x):
        if isinstance(x, torch.Tensor):   # e.g. gathered from a mesh
            return x.to(dev, torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    return AggloState(_arange(hist.shape[0], torch.empty(0, device=dev)),
                      put(hist), put(flow_hist), put(flow_cnt), put(sizes),
                      put(win_hist), put(win_cnt))


def agglomerate(hist, flow_hist, flow_cnt, sizes, edges, num_regions: int,
                *, min_region_num: int = 10, max_region_num: int = 10000,
                cutoff_fraction: float = 0.8, penalizer: float = 0.25,
                use_flow: bool = True, max_subrounds: int = 6,
                constraints=None, win_hist=None, win_cnt=None,
                reeval_cap: int = 1024, phase_floor: int = 256,
                edge_degree: int = 16,
                device: str | torch.device = "cuda",
                trace: Trace | None = None):
    """Run the full level loop on `device`; returns a list of per-level
    (R,) root arrays (numpy).  Arguments as in the JAX `agglomerate`
    (flow_hist (T,R,FB), flow_cnt (T,R); T=0 without flow; windowed
    appearance tables win_hist (NW,R,B) and win_cnt (NW,R), whose distance
    replaces the single histogram's when NW > 0).  The tables are copied
    to `device` dense, where the JAX package scatters COO (`_upload` says
    why).  Given a `trace` (`runtime/trace.py`), the copies to the device
    are its `region.upload` span, the level loop through its labels on the
    host its `region.levels` span, and the statistics tables' bytes are
    added to its `region.table_bytes` counter."""
    dev = devmod.resolve(device)
    trace = trace if trace is not None else Trace()
    r = hist.shape[0]
    if win_hist is None:
        win_hist = np.zeros((0, r, hist.shape[1]), np.float32)
        win_cnt = np.zeros((0, r), np.float32)
    max_levels = 40
    with trace.span("region.upload"):
        state = _upload(dev, hist, flow_hist, flow_cnt, sizes, win_hist,
                        win_cnt)
        edges = np.asarray(edges, np.int32)
        if edges.shape[0] == 0:
            edges = np.zeros((1, 2), np.int32)  # inert self-edge
        edges = torch.as_tensor(edges, device=dev)
        ecap = int(edges.shape[0])
        evalid = torch.ones(ecap, dtype=torch.bool, device=dev)

        constr_stack = np.full((max_levels, r), -1, np.int32)
        if constraints is not None:
            for lv in range(min(len(constraints), max_levels)):
                constr_stack[lv] = constraints[lv]
        constr_stack = torch.as_tensor(constr_stack, device=dev)
    trace.count("region.table_bytes",
                sum(t.numel() * t.element_size() for t in state[1:]))

    with trace.span("region.levels"):
        phases = _phase_specs(r, ecap, reeval_cap=reeval_cap,
                              floor=min(phase_floor, r),
                              edge_degree=edge_degree)
        labels_out, actives = _run_all_levels(
            state, edges, evalid, constr_stack, max_region_num,
            min_region_num, float(np.float32(cutoff_fraction)),
            bool(use_flow), float(np.float32(penalizer)), max_subrounds,
            max_levels, phases)

        levels = []
        active = num_regions
        for lv in range(max_levels):
            if active <= min_region_num:
                break
            new_active = int(actives[lv])
            if new_active == 0 or new_active >= active:
                break
            active = new_active
            levels.append(labels_out[lv].copy())
    return levels
