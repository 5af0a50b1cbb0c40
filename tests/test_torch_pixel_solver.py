"""The port's v1 pixel solver (OversegParams(edge_table=False)) against the
JAX `oversegment`.

Inputs are made with numpy from a seed (the textured volumes, felz
pre-segmentations, head planes and flows of
tests/test_torch_oversegmentation.py, plus a uniform-noise volume that
overflows the compact table into the sink).  label, constr, size and orig
must be exact.  The unit cases hold `_compact` and the direction sets of
the pixel folds (the level end's forward temporal directions stay
undisplaced under flow) to the JAX functions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_oversegmentation import _flow, _inputs, _volume
from video_segment_tpu.core import oversegmentation as jov
from video_segment_tpu_torch.core import oversegmentation as tov

torch.set_num_threads(2)

FIELDS = ("label", "constr", "size", "orig")


def _sink_inputs():
    """Uniform noise, one seed a voxel, a 64th of the voxels as compact
    table (floored at 16384 slots): phase A leaves far more roots than
    slots, so most voxels fall into the sink and keep their phase-A
    roots."""
    rng = np.random.default_rng(4)
    vol = rng.random((3, 32, 512, 3)).astype(np.float32)
    return vol, dict(params=jov.OversegParams(edge_table=False,
                                              compact_divisor=64,
                                              min_region_size=20))


def _case(name):
    """(vol, keyword arguments of `oversegment`) for a named case."""
    if name == "sink":
        return _sink_inputs()
    if name == "identity":
        # One seed a voxel with a table as large as the volume (the
        # default half-size table overflows on this texture: see "sink").
        vol = _volume(12, (3, 32, 512))
        return vol, dict(params=jov.OversegParams(edge_table=False,
                                                  compact_divisor=1,
                                                  min_region_size=20))
    constrained = name.startswith("head_planes") or name in KNOBS
    vol, init, fin, params, kw = _inputs(11, constrained)
    kw = dict(kw, init_label=init, fin=fin)
    if name.endswith("flow"):
        kw["flow"] = _flow(21)
    knob = KNOBS.get(name, {})
    kw["params"] = params._replace(edge_table=False, **knob)
    return vol, kw


KNOBS = {
    "two_stage": dict(two_stage=True),
    "pair_merge": dict(pair_merge=True),
    "pair_merge_minsize": dict(pair_merge_minsize=True),
    "fin_every_round": dict(fin_every_round=True),
    "min_size_interleave": dict(min_size_interleave=2),
    "l1": dict(metric="l1", force_merge_weight=0.002),
}


def _run_jax(vol, kw):
    args = {k: (tuple(jnp.asarray(x) for x in v) if k == "cell_stats"
                else (jnp.asarray(v) if isinstance(v, np.ndarray) else v))
            for k, v in kw.items()}
    return jov.oversegment(jnp.asarray(vol), **args)


def _run_port(vol, kw):
    args = {k: (tuple(torch.from_numpy(x) for x in v) if k == "cell_stats"
                else (torch.from_numpy(v) if isinstance(v, np.ndarray)
                      else v))
            for k, v in kw.items()}
    args["params"] = tov.params_from_jax(kw["params"])
    return tov.oversegment(torch.from_numpy(vol), **args)


def _assert_equal(got, want):
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)


@pytest.mark.parametrize("case", ["free", "head_planes", "identity", "sink",
                                  "free_flow", "head_planes_flow"]
                         + list(KNOBS))
def test_pixel_solver_matches_jax(case):
    """Felz presegs with their fin levels (free and with constrained head
    planes whose plane 0 is frozen), one seed a voxel, the sink overflow,
    random flow, and the off-default knobs the round loop carries (on the
    constrained inputs): exact against JAX."""
    vol, kw = _case(case)
    want = _run_jax(vol, kw)
    got = _run_port(vol, kw)
    _assert_equal(got, want)
    assert got.label16 is None and got.lut is None
    n_levels = len(kw["params"].schedule)
    assert got.diag.shape == (n_levels, 3)
    nreg = len(np.unique(got.label.numpy()))
    if case == "sink":
        # The table keeps a few live slots; the sink voxels keep tens of
        # thousands of phase-A roots (all dead in the attribute tables).
        live = int((got.size.numpy() > 0).sum())
        assert live < 100 and nreg > 20000, (live, nreg)
        assert (got.orig.numpy() >= 0).sum() == live
    else:
        assert 2 < nreg < vol[..., 0].size // 20, nreg
    if case.endswith("flow"):
        no_flow = _run_jax(vol, {k: v for k, v in kw.items()
                                 if k != "flow"})
        assert not np.array_equal(np.asarray(no_flow.label),
                                  got.label.numpy())


def test_pixel_solver_ignores_cell_stats_and_head_planes():
    """v1 takes and ignores `cell_stats` and `head_planes`, as JAX does."""
    vol, kw = _case("head_planes")
    bare = {k: v for k, v in kw.items()
            if k not in ("cell_stats", "head_planes")}
    _assert_equal(_run_port(vol, kw), _run_jax(vol, bare))


def test_compact_matches_jax():
    """`_compact` on a merged pixel state: slot-order renumbering, roots
    over the table go to the sink, sums over roots only (colour sums over
    every slot), the sink pinned at fin 0 and constr -1."""
    rng = np.random.default_rng(8)
    n, r_cap = 4000, 300
    root = np.sort(rng.choice(n, 500, replace=False)).astype(np.int32)
    label = root[rng.integers(0, 500, n)]
    label[root] = root
    js = jov.SolverState(
        jnp.asarray(label),
        jnp.asarray(rng.random((n, 3)).astype(np.float32)),
        jnp.asarray(rng.integers(1, 50, n).astype(np.float32)),
        jnp.asarray(np.where(rng.random(n) < 0.2, rng.integers(0, 9, n),
                             -1).astype(np.int32)),
        jnp.asarray(rng.integers(0, jov.NUM_BUCKETS + 1, n)
                    .astype(np.int32)),
        jnp.asarray(rng.random(n) < 0.1),
        jnp.zeros((n, 3), jnp.float32))
    want, want_orig = jov._compact(js, n, r_cap)
    ts = tov.SolverState(*(torch.from_numpy(np.array(x))
                           for x in js[:6]))
    got, got_orig = tov._compact(ts, n, r_cap)
    np.testing.assert_array_equal(got_orig.numpy(), np.asarray(want_orig))
    for field in ("label", "csum", "size", "constr", "fin", "frozen"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    assert int(got.fin[r_cap]) == 0 and int(got.constr[r_cap]) == -1
    assert int((got.label == r_cap).sum()) > 0     # overflow reached sink


@pytest.mark.parametrize("spatial,fwd", [("fwd", False), ("all", True)],
                         ids=["round", "level_end"])
@pytest.mark.parametrize("with_flow", [False, True],
                         ids=["no_flow", "flow"])
def test_pixel_fold_directions_match_jax(spatial, fwd, with_flow):
    """The directions each pixel fold visits, in order, with each one's
    validity, neighbour label, bucket and temporal flag: the round's
    (forward spatial + backward temporal) and the level end's (all spatial
    + backward + forward temporal, the forward ones undisplaced even with
    flow, as in the JAX package)."""
    t, h, w = 3, 8, 16
    rng = np.random.default_rng(2)
    vol = rng.random((t, h, w, 3)).astype(np.float32)
    lab = rng.integers(0, t * h * w, (t, h, w)).astype(np.int32)
    flow = rng.uniform(-2, 2, (t - 1, h, w, 2)).astype(np.float32) \
        if with_flow else None
    dirs = jov.SPATIAL_FWD if spatial == "fwd" else jov.SPATIAL_ALL
    n_dirs = len(dirs) + 9 + (9 if fwd else 0)

    def jfold(c, d):
        k, acc, tmp = c
        view = jnp.stack([jnp.where(d.valid, d.nb_label, -1),
                          jnp.where(d.valid, d.bucket, -1)])
        return (k + 1, acc.at[k].set(view),
                tmp.at[k].set(jnp.asarray(d.temporal, jnp.int32)))

    init = (jnp.int32(0), jnp.zeros((n_dirs, 2, t, h, w), jnp.int32),
            jnp.zeros(n_dirs, jnp.int32))
    feats = jnp.concatenate([jnp.asarray(vol),
                             jnp.zeros((t, h, w, 7), jnp.float32)], -1)
    k, want, want_tmp = jov._fold_dirs_raw(
        feats, jnp.asarray(lab), None if flow is None else jnp.asarray(flow),
        "l2", dirs, fwd, jfold, init)
    assert int(k) == n_dirs

    def tfold(c, d):
        return c + [(torch.stack([torch.where(d.valid, d.nb_label, -1),
                                  torch.where(d.valid, d.bucket, -1)]),
                     int(d.temporal))]

    got = tov._fold_dirs_raw(
        torch.from_numpy(vol), torch.from_numpy(lab), "l2", tfold, [],
        None if flow is None else torch.from_numpy(flow),
        spatial_dirs=(tov.SPATIAL_FWD if spatial == "fwd"
                      else tov.SPATIAL_ALL), temporal_fwd=fwd)
    assert len(got) == n_dirs
    np.testing.assert_array_equal(np.stack([g[0].numpy() for g in got]),
                                  np.asarray(want))
    assert [g[1] for g in got] == np.asarray(want_tmp).tolist()
    want_list = jov._shift_dir_list(dirs, not with_flow, fwd)
    assert tov._shift_dir_list(not with_flow, dirs, fwd) == want_list
    if with_flow and fwd:
        # Forward temporal undisplaced, backward ones only flow-displaced.
        assert [d[0] for d in want_list].count(1) == 9
        assert [d[0] for d in want_list].count(-1) == 0
