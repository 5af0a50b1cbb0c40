"""Port edge-table solver against the JAX `oversegment`.

Inputs are made with numpy from a seed: a textured volume, its tile felz
pre-segmentation (the NumPy mirror, which the port's K1 equals exactly),
and -- for the constrained case -- host-built head planes as the dense
stage builds them.  JAX runs its proven-equal scatter extraction
(extract_tile=False); the port runs both the scatter form and the tile
(K2) form, without flow and with random flow-displaced temporal partners.
label, constr, size and orig must be exact.
"""

import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from video_segment_tpu.core import oversegmentation as jov
from video_segment_tpu.ops import tile_felz as jtf
from video_segment_tpu_torch.core import oversegmentation as tov

torch.set_num_threads(2)

T, H, W = 5, 24, 256


def _volume(seed, shape=(T, H, W)):
    rng = np.random.default_rng(seed)
    import scipy.ndimage as ndi
    vol = ndi.gaussian_filter(rng.random(shape + (3,)), (0, 3, 3, 0))
    vol = (vol - vol.min()) / (vol.max() - vol.min())
    vol[:, :, 100:160] = 0.8 * vol[:, :, 100:160] + 0.1
    return vol.astype(np.float32)


def _identity_inputs(seed):
    """Per-pixel seeds over a table large enough for one recompaction
    (caps 49153 -> 32769)."""
    shape = (3, 32, 512)
    vol = _volume(seed, shape)
    n = int(np.prod(shape))
    init = np.arange(n, dtype=np.int32).reshape(shape)
    fin = np.full(shape, jov.NUM_BUCKETS, np.int32)
    params = jov.OversegParams(table_slots=n, min_region_size=20)
    return vol, init, fin, params, {}


def _inputs(seed, constrained):
    vol = _volume(seed)
    pj = jov.OversegParams()
    lab, fin, stats = jtf.tile_felz_reference(
        vol, schedule=pj.preseg_schedule, fin_margin=pj.preseg_fin_margin,
        fin_eager=True, fin_gated=True)
    init = lab.astype(np.int32)
    fin = fin.astype(np.int32)
    kw = dict(cell_stats=tuple(s.astype(np.float32) for s in stats))
    if constrained:
        n_c = 2
        plane = np.arange(H * W)
        left = (plane % W) < W // 2
        constr = np.full((T, H, W), -1, np.int32)
        constr[0] = np.where(left, 0, 1).reshape(H, W)
        constr[1] = np.where((plane % W) < W // 3, 0,
                             np.where(left, 1, 2)).reshape(H, W)
        init[0] = np.where(left, 0, W // 2).reshape(H, W)
        key = (init[1].astype(np.int64).ravel() * 4
               + constr[1].ravel() + 1)
        uniq, first = np.unique(key, return_index=True)
        init[1] = (H * W + first[np.searchsorted(uniq, key)]).reshape(H, W)
        fin[:n_c] = jov.NUM_BUCKETS
        frozen = np.zeros((T, H, W), bool)
        frozen[0] = True
        kw.update(constraints=constr, frozen=frozen, head_planes=n_c)
    flat = init.reshape(-1)
    n_seeds = int((flat == np.arange(flat.size)).sum())
    slots = min(((n_seeds + 1024 + 16383) // 16384) * 16384, flat.size)
    params = pj._replace(table_divisor=16, table_slots=slots,
                         min_region_size=20)
    return vol, init, fin, params, kw


def _run_jax(vol, init, fin, params, kw):
    args = {k: (tuple(jnp.asarray(x) for x in v) if k == "cell_stats"
                else (jnp.asarray(v) if isinstance(v, np.ndarray) else v))
            for k, v in kw.items()}
    return jov.oversegment(jnp.asarray(vol), init_label=jnp.asarray(init),
                           fin=jnp.asarray(fin),
                           params=params._replace(extract_tile=False),
                           **args)


def _run_port(vol, init, fin, params, kw, extract_tile):
    args = {k: (tuple(torch.from_numpy(x) for x in v) if k == "cell_stats"
                else (torch.from_numpy(v) if isinstance(v, np.ndarray)
                      else v))
            for k, v in kw.items()}
    p = tov.params_from_jax(params)._replace(extract_tile=extract_tile)
    return tov.oversegment(torch.from_numpy(vol),
                           init_label=torch.from_numpy(init),
                           fin=torch.from_numpy(fin), params=p, **args)


@pytest.mark.parametrize("case", ["free", "head_planes", "identity"])
def test_oversegment_matches_jax(case):
    vol, init, fin, params, kw = (_identity_inputs(12) if case == "identity"
                                  else _inputs(11, case == "head_planes"))
    want = _run_jax(vol, init, fin, params, kw)
    for extract_tile in (False, True):
        got = _run_port(vol, init, fin, params, kw, extract_tile)
        for field in ("label", "constr", "size", "orig"):
            np.testing.assert_array_equal(
                getattr(got, field).numpy(),
                np.asarray(getattr(want, field)),
                err_msg=f"{field} (extract_tile={extract_tile})")
        nreg = len(np.unique(got.label.numpy()))
        assert 2 < nreg < init.size // 20, nreg


@pytest.mark.parametrize("knob", [dict(pair_merge=True),
                                  dict(pair_merge_minsize=True),
                                  dict(fin_every_round=True),
                                  dict(min_size_interleave=2)],
                         ids=["pair_merge", "pair_merge_minsize",
                              "fin_every_round", "min_size_interleave"])
def test_oversegment_knobs_match_jax(knob):
    """Off-default solver knobs that the ported round loop carries."""
    vol, init, fin, params, kw = _inputs(11, True)
    params = params._replace(**knob)
    want = _run_jax(vol, init, fin, params, kw)
    got = _run_port(vol, init, fin, params, kw, None)
    for field in ("label", "constr", "size", "orig"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)


def test_scope_raises():
    """The v1 pixel solver refuses the variance descriptor and the
    gradient trait with the JAX package's errors; every off-default knob
    of the edge-table solver runs."""
    vol = torch.zeros((2, 8, 128, 3))
    for knob in (dict(descriptor="color_mean_variance"),
                 dict(gradient_trait=True)):
        with pytest.raises(ValueError) as want:
            jov.oversegment(jnp.zeros((2, 8, 128, 3)),
                            params=jov.OversegParams(edge_table=False,
                                                     **knob))
        with pytest.raises(ValueError) as got:
            tov.oversegment(vol, params=tov.OversegParams(edge_table=False,
                                                          **knob))
        assert str(got.value) == str(want.value)
    for p in (tov.OversegParams(two_stage=True),
              tov.OversegParams(gradient_trait=True),
              tov.OversegParams(descriptor="color_mean_variance")):
        assert tov.oversegment(vol, params=p).label.shape == (2, 8, 128)
    # Flow and the banded solve are ported; a band height that is not a
    # multiple of 8 rows raises as in the JAX package.
    with pytest.raises(ValueError):
        tov.oversegment(vol, flow=torch.zeros((1, 8, 128, 2)),
                        params=tov.OversegParams(bands=2))
    tov.oversegment(torch.zeros((2, 16, 128, 3)),
                    flow=torch.zeros((1, 16, 128, 2)),
                    params=tov.OversegParams(bands=2))


def _flow(seed, t=T, h=H, w=W):
    """Random uniform(-2, 2) backward flow of frames 1..t-1 (the JAX
    package's test_tile_extract input): partners land in other rows, other
    tiles and outside the frame."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-2, 2, (t - 1, h, w, 2)).astype(np.float32)


@pytest.mark.parametrize("case", ["free", "head_planes"])
def test_oversegment_flow_matches_jax(case):
    """Flow-displaced temporal directions: exact against JAX on the scatter
    and the K2 tile extraction forms."""
    vol, init, fin, params, kw = _inputs(11, case == "head_planes")
    kw["flow"] = _flow(21)
    want = _run_jax(vol, init, fin, params, kw)
    no_flow = _run_jax(vol, init, fin, params,
                       {k: v for k, v in kw.items() if k != "flow"})
    assert not np.array_equal(np.asarray(want.label),
                              np.asarray(no_flow.label))
    for extract_tile in (False, True):
        got = _run_port(vol, init, fin, params, kw, extract_tile)
        for field in ("label", "constr", "size", "orig"):
            np.testing.assert_array_equal(
                getattr(got, field).numpy(),
                np.asarray(getattr(want, field)),
                err_msg=f"{field} (extract_tile={extract_tile})")


def test_extract_edges_flow_tile_equals_scatter():
    """The packed edge table with flow-displaced partners (from other rows,
    other tiles and frame t-1 of other tiles): the port's K2 tile form
    equals its scatter form and JAX's scatter extraction, on JAX's
    test_tile_extract flow input."""
    from test_tile_extract import _tile_flood_init
    rng = np.random.default_rng(3)
    t, h, w = 3, 16, 128
    vol = rng.uniform(0, 1, (t, h, w, 3)).astype(np.float32)
    flow = rng.uniform(-2, 2, (t - 1, h, w, 2)).astype(np.float32)
    init = np.array(_tile_flood_init(t, h, w, rng))
    n = t * h * w
    pj = jov.OversegParams()
    r_cap = jov._table_cap(pj, n, h, w, False)
    _, memb, _ = jov._init_table(
        jnp.asarray(vol), jnp.asarray(init), jnp.full(n, -1, jnp.int32),
        jnp.zeros(n, bool), jnp.full(n, jov.NUM_BUCKETS, jnp.int32), r_cap,
        False, pj, None, 0)
    want = np.asarray(jov._extract_edges(memb.reshape(t, h, w),
                                         jnp.asarray(vol), jnp.asarray(flow),
                                         r_cap + 1, r_cap, pj))
    pt = tov.params_from_jax(pj)
    assert tov._table_cap(pt, n, h, w, False) == r_cap
    tinit = torch.from_numpy(init)
    _, tmemb, orig = tov._init_table(
        torch.from_numpy(vol), tinit, torch.full((n,), -1, dtype=torch.int32),
        torch.zeros(n, dtype=torch.bool),
        torch.full((n,), tov.NUM_BUCKETS, dtype=torch.int32), r_cap, False)
    assert (want[:13] < tov.I32MAX).sum() > 0
    for extract_tile in (False, True):
        got = tov._extract_edges(
            tmemb.reshape(t, h, w), torch.from_numpy(vol), r_cap + 1, r_cap,
            pt._replace(extract_tile=extract_tile), init_label=tinit,
            orig_slot=orig, flow=torch.from_numpy(flow))
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"extract_tile={extract_tile}")


def test_flow_displaced_temporal_edges():
    """JAX's moving-bar case: a 2-px bar moves 5 px right; undisplaced
    temporal edges cannot reach it, the backward flow connects it."""
    t, h, w = 2, 8, 16
    vol = np.zeros((t, h, w, 3), np.float32)
    vol[0, :, 4:6] = 1.0
    vol[1, :, 9:11] = 1.0
    flow = np.zeros((1, h, w, 2), np.float32)
    flow[0, :, :, 0] = -5.0
    kw = dict(min_region_size=1, schedule=(2, 32, 256, 2047),
              max_rounds_per_level=8, max_final_rounds=16)
    p = tov.OversegParams(**kw)
    lab_nf = tov.oversegment(torch.from_numpy(vol), params=p).label.numpy()
    res = tov.oversegment(torch.from_numpy(vol), flow=torch.from_numpy(flow),
                          params=p)
    lab_fl = res.label.numpy()
    assert lab_nf[0, 0, 4] != lab_nf[1, 0, 9]
    assert lab_fl[0, 0, 4] == lab_fl[1, 0, 9]
    want = jov.oversegment(jnp.asarray(vol), flow=jnp.asarray(flow),
                           params=jov.OversegParams(**kw))
    np.testing.assert_array_equal(lab_fl, np.asarray(want.label))


def test_table_phase_caps_match():
    for n in (16385, 65537, 200001, 1 << 20):
        assert tov._table_phase_caps(n) == jov._table_phase_caps(n)
        assert tov._pack_spec(n) == jov._pack_spec(n)


# ---------------------------------------------------------------------------
# Supertile-gated early levels (st_levels): K3 path and masked rounds.


def _st_volume(constrained=False):
    """Flat 8x16 patches of colours quantized to multiples of 1/32 (the
    JAX package's test_st_kernel_matches_masked_rounds input): every
    statistic is exact in float32 and float64, so the K3 path's
    re-aggregation from seeds cannot flip a merge test."""
    rng = np.random.default_rng(5)
    t, h, w = 3, 32, 256
    base = (rng.integers(0, 33, (t, h // 8, w // 16, 3))
            .astype(np.float32) / 32.0)
    vol = np.repeat(np.repeat(base, 8, 1), 16, 2)
    kw = {}
    if constrained:
        constr = np.full((t, h, w), -1, np.int32)
        constr[0] = (np.arange(w)[None, :] // 64).repeat(h, 0)
        frozen = np.zeros((t, h, w), bool)
        frozen[0] = True
        kw = dict(constraints=constr, frozen=frozen)
    return vol, kw


ST_COMMON = dict(st_levels=3, st_h=16, st_w=128, st_slots=2048,
                 min_region_size=0)


@pytest.mark.parametrize("constrained", [False, True],
                         ids=["free", "constrained"])
def test_supertile_levels_match_jax_masked_rounds(constrained):
    """The port's supertile solve, on both paths, equals the JAX masked
    rounds (st_kernel=False) exactly."""
    vol, kw = _st_volume(constrained)
    n_pix = vol[..., 0].size
    pj = jov.OversegParams(table_slots=n_pix, st_kernel=False, **ST_COMMON)
    want = jov.oversegment(jnp.asarray(vol), params=pj,
                           **{k: jnp.asarray(v) for k, v in kw.items()})
    lab_w = np.asarray(want.label)
    assert len(np.unique(lab_w)) < n_pix // 4   # merging happened
    for st_kernel in (True, False):
        assert tov._use_st_kernel(tov.params_from_jax(pj)._replace(
            st_kernel=st_kernel)) == st_kernel
        got = tov.oversegment(
            torch.from_numpy(vol),
            params=tov.params_from_jax(pj)._replace(st_kernel=st_kernel),
            **{k: torch.from_numpy(v) for k, v in kw.items()})
        for field in ("label", "constr", "size", "orig"):
            np.testing.assert_array_equal(
                getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                err_msg=f"{field} (st_kernel={st_kernel})")


def test_supertile_r3_knob_takes_masked_rounds():
    """pair_merge is not carried by K3: with it, st_kernel=True takes the
    masked rounds and equals JAX's masked rounds with pair_merge."""
    vol, _ = _st_volume()
    n_pix = vol[..., 0].size
    pj = jov.OversegParams(table_slots=n_pix, st_kernel=False,
                           pair_merge=True, **ST_COMMON)
    pt = tov.params_from_jax(pj)._replace(st_kernel=True)
    assert not tov._use_st_kernel(pt)
    want = jov.oversegment(jnp.asarray(vol), params=pj)
    got = tov.oversegment(torch.from_numpy(vol), params=pt)
    np.testing.assert_array_equal(got.label.numpy(), np.asarray(want.label))


@pytest.mark.parametrize("bad", [dict(st_slots=4224), dict(st_slots=1000),
                                 dict(st_levels=9),
                                 dict(st_levels=2, schedule=(4, 16))],
                         ids=["slots_over_4096", "slots_not_128",
                              "all_levels_gated", "short_schedule"])
def test_supertile_r2_r4_raise(bad):
    vol = torch.zeros((2, 8, 128, 3))
    p = tov.OversegParams(**{"st_levels": 1, **bad})
    with pytest.raises(ValueError):
        tov.oversegment(vol, params=p)


def test_sup_ids_match_jax():
    params = jov.OversegParams(st_h=16, st_w=128)
    orig = np.arange(0, 3 * 40 * 300, 7, dtype=np.int32)
    want = np.asarray(jov._sup_ids_hw(jnp.asarray(orig), 40, 300, params))
    got = tov._sup_ids_hw(torch.from_numpy(orig), 40, 300,
                          tov.params_from_jax(params))
    np.testing.assert_array_equal(got.numpy(), want)


def test_supertile_blocked_plane_follows_current_constraints():
    """K3's blocked plane is rebuilt from the state of each gated level
    (read through the current roots): a region unconstrained by a level
    end is free at the next gated level, as in the masked rounds."""
    shape3 = (1, 8, 128)
    params = tov.OversegParams(st_levels=1, st_h=8, st_w=128, st_slots=128)
    nseg = 9                                   # 8 seeds + sink
    orig = torch.tensor([0, 5, 9, 130, 300, 512, 700, 1000, 0],
                        dtype=torch.int32)
    size = torch.ones(nseg)
    size[-1] = 0
    ts = tov.SolverState(
        label=torch.tensor([0, 1, 2, 2, 4, 5, 6, 7, 8], dtype=torch.int32),
        csum=torch.zeros((nseg, 3)), size=size,
        constr=torch.tensor([0, 1, 0, -1, -1, -1, -1, -1, -1],
                            dtype=torch.int32),
        fin=torch.full((nseg,), tov.NUM_BUCKETS, dtype=torch.int32),
        frozen=torch.zeros(nseg, dtype=torch.bool))
    tab = torch.full((26, nseg), tov.I32MAX, dtype=torch.int32)
    ptn, pbk = tov._topk_edges(tab, params.edge_topk)
    st = tov._st_layout(ts, ptn, pbk, orig, shape3, params)
    labr, labc, _, blocked = tov._st_level_planes(st, ts)
    lab = (labr * 128 + labc).reshape(-1)[:8].tolist()
    assert lab == [0, 1, 2, 2, 4, 5, 6, 7]     # slot 3 rooted at slot 2
    assert blocked.reshape(-1)[:8].tolist() == [1, 1, 1, 1, 0, 0, 0, 0]
    assert blocked.reshape(-1)[8:].eq(1).all()  # empty positions
    ts = ts._replace(constr=torch.tensor([0, -1, -1, -1, -1, -1, -1, -1, -1],
                                         dtype=torch.int32))
    _, _, _, blocked = tov._st_level_planes(st, ts)
    assert blocked.reshape(-1)[:8].tolist() == [1, 0, 0, 0, 0, 0, 0, 0]


# ---------------------------------------------------------------------------
# Off-default knobs: the variance descriptor, the gradient trait (each
# aggregator), the two-stage spatial pre-pass.

VAR = dict(descriptor="color_mean_variance", merge_threshold=0.1,
           split_threshold=0.75)
TRAIT_KNOBS = {
    "variance": VAR,
    "gradient-independent": dict(gradient_trait=True),
    "gradient-linear": dict(gradient_trait=True, aggregator="linear",
                            linear_weight=0.3),
    "gradient-sqrt": dict(gradient_trait=True, aggregator="sqrt"),
    "two_stage": dict(two_stage=True),
    "variance-gradient-two_stage": dict(VAR, gradient_trait=True,
                                        two_stage=True),
}


def _assert_same(got, want, what=""):
    for field in ("label", "constr", "size", "orig"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=f"{field} {what}")


TRAIT_CASES = ([(k, c) for k in TRAIT_KNOBS for c in ("free", "head_planes")]
               + [("gradient-independent", "flow"),
                  ("variance-gradient-two_stage", "flow")])


@pytest.mark.parametrize("knob,case", TRAIT_CASES,
                         ids=[f"{k}-{c}" for k, c in TRAIT_CASES])
def test_oversegment_trait_knobs_match_jax(knob, case):
    """Each knob, with and without constraints and init labels (head
    planes), and the gradient knobs with flow-displaced temporal edges:
    exact against JAX on the scatter and the K2 tile extraction."""
    vol, init, fin, params, kw = _inputs(11, case == "head_planes")
    if case == "flow":
        kw["flow"] = _flow(21)
    params = params._replace(**TRAIT_KNOBS[knob])
    want = _run_jax(vol, init, fin, params, kw)
    plain = _run_jax(vol, init, fin, params._replace(
        **tov.OversegParams()._asdict()), kw) if case == "free" else None
    for extract_tile in (False, True):
        got = _run_port(vol, init, fin, params, kw, extract_tile)
        _assert_same(got, want, f"(extract_tile={extract_tile})")
    if plain is not None:   # the knob changed the result
        assert not np.array_equal(np.asarray(plain.label),
                                  np.asarray(want.label))


def test_init_table_trait_statistics_match_jax():
    """Seed statistics under the variance descriptor and the gradient
    trait (5-channel volume, cell stats bypassed): sizes exact, color,
    square and gradient sums within 1e-5 of JAX's."""
    from video_segment_tpu.ops import pixel_distance as jpd
    from video_segment_tpu_torch.ops import pixel_distance as tpd
    vol, init, fin, params, kw = _inputs(11, True)
    n = init.size
    pj = params._replace(**VAR, gradient_trait=True)
    vol5 = np.array(jax.jit(lambda v: jnp.concatenate(
        [v, jpd.gradient_features(v)], -1))(vol))
    np.testing.assert_array_equal(
        vol5, torch.cat([torch.from_numpy(vol), tpd.gradient_features(
            torch.from_numpy(vol))], -1).numpy())
    r_cap = jov._table_cap(pj, n, H, W, True)
    cells = kw["cell_stats"]
    want, wmemb, worig = jov._init_table(
        jnp.asarray(vol5), jnp.asarray(init.reshape(-1)),
        jnp.asarray(kw["constraints"].reshape(-1)),
        jnp.asarray(kw["frozen"].reshape(-1)), jnp.asarray(fin.reshape(-1)),
        r_cap, True, pj, tuple(jnp.asarray(c) for c in cells), 2)
    got, memb, orig = tov._init_table(
        torch.from_numpy(vol5), torch.from_numpy(init.reshape(-1)),
        torch.from_numpy(kw["constraints"].reshape(-1)),
        torch.from_numpy(kw["frozen"].reshape(-1)),
        torch.from_numpy(fin.reshape(-1)), r_cap, True,
        tuple(torch.from_numpy(c) for c in cells), 2,
        tov.params_from_jax(pj))
    np.testing.assert_array_equal(memb.numpy(), np.asarray(wmemb))
    np.testing.assert_array_equal(orig.numpy(), np.asarray(worig))
    for field in ("size", "constr", "fin", "frozen"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    for field in ("csum", "sqsum", "gsum"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=0, atol=1e-5, err_msg=field)
    assert float(np.abs(np.asarray(want.gsum)).max()) > 0.1


@pytest.mark.parametrize("aggregator", ["linear", "independent", "sqrt"])
def test_gradient_trait_solve_matches_jax(aggregator):
    """The JAX package's own gradient-trait case: equal-mean flat and
    striped halves stay apart under each aggregator, and the port's labels
    equal JAX's."""
    h, w = 16, 32
    vol = np.full((2, h, w, 3), 0.5, np.float32)
    vol[:, :, w // 2:] += 0.3 * np.tile([1.0, -1.0], w // 4)[None, None, :,
                                                             None]
    kw = dict(min_region_size=1, table_divisor=2, preseg_schedule=(4,),
              gradient_trait=True, aggregator=aggregator)
    want = jov.oversegment(jnp.asarray(vol), params=jov.OversegParams(**kw))
    got = tov.oversegment(torch.from_numpy(vol),
                          params=tov.OversegParams(**kw))
    _assert_same(got, want)
    lab = got.label.numpy()
    assert not (set(np.unique(lab[:, :, :w // 2 - 2]))
                & set(np.unique(lab[:, :, w // 2 + 2:])))


@pytest.mark.parametrize("sigma,n_regions", [(0.6, 1), (0.03, 2)])
def test_variance_trait_adaptive_gating_matches_jax(sigma, n_regions):
    """The JAX package's own variance case: a 0.1 mean gap between two
    seeded halves merges under high variance and stays split under low."""
    rng = np.random.default_rng(3)
    h, w = 16, 32
    init = np.zeros((1, h, w), np.int32)
    init[:, :, w // 2:] = w // 2
    vol = np.zeros((1, h, w, 3), np.float32)
    vol[:, :, :w // 2] = 0.45
    vol[:, :, w // 2:] = 0.55
    vol = np.clip(vol + rng.normal(0, sigma, vol.shape).astype(np.float32),
                  0.0, 1.0)
    kw = dict(min_region_size=1, schedule=(64, 512, 2047), **VAR)
    want = jov.oversegment(jnp.asarray(vol), init_label=jnp.asarray(init),
                           params=jov.OversegParams(**kw))
    got = tov.oversegment(torch.from_numpy(vol),
                          init_label=torch.from_numpy(init),
                          params=tov.OversegParams(**kw))
    _assert_same(got, want)
    assert len(np.unique(got.label.numpy())) == n_regions


def test_trait_distance_matches_jax():
    """`_trait_distance` (variance: z-score over the pooled variance,
    clamped; color_mean: with the force-merge shortcut) and `_thresholds`
    for each aggregator, against JAX's."""
    rng = np.random.default_rng(8)
    ma, mb = (rng.random((4000, 3)).astype(np.float32) for _ in range(2))
    va, vb = ((rng.random((4000, 3)) * 0.02).astype(np.float32)
              for _ in range(2))
    va[:100] = 0.0                       # pooled variance clamps at 1e-4
    bkt = rng.integers(0, 8, 4000).astype(np.int32)
    for kw in (VAR, {}):
        pj = jov.OversegParams(**kw)
        want = jov._trait_distance(*(jnp.asarray(x) for x in
                                     (ma, va, mb, vb, bkt)), pj)
        got = tov._trait_distance(*(torch.from_numpy(x) for x in
                                    (ma, va, mb, vb, bkt)),
                                  tov.params_from_jax(pj))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (got.numpy() == 1.0).any() == bool(kw)
    for agg in ("linear", "independent", "sqrt"):
        pj = jov.OversegParams(gradient_trait=True, aggregator=agg,
                               linear_weight=0.3)
        assert tov._thresholds(tov.params_from_jax(pj)) == \
            jov._thresholds(pj)


@pytest.mark.parametrize("knob", ["gradient_trait", "variance", "two_stage"])
def test_supertile_gate_takes_masked_rounds(knob, monkeypatch):
    """Under each knob the K3 path is refused (JAX's gate): with
    st_kernel=True the port never calls K3's wrapper and equals JAX's
    masked rounds."""
    from video_segment_tpu_torch.ops import tile_table
    kw = {"gradient_trait": dict(gradient_trait=True), "variance": VAR,
          "two_stage": dict(two_stage=True)}[knob]
    vol, _ = _st_volume()
    n_pix = vol[..., 0].size
    pj = jov.OversegParams(table_slots=n_pix, st_kernel=False, **kw,
                           **ST_COMMON)
    pt = tov.params_from_jax(pj)._replace(st_kernel=True)
    assert not tov._use_st_kernel(pt)
    assert tov._use_st_kernel(tov.params_from_jax(
        jov.OversegParams(**ST_COMMON))._replace(st_kernel=True))

    def refuse(**_):
        raise AssertionError("K3 called under a gated knob")

    monkeypatch.setattr(tile_table, "tile_table_rounds", refuse)
    want = jov.oversegment(jnp.asarray(vol), params=pj)
    got = tov.oversegment(torch.from_numpy(vol), params=pt)
    _assert_same(got, want)


@pytest.mark.cuda
def test_supertile_gate_launches_no_k3_on_the_card():
    """On the card, gradient_trait with st_levels=3 and st_kernel=None
    (K3 by default) launches K3 zero times; without the trait it does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel has no CPU mode)")
    from video_segment_tpu_torch.ops import tile_table
    vol, _ = _st_volume()
    vol = torch.from_numpy(vol).cuda()
    for trait, want in ((True, 0), (False, 3)):
        tile_table.tile_table_rounds.launches = 0
        p = tov.OversegParams(table_slots=vol[..., 0].numel(),
                              gradient_trait=trait, **ST_COMMON)
        tov.oversegment(vol, params=p)
        torch.cuda.synchronize()
        assert tile_table.tile_table_rounds.launches == want
