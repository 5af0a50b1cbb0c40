"""The port's banded (row-split) chunk solve against the JAX package's.

Solver level: `_extract_edges` with `global_base` / `pack_domain`,
`_boundary_edges` with and without the undisplaced temporal directions,
the JAX package's own banded cases (banded equals monolithic on a blocky
clip, a region that spans a seam, a misaligned height raises, constrained
continuity, `bands_vmap` equals the loop), `oversegment(bands=3)` on a
textured, pre-segmented volume with and without flow, and supertile-gated
levels over a banded table.  Dense-stage level:
a seeded clip streamed through both `DenseSegmentation`s with forced and
automatic bands, with and without pad rows, flow off and on, felz and
flood pre-segmentation, and a banded JAX run's state handed to the port.
Labels, finalize levels, packed keys, RLE and hierarchy fields are exact;
float sums equal bit for bit on the CPU (both packages scatter-add in
index order).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from video_segment_tpu.core import dense as jdense
from video_segment_tpu.core import oversegmentation as jov
from video_segment_tpu_torch.core import dense as tdense
from video_segment_tpu_torch.core import oversegmentation as tov

from test_banded_solve import PARAMS as JPARAMS, blocky_volume, canonical
from test_torch_dense import (W, _options, assert_frames_equal, clip,
                              jax_flows, toptions)
from test_torch_oversegmentation import _flow, _inputs, _run_jax, _run_port

torch.set_num_threads(2)

TPARAMS = tov.params_from_jax(JPARAMS)
FIELDS = ("label", "constr", "size", "orig")


def _tsolve(vol, bands, **kw):
    res = tov.oversegment(torch.from_numpy(np.array(vol)),
                          params=TPARAMS._replace(bands=bands, **kw))
    return res.label.numpy()


def _jsolve(vol, bands, **kw):
    return jov.oversegment(vol, params=JPARAMS._replace(bands=bands, **kw))


# ---------------------------------------------------------------------------
# Solver pieces.


@pytest.mark.parametrize("pack_domain", [4 * 16384 + 1, (1 << 20) + 5],
                         ids=["20bit", "22bit"])
@pytest.mark.parametrize("with_flow", [False, True], ids=["noflow", "flow"])
def test_extract_edges_global_base_matches_jax(pack_domain, with_flow):
    """A band's extraction: band-local own slots, partner ids offset by
    `global_base`, keys packed for the global table (20 partner bits, or 22
    with the bucket shifted by 2).  Scatter and K2 tile forms both equal
    JAX's scatter extraction."""
    vol, init, fin, params, kw = _inputs(13, False)
    t, h, w = init.shape
    n = init.size
    flow = _flow(5) if with_flow else None
    r_cap = params.table_slots
    base = 2 * r_cap
    jts, jmemb, jorig = jov._init_table(
        jnp.asarray(vol), jnp.asarray(init.reshape(-1)),
        jnp.full(n, -1, jnp.int32), jnp.zeros(n, bool),
        jnp.asarray(fin.reshape(-1)), r_cap, False, params, None, 0)
    want = np.asarray(jov._extract_edges(
        jmemb.reshape(t, h, w), jnp.asarray(vol),
        None if flow is None else jnp.asarray(flow), r_cap + 1, r_cap,
        params._replace(extract_tile=False), global_base=base,
        pack_domain=pack_domain))
    tinit = torch.from_numpy(init.reshape(-1))
    _, tmemb, torig = tov._init_table(
        torch.from_numpy(vol), tinit,
        torch.full((n,), -1, dtype=torch.int32),
        torch.zeros(n, dtype=torch.bool), torch.from_numpy(fin.reshape(-1)),
        r_cap, False)
    np.testing.assert_array_equal(tmemb.numpy(), np.asarray(jmemb))
    pt = tov.params_from_jax(params)
    bits, _ = tov._pack_spec(pack_domain)
    live = want[want < tov.I32MAX]
    assert live.size and ((live & ((1 << bits) - 1)) >= base).all()
    for extract_tile in (False, True):
        got = tov._extract_edges(
            tmemb.reshape(t, h, w), torch.from_numpy(vol), r_cap + 1, r_cap,
            pt._replace(extract_tile=extract_tile), init_label=tinit,
            orig_slot=torig,
            flow=None if flow is None else torch.from_numpy(flow),
            global_base=base, pack_domain=pack_domain)
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"extract_tile={extract_tile}")


@pytest.mark.parametrize("include_temporal", [False, True],
                         ids=["spatial", "spatial_temporal"])
@pytest.mark.parametrize("G", [3000, (1 << 20) + 8], ids=["20bit", "22bit"])
def test_boundary_edges_match_jax(include_temporal, G):
    rng = np.random.default_rng(17)
    t, B, bh, w = 3, 3, 8, 40
    vol = rng.random((t, B * bh, w, 3)).astype(np.float32)
    memb = rng.integers(G - 60, G + 1, (t, B * bh, w)).astype(np.int32)
    want = np.asarray(jov._boundary_edges(
        jnp.asarray(vol), jnp.asarray(memb), B, bh, G, jov.OversegParams(),
        include_temporal))
    got = tov._boundary_edges(torch.from_numpy(vol), torch.from_numpy(memb),
                              B, bh, G, tov.OversegParams(),
                              include_temporal).numpy()
    assert got.shape[0] == (18 if include_temporal else 6)
    assert (want < tov.I32MAX).sum() > 50
    np.testing.assert_array_equal(got, want)


def test_banded_dims_match_jax():
    for (t, h, w), kw in (((21, 864, 480), dict(bands=2, table_divisor=16)),
                          ((21, 1296, 720), dict(bands=3)),
                          ((5, 32, 256), dict(bands=4,
                                              band_table_slots=16384))):
        assert tov._banded_dims(t, h, w, tov.OversegParams(**kw)) == \
            jov._banded_dims(t, h, w, jov.OversegParams(**kw))
    with pytest.raises(ValueError):
        # 3 x 349,440-slot band tables exceed the packable 2^22 - 1.
        tov._banded_dims(21, 1296, 720, tov.OversegParams(
            bands=12, band_table_slots=1 << 19))


# ---------------------------------------------------------------------------
# The JAX package's banded cases, held to JAX label for label.


@pytest.mark.parametrize("bands", [2, 4])
def test_banded_matches_monolithic_blocky(bands):
    vol = blocky_volume()
    mono = canonical(_tsolve(vol, 1))
    band = _tsolve(vol, bands)
    np.testing.assert_array_equal(mono, canonical(band))
    np.testing.assert_array_equal(band,
                                  np.asarray(_jsolve(vol, bands).label))


def test_banded_region_spans_seam():
    """A uniform volume must come out as ONE region despite banding."""
    vol = np.full((2, 16, 16, 3), 0.5, np.float32)
    band = _tsolve(vol, 2)
    assert len(np.unique(band)) == 1
    np.testing.assert_array_equal(
        band, np.asarray(_jsolve(jnp.asarray(vol), 2).label))


def test_banded_rejects_misaligned_height():
    vol = np.ones((2, 20, 16, 3), np.float32)
    with pytest.raises(ValueError, match="8-row-aligned"):
        _tsolve(vol, 2)  # 10-row bands not 8-aligned


def test_banded_constrained_continuity():
    """Constraint ids survive a banded solve and pre-merged frozen plane
    fragments reunite across bands; every field equals JAX's."""
    vol = np.array(blocky_volume())
    t, h, w, _ = vol.shape
    strip = (np.arange(w) // (w // 4)).astype(np.int32)
    constraints = np.full((t, h, w), -1, np.int32)
    constraints[0] = strip[None, :]
    constraints[1] = strip[None, :]
    frozen = np.zeros((t, h, w), bool)
    frozen[0] = True
    init = np.arange(t * h * w, dtype=np.int32).reshape(t, h, w)
    for bands in (1, 2):
        bh = h // bands
        key = (constraints[0].astype(np.int64) * bands
               + (np.arange(h) // bh)[:, None]).ravel()
        uniq, first = np.unique(key, return_index=True)
        init2 = init.copy()
        init2[0] = first[np.searchsorted(uniq, key)].reshape(h, w)
        res = tov.oversegment(torch.from_numpy(vol),
                              constraints=torch.from_numpy(constraints),
                              init_label=torch.from_numpy(init2),
                              frozen=torch.from_numpy(frozen),
                              params=TPARAMS._replace(bands=bands))
        want = jov.oversegment(jnp.asarray(vol),
                               constraints=jnp.asarray(constraints),
                               init_label=jnp.asarray(init2),
                               frozen=jnp.asarray(frozen),
                               params=JPARAMS._replace(bands=bands))
        for field in FIELDS:
            np.testing.assert_array_equal(getattr(res, field).numpy(),
                                          np.asarray(getattr(want, field)),
                                          err_msg=f"{field} bands={bands}")
        lab = res.label.numpy()
        for s in range(4):
            roots = np.unique(lab[0][:, strip == s])
            assert len(roots) == 1, (bands, s, roots)
            constr, _ = tov.region_attrs(res, roots)
            assert constr[0] == s


def test_banded_vmap_matches_map():
    vol = blocky_volume(seed=3)
    a = _tsolve(vol, 2)
    b = _tsolve(vol, 2, bands_vmap=True)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        a, np.asarray(_jsolve(vol, 2, bands_vmap=True).label))


@pytest.mark.parametrize("case", ["free", "head_planes", "free_flow",
                                  "head_planes_flow"])
def test_banded_oversegment_matches_jax(case):
    """`oversegment(bands=3)` on a textured 24x256 volume pre-segmented by
    the tile felz pre-solve (8-row bands: every tile row is a band), with
    per-band table slots as the dense stage sets them: exact against JAX on
    the scatter and the K2 tile extraction forms."""
    _banded_case(case, {})


KNOB_CASES = [("gradient", "free_flow"),
              ("two_stage", "free"), ("two_stage", "head_planes_flow"),
              ("variance-gradient-two_stage", "head_planes")]


@pytest.mark.parametrize("knob,case", KNOB_CASES,
                         ids=[f"{k}-{c}" for k, c in KNOB_CASES])
def test_banded_trait_knobs_match_jax(knob, case):
    """The banded solve under the gradient trait (5-channel band volumes,
    aggregated buckets at the seams, glued gradient sums) and the
    two-stage pre-pass (its spatial slice of the glued table leaves the
    boundary rows out, as JAX's does), label for label against JAX."""
    from test_torch_oversegmentation import VAR
    _banded_case(case, {"gradient": dict(gradient_trait=True),
                        "two_stage": dict(two_stage=True),
                        "variance-gradient-two_stage": dict(
                            VAR, gradient_trait=True, two_stage=True)}[knob])


def test_boundary_edges_gradient_match_jax():
    """Seam edges of a 5-channel (color + gradient) volume: the pair
    distance aggregates the gradient difference as in JAX."""
    rng = np.random.default_rng(18)
    t, B, bh, w, G = 3, 3, 8, 40, 3000
    vol = rng.random((t, B * bh, w, 5)).astype(np.float32)
    vol[..., 3:] = (vol[..., 3:] - 0.5) * 0.2
    memb = rng.integers(G - 60, G + 1, (t, B * bh, w)).astype(np.int32)
    pj = jov.OversegParams(gradient_trait=True)
    want = np.asarray(jov._boundary_edges(
        jnp.asarray(vol), jnp.asarray(memb), B, bh, G, pj, True))
    got = tov._boundary_edges(torch.from_numpy(vol), torch.from_numpy(memb),
                              B, bh, G, tov.params_from_jax(pj), True).numpy()
    plain = tov._boundary_edges(torch.from_numpy(vol), torch.from_numpy(memb),
                                B, bh, G, tov.OversegParams(), True).numpy()
    assert not np.array_equal(got, plain)
    np.testing.assert_array_equal(got, want)


def _banded_case(case, knobs):
    constrained = case.startswith("head_planes")
    vol, init, fin, params, kw = _inputs(11, constrained)
    t, h, w = init.shape
    bands = 3
    if constrained:
        # Plane 0's canonical voxel per (constraint id, band), as the dense
        # stage builds it: band-local seed compaction needs in-band roots.
        key0 = (kw["constraints"][0].astype(np.int64) * bands
                + (np.arange(h) // (h // bands))[:, None]).ravel()
        uniq, first = np.unique(key0, return_index=True)
        init[0] = first[np.searchsorted(uniq, key0)].reshape(h, w)
    if case.endswith("flow"):
        kw["flow"] = _flow(21)
    is_root = (init.reshape(-1) == np.arange(init.size)).reshape(
        t, bands, h // bands, w)
    n_seeds = int(is_root.sum(axis=(0, 2, 3)).max())
    params = params._replace(
        bands=bands, table_slots=0,
        band_table_slots=((n_seeds + 1024 + 16383) // 16384) * 16384,
        **knobs)
    want = _run_jax(vol, init, fin, params, kw)
    mono = _run_jax(vol, init, fin, params._replace(bands=1), kw)
    assert not np.array_equal(np.asarray(want.label), np.asarray(mono.label))
    for extract_tile in (False, True):
        got = _run_port(vol, init, fin, params, kw, extract_tile)
        for field in FIELDS:
            np.testing.assert_array_equal(
                getattr(got, field).numpy(),
                np.asarray(getattr(want, field)),
                err_msg=f"{field} (extract_tile={extract_tile})")
        assert 2 < len(np.unique(got.label.numpy())) < init.size // 20


# ---------------------------------------------------------------------------
# The banded dense stage.


def _stream(ds, frames, flows=None, flush=True):
    out = []
    for i, fr in enumerate(frames):
        out += ds.process_frame(False, fr, None if flows is None
                                else flows[i])
    if flush:
        out += ds.process_frame(True)
    return out


@pytest.mark.parametrize("h,bands,pad", [(24, 2, 8), (32, 2, 0),
                                         (32, 3, 16), (80, 11, 8)],
                         ids=["24rows_pad8", "32rows_nopad",
                              "32rows_3bands_pad16", "80rows_11bands_pad8"])
@pytest.mark.parametrize("with_flow", [False, True], ids=["noflow", "flow"])
def test_dense_banded_matches_jax(h, bands, pad, with_flow):
    """`solver_bands=2`, 3 (bench config 4's class, 3 bands and 16 pad
    rows) and 11 (the fused config-5 clip's class: 11 bands, pad rows,
    here of one tile row each) over four chunk solves (free, constrained,
    flush): frames
    edge-padded at ingest, K1 on the padded frame, flow and constraint
    planes padded, per-band seed counts, outputs sliced back to the true
    height.  Every SegFrame and level-0 hierarchy equals JAX's."""
    frames = clip(h=h)
    flows = jax_flows(frames) if with_flow else None
    opts = _options(solver_bands=bands)
    jds = jdense.DenseSegmentation(opts, W, h)
    tds = tdense.DenseSegmentation(toptions(opts), W, h, device="cpu")
    assert (tds._bands, tds._pad_rows) == (jds._bands, jds._pad_rows) \
        == (bands, pad)
    want = _stream(jds, frames, flows)
    got = _stream(tds, frames, flows)
    assert_frames_equal(got, want)
    assert len(tds.solve_diag) == 4
    assert all(sf.frame_height == h for sf in got)
    assert tuple(tds.preprocess(frames[0]).shape) == (h + pad, W, 3)
    # Banding changed the result (the seam's one-row approximations).
    mono = _stream(jdense.DenseSegmentation(_options(), W, h), frames, flows)
    assert any(not np.array_equal(a.lxs, b.lxs) for a, b in zip(want, mono))


def test_dense_banded_flood_matches_jax():
    """The banded stage with the tile flood (K4 over each padded chunk)."""
    frames = clip()
    opts = _options(solver_bands=2, preseg_mode="flood")
    want = _stream(jdense.DenseSegmentation(opts, W, 24), frames)
    tds = tdense.DenseSegmentation(toptions(opts), W, 24, device="cpu")
    got = _stream(tds, frames)
    assert_frames_equal(got, want)
    assert tds._preseg_buffer == [] and len(tds.solve_diag) == 4


def test_dense_auto_bands_matches_jax(capfd):
    """A lowered `max_solve_voxels` takes the automatic branch: 5 x 40 x
    256 = 51,200 voxels over a 30,000 limit solve in 3 bands of 16 rows
    with 8 pad rows, announced on stderr as the JAX package does."""
    h = 40
    frames = clip(h=h, n=7)
    opts = _options(max_solve_voxels=30000)
    jds = jdense.DenseSegmentation(opts, W, h)
    jerr = capfd.readouterr().err
    tds = tdense.DenseSegmentation(toptions(opts), W, h, device="cpu")
    terr = capfd.readouterr().err
    assert (tds._bands, tds._pad_rows) == (jds._bands, jds._pad_rows) \
        == (3, 8)
    assert terr == jerr and "3 row bands (+8 pad rows)" in terr
    assert_frames_equal(_stream(tds, frames), _stream(jds, frames))


def test_dense_banded_bilateral_matches_jax():
    """Bilateral-presmoothed, edge-padded frames through both banded
    stages: the presmooth is exact against XLA's, so the outputs are."""
    frames = clip(n=7)
    opts = _options(solver_bands=2, presmoothing="bilateral")
    jds = jdense.DenseSegmentation(opts, W, 24)
    tds = tdense.DenseSegmentation(toptions(opts), W, 24, device="cpu")
    np.testing.assert_array_equal(tds.preprocess(frames[0]).numpy(),
                                  np.asarray(jds.preprocess(frames[0])))
    assert_frames_equal(_stream(tds, frames), _stream(jds, frames))


@pytest.mark.parametrize("with_flow", [False, True], ids=["noflow", "flow"])
def test_load_state_hands_over_banded_jax_chunk_one(with_flow):
    """A banded JAX run's streaming state after chunk one (padded buffers
    as the JAX object holds them) -> the port: chunk two, the constrained
    banded solve, equals JAX's."""
    frames = clip()
    flows = jax_flows(frames) if with_flow else [None] * len(frames)
    opts = _options(solver_bands=2)
    jds = jdense.DenseSegmentation(opts, W, 24)
    first = _stream(jds, frames[:4], flows[:4], flush=False)
    assert first and jds._overlap_gids
    state = dict(overlap_gids=jds._overlap_gids,
                 max_region_id=jds._max_region_id,
                 chunk_start=jds._chunk_start, chunk_id=jds._chunk_id,
                 num_output_frames=jds._num_output_frames,
                 buffer=[np.asarray(b) for b in jds._buffer],
                 flow_buffer=[None if f is None else np.asarray(f)
                              for f in jds._flow_buffer],
                 has_flow=jds._has_flow)
    assert state["buffer"][0].shape == (32, W, 3)
    assert state["overlap_gids"][0].shape == (24, W)
    tds = tdense.DenseSegmentation(toptions(opts), W, 24, device="cpu")
    tds.load_state(state)
    want = _stream(jds, frames[4:7], flows[4:7], flush=False)
    got = _stream(tds, frames[4:7], flows[4:7], flush=False)
    assert want, "chunk 2 must have been solved"
    assert_frames_equal(got, want)
    # An unbanded stage refuses the padded buffers.
    with pytest.raises(ValueError, match="padded geometry"):
        tdense.DenseSegmentation(toptions(), W, 24,
                                 device="cpu").load_state(state)


@pytest.mark.parametrize("constrained", [False, True],
                         ids=["free", "constrained"])
def test_banded_supertile_levels_match_jax_masked_rounds(constrained):
    """Supertile-gated levels over a banded table: the supertile of a slot
    comes from its original root in the global voxel numbering, so the
    masked rounds and the K3 path (plain version here) both equal JAX's
    masked rounds on the quantized-colour volume."""
    from test_torch_oversegmentation import ST_COMMON, _st_volume
    vol, kw = _st_volume(constrained)
    t, h, w, _ = vol.shape
    init = None
    if constrained:
        # Plane 0's canonical voxel per (constraint id, band).
        key0 = (kw["constraints"][0].astype(np.int64) * 2
                + (np.arange(h) // (h // 2))[:, None]).ravel()
        uniq, first = np.unique(key0, return_index=True)
        init = np.arange(t * h * w, dtype=np.int32).reshape(t, h, w)
        init[0] = first[np.searchsorted(uniq, key0)].reshape(h, w)
        kw["init_label"] = init
    pj = jov.OversegParams(bands=2, band_table_slots=t * (h // 2) * w,
                           st_kernel=False, **ST_COMMON)
    want = jov.oversegment(jnp.asarray(vol), params=pj,
                           **{k: jnp.asarray(v) for k, v in kw.items()})
    assert len(np.unique(np.asarray(want.label))) < vol[..., 0].size // 4
    for st_kernel in (True, False):
        got = tov.oversegment(
            torch.from_numpy(vol),
            params=tov.params_from_jax(pj)._replace(st_kernel=st_kernel),
            **{k: torch.from_numpy(v) for k, v in kw.items()})
        for field in FIELDS:
            np.testing.assert_array_equal(
                getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                err_msg=f"{field} (st_kernel={st_kernel})")
