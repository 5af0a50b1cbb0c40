"""Port dense stage against the JAX DenseSegmentation.

A seeded 10-frame 24x256 clip streams through both dense stages with
chunk_size=4 (four chunk solves, flush included), with the felz and the
flood pre-segmentation, with supertile-gated solver levels, and with
JAX-computed backward flow fed to both; every
SegFrame's RLE and the level-0 hierarchies must be exact.  Most cases feed
the clip unsmoothed (presmoothing="none"); the filters are compared
separately below, bit for bit (the port rounds as XLA's CPU backend
contracts the multiply-adds, and uses XLA's exp polynomial), and one case
streams bilateral-presmoothed frames through both stages.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from video_segment_tpu.core import dense as jdense
from video_segment_tpu.core.options import DenseSegmentationOptions
from video_segment_tpu.ops import cc as jcc
from video_segment_tpu.ops import filters as jfilters
from video_segment_tpu_torch.core import dense as tdense
from video_segment_tpu_torch.core.options import (
    DenseSegmentationOptions as TDenseSegmentationOptions, options_from_jax)
from video_segment_tpu_torch.ops import cc as tcc
from video_segment_tpu_torch.ops import filters as tfilters

torch.set_num_threads(2)

H, W, N_FRAMES = 24, 256, 10


def clip(n=N_FRAMES, h=H, w=W, seed=3):
    """Moving piecewise-smooth shapes plus noise, BGR uint8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([40 + 60 * xx / w, 90 + 40 * yy / h,
                     160 - 50 * xx / w], -1)
    frames = []
    for f in range(n):
        img = base.copy()
        cx = 40 + 9 * f
        img[(xx - cx) ** 2 + 4 * (yy - h / 2) ** 2 < 120] = (200, 60, 50)
        img[4:12, 150 + 3 * f:190 + 3 * f] = (30, 180, 90)
        img[:, 220:] = (120, 120, 230)
        img += rng.normal(0, 4, img.shape)
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return frames


def options():
    return DenseSegmentationOptions(chunk_size=4, presmoothing="none",
                                    frac_min_region_size=0.05,
                                    preseg_mode="felz")


def toptions(opts=None):
    """The port's options equal to `opts` (default `options()`)."""
    return options_from_jax(opts or options())


def run(ds, frames, flush=True):
    out = []
    for fr in frames:
        out += ds.process_frame(False, fr)
    if flush:
        out += ds.process_frame(True)
    return out


def assert_frames_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.frame_index == b.frame_index
        assert (a.chunk_id, a.chunk_size, a.hierarchy_frame_idx) == \
            (b.chunk_id, b.chunk_size, b.hierarchy_frame_idx)
        for f in ("region_ids", "interval_counts", "ys", "lxs", "rxs"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f"frame {a.frame_index} {f}")
        assert (a.hierarchy is None) == (b.hierarchy is None)
        if a.hierarchy is not None:
            ha, hb = a.hierarchy[0], b.hierarchy[0]
            for f in ("ids", "sizes", "start_frames", "end_frames",
                      "neighbor_pairs"):
                np.testing.assert_array_equal(getattr(ha, f), getattr(hb, f),
                                              err_msg=f"hierarchy {f}")


def test_dense_matches_jax():
    frames = clip()
    want = run(jdense.DenseSegmentation(options(), W, H), frames)
    ds = tdense.DenseSegmentation(toptions(), W, H, device="cpu")
    got = run(ds, frames)
    assert_frames_equal(got, want)
    assert sorted(sf.frame_index for sf in got) == list(range(N_FRAMES))
    assert max(len(sf.region_ids) for sf in got) > 3
    assert set(ds.stage_seconds) == {"ingest_preseg", "chunk_solve",
                                     "host_tail"}


def test_dense_bilateral_matches_jax():
    """The default presmoothing on both sides: the bilateral filter is
    exact against XLA's, so the dense outputs are."""
    frames = clip(n=7)
    opts = _options(presmoothing="bilateral")
    want = run(jdense.DenseSegmentation(opts, W, H), frames)
    got = run(tdense.DenseSegmentation(toptions(opts), W, H, device="cpu"),
              frames)
    assert_frames_equal(got, want)
    assert max(len(sf.region_ids) for sf in got) > 2


def jax_flows(frames):
    """Backward TV-L1 flow of each frame (None for the first), computed by
    the JAX package: the arrays both packages are fed."""
    from video_segment_tpu.core import flow as jflow
    gray = [jnp.asarray(jflow.bgr_to_gray(f)) for f in frames]
    return [None] + [np.asarray(jflow.tvl1_flow(gray[i], gray[i - 1]))
                     for i in range(1, len(frames))]


@pytest.mark.parametrize("form", ["arrays", "flowfields"])
def test_dense_flow_matches_jax(form):
    """Flow-displaced temporal edges and flow-advected connectedness over
    four chunk solves: exact against JAX given the same flow arrays, passed
    to the port as host arrays or as device-resident FlowFields."""
    from video_segment_tpu_torch.core import flow as tflow
    frames = clip()
    flows = jax_flows(frames)
    assert max(np.abs(f).max() for f in flows[1:]) > 1.0
    jds = jdense.DenseSegmentation(options(), W, H)
    want = []
    for fr, fl in zip(frames, flows):
        want += jds.process_frame(False, fr, fl)
    want += jds.process_frame(True)
    ds = tdense.DenseSegmentation(toptions(), W, H, device="cpu")
    got = []
    for fr, fl in zip(frames, flows):
        if fl is not None and form == "flowfields":
            fl = tflow.FlowField(dev=torch.tensor(fl))
        got += ds.process_frame(False, fr, fl)
    got += ds.process_frame(True)
    assert_frames_equal(got, want)
    assert len(ds.solve_diag) == 4
    # The flow changed the segmentation (it reached the solver).
    plain = run(jdense.DenseSegmentation(options(), W, H), frames)
    assert any(not np.array_equal(a.region_ids, b.region_ids)
               or not np.array_equal(a.lxs, b.lxs)
               for a, b in zip(want, plain))


def test_load_state_hands_over_jax_chunk_one():
    """JAX's streaming state after chunk 1 -> the port: the port's chunk 2
    (the constrained solve) equals JAX's."""
    frames = clip()
    jds = jdense.DenseSegmentation(options(), W, H)
    first = run(jds, frames[:4], flush=False)
    assert first and jds._overlap_gids          # chunk 1 emitted
    state = dict(overlap_gids=jds._overlap_gids,
                 max_region_id=jds._max_region_id,
                 chunk_start=jds._chunk_start, chunk_id=jds._chunk_id,
                 num_output_frames=jds._num_output_frames,
                 buffer=[np.asarray(b) for b in jds._buffer])
    tds = tdense.DenseSegmentation(toptions(), W, H, device="cpu")
    tds.load_state(state)
    want = run(jds, frames[4:7], flush=False)
    got = run(tds, frames[4:7], flush=False)
    assert want, "chunk 2 must have been solved"
    assert_frames_equal(got, want)


def test_load_state_with_flow_hands_over_jax_chunk_one():
    """JAX's streaming state after chunk 1 of a flow run (its checkpoint
    keys flow_buffer and has_flow included) -> the port: the port's
    constrained, flow-displaced chunk 2 equals JAX's."""
    frames = clip()
    flows = jax_flows(frames)
    jds = jdense.DenseSegmentation(options(), W, H)
    for fr, fl in zip(frames[:4], flows[:4]):
        jds.process_frame(False, fr, fl)
    state = dict(overlap_gids=jds._overlap_gids,
                 max_region_id=jds._max_region_id,
                 chunk_start=jds._chunk_start, chunk_id=jds._chunk_id,
                 num_output_frames=jds._num_output_frames,
                 buffer=[np.asarray(b) for b in jds._buffer],
                 flow_buffer=[None if f is None else np.asarray(f)
                              for f in jds._flow_buffer],
                 has_flow=jds._has_flow)
    assert state["has_flow"] and state["flow_buffer"][0] is not None
    tds = tdense.DenseSegmentation(toptions(), W, H, device="cpu")
    tds.load_state(state)
    want, got = [], []
    for fr, fl in zip(frames[4:7], flows[4:7]):
        want += jds.process_frame(False, fr, fl)
        got += tds.process_frame(False, fr, fl)
    assert want, "chunk 2 must have been solved"
    assert_frames_equal(got, want)


def test_async_tail_matches_sync():
    frames = clip(n=9)
    sync = run(tdense.DenseSegmentation(toptions(), W, H, device="cpu"),
               frames)
    opts = toptions()
    opts.async_tail = True
    asyn = run(tdense.DenseSegmentation(opts, W, H, device="cpu"), frames)
    assert_frames_equal(asyn, sync)


@pytest.mark.parametrize("mode", ["gaussian", "bilateral"])
def test_presmooth_matches_jax(mode):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (H, 64, 3)).astype(np.float32) / 255
    want = np.asarray(jfilters.presmooth(jnp.asarray(img), mode))
    got = tfilters.presmooth(torch.from_numpy(img), mode).numpy()
    # The port rounds the multiply-adds as XLA contracts them, and the
    # bilateral weights use XLA's own exp polynomial.
    np.testing.assert_array_equal(got, want)


def test_xla_exp_matches_jax():
    """`xla_exp` equals `jit(jnp.exp)` bit for bit over the bilateral
    filter's argument range and beyond it, flushed denormals included."""
    import jax
    from video_segment_tpu_torch.ops.histograms import xla_exp
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-40, 0, 400000),
                        rng.uniform(-100, 100, 100000),
                        -np.abs(rng.normal(0, 1e-3, 50000)),
                        [0.0, -87.4, -88.0, 88.0, 89.0]]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.exp)(jnp.asarray(x)))
    got = xla_exp(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (torch.exp(torch.from_numpy(x)).numpy() != want).mean() > 0.05


def test_finalize_labels_matches_rle_n4():
    from video_segment_tpu.ops import rle
    rng = np.random.default_rng(2)
    lab = rng.integers(0, 3, (2, 8, 11)).astype(np.int32)
    got = tdense._finalize_labels(torch.from_numpy(lab), 8, True).numpy()
    for f in range(2):
        np.testing.assert_array_equal(got[f],
                                      rle.enforce_n4_connectivity(lab[f]))
    # Pad rows are sliced off before the stencil, as in the JAX package.
    got = tdense._finalize_labels(torch.from_numpy(lab), 6, True).numpy()
    want = np.asarray(jdense._finalize_labels(jnp.asarray(lab), 6, True))
    assert got.shape == (2, 6, 11)
    np.testing.assert_array_equal(got, want)


def test_pointer_jump_and_cycles_match_jax():
    rng = np.random.default_rng(4)
    n = 500
    parent = np.arange(n, dtype=np.int32)
    hook = rng.random(n) < 0.6
    parent[hook] = rng.integers(0, n, hook.sum())
    parent = np.minimum(parent, np.arange(n))          # acyclic forest
    mutual = np.arange(n, dtype=np.int32)
    mutual[0], mutual[1] = 1, 0
    for p in (parent, mutual):
        np.testing.assert_array_equal(
            tcc.hook_and_resolve(torch.from_numpy(p)).numpy(),
            np.asarray(jcc.hook_and_resolve(jnp.asarray(p))))


def test_scope_raises(capsys):
    with pytest.raises(ValueError):
        tdense.DenseSegmentation(
            TDenseSegmentationOptions(preseg_mode="watershed"), W, H,
            device="cpu")
    # Chunks over max_solve_voxels, or solver_bands, build banded stages
    # with the band count and pad rows the JAX package computes.
    for (w, h), bands, pad in (((1920, 1080), 6, 24), ((480, 854), 2, 10),
                               ((720, 1280), 3, 16), ((1080, 1920), 6, 0)):
        tds = tdense.DenseSegmentation(TDenseSegmentationOptions(), w, h,
                                       device="cpu")
        jds = jdense.DenseSegmentation(DenseSegmentationOptions(), w, h)
        assert (tds._bands, tds._pad_rows) == (jds._bands, jds._pad_rows) \
            == (bands, pad)
        assert tds._params.bands == bands
    tds = tdense.DenseSegmentation(toptions(_options(solver_bands=2)), W,
                                   H, device="cpu")
    jds = jdense.DenseSegmentation(_options(solver_bands=2), W, H)
    assert (tds._bands, tds._pad_rows) == (jds._bands, jds._pad_rows) \
        == (2, 8)
    # Too few forced bands leave a band over the voxel limit.
    for mod, opts in ((tdense, toptions(_options(solver_bands=2,
                                                 max_solve_voxels=10000))),
                      (jdense, _options(solver_bands=2,
                                        max_solve_voxels=10000))):
        kw = dict(device="cpu") if mod is tdense else {}
        with pytest.raises(ValueError, match="max_solve_voxels"):
            mod.DenseSegmentation(opts, W, H, **kw)
    # The v1 pixel solver has no bands: over the voxel budget it shrinks
    # chunk_size and says so on stderr, as the JAX package does.
    from video_segment_tpu.core import oversegmentation as jov
    from video_segment_tpu_torch.core import oversegmentation as tov
    for w, h, want in ((480, 854, 18), (1920, 1080, 3), (W, H, 20)):
        capsys.readouterr()
        tds = tdense.DenseSegmentation(
            TDenseSegmentationOptions(chunk_size=20), w, h, device="cpu",
            solver_params=tov.OversegParams(edge_table=False))
        t_err = capsys.readouterr().err
        jds = jdense.DenseSegmentation(
            DenseSegmentationOptions(chunk_size=20), w, h,
            solver_params=jov.OversegParams(edge_table=False))
        j_err = capsys.readouterr().err
        assert tds.options.chunk_size == jds.options.chunk_size == want
        assert (tds._bands, tds._pad_rows) == (jds._bands, jds._pad_rows) \
            == (1, 0)
        assert t_err == j_err
        assert ("[dense] chunk_size 20 -> " in t_err) == (want != 20)


@pytest.mark.parametrize("w,h,bands,pad", [(720, 1280, 5, 0),
                                           (1080, 1920, 11, 16)],
                         ids=["720x1280", "1080x1920"])
def test_fused_geometry_matches_jax(w, h, bands, pad):
    """The geometry loop above for the fused batch at bench configs 4 and
    5's sizes: with 2 clips each clip gets half the voxel budget, so it
    bands differently from a standalone stage (3 and 6 bands there), and
    the port's clips take the JAX package's bands and pad rows."""
    from video_segment_tpu.core import batch as jbatch
    from video_segment_tpu_torch.core import batch as tbatch
    tb = tbatch.BatchDenseSegmentation(TDenseSegmentationOptions(), w, h, 2,
                                       device="cpu")
    jb = jbatch.BatchDenseSegmentation(DenseSegmentationOptions(), w, h, 2)
    assert len(tb.clips) == len(jb.clips) == 2
    for tc, jc in zip(tb.clips, jb.clips):
        assert (tc._bands, tc._pad_rows) == (jc._bands, jc._pad_rows) \
            == (bands, pad)
        assert tc._params.bands == bands
        assert tc.options.max_solve_voxels == jc.options.max_solve_voxels \
            == DenseSegmentationOptions().max_solve_voxels // 2


def _options(**kw):
    opts = options()
    for k, v in kw.items():
        setattr(opts, k, v)
    return opts


def test_dense_flood_matches_jax():
    """preseg_mode="flood": K4 over each padded chunk volume, no preseg
    fins or cell stats, constrained planes pre-merged per (flood region x
    constraint id), table divisor left at 8."""
    frames = clip()
    opts = _options(preseg_mode="flood")
    jds = jdense.DenseSegmentation(opts, W, H)
    want = run(jds, frames)
    ds = tdense.DenseSegmentation(toptions(opts), W, H, device="cpu")
    got = run(ds, frames)
    assert len(ds.solve_diag) == 4
    assert ds._params.table_divisor == jds._params.table_divisor == 8
    assert ds._preseg_buffer == []
    assert_frames_equal(got, want)
    assert max(len(sf.region_ids) for sf in got) > 3


def test_load_state_flood_builds_no_felz_presegs(monkeypatch):
    frames = clip()
    opts = _options(preseg_mode="flood")
    jds = jdense.DenseSegmentation(opts, W, H)
    run(jds, frames[:4], flush=False)
    state = dict(overlap_gids=jds._overlap_gids,
                 max_region_id=jds._max_region_id,
                 chunk_start=jds._chunk_start, chunk_id=jds._chunk_id,
                 num_output_frames=jds._num_output_frames,
                 buffer=[np.asarray(b) for b in jds._buffer])
    tds = tdense.DenseSegmentation(toptions(opts), W, H, device="cpu")

    def no_felz(*a, **k):
        raise AssertionError("felz preseg built in flood mode")

    monkeypatch.setattr(tds, "_preseg_frame", no_felz)
    tds.load_state(state)
    assert_frames_equal(run(tds, frames[4:7], flush=False),
                        run(jds, frames[4:7], flush=False))


ST_SOLVER = dict(preseg_pair_merge=True, st_levels=3, st_h=16, st_w=128)


def _st_run(st_kernel):
    from video_segment_tpu.core import oversegmentation as jov
    from video_segment_tpu_torch.core import oversegmentation as tov
    frames = clip()
    jp = jov.OversegParams(st_kernel=False, **ST_SOLVER)
    want = run(jdense.DenseSegmentation(options(), W, H, solver_params=jp),
               frames)
    tp = tov.params_from_jax(jp)._replace(st_kernel=st_kernel)
    ds = tdense.DenseSegmentation(toptions(), W, H, solver_params=tp,
                                  device="cpu")
    return run(ds, frames), want, ds


def test_dense_supertile_masked_matches_jax():
    """Fine presegs (preseg_pair_merge) with three supertile-gated levels
    as masked rounds: exact against JAX's masked rounds."""
    got, want, ds = _st_run(False)
    assert_frames_equal(got, want)
    assert all(d[0, 0] > 4096 for d in ds.solve_diag)   # global table


def test_dense_supertile_kernel_path_vs_jax_masked():
    """The K3 path (plain version here) re-aggregates region statistics
    from the seed rows in another float order than the masked rounds'
    incremental sums, so a merge test at a float tie may flip: held to
    the JAX masked run at boundary F >= 0.98 per chunk, same frames."""
    import chip_smoke
    got, want, ds = _st_run(True)
    assert [sf.frame_index for sf in got] == [sf.frame_index for sf in want]
    assert all((d[:3, 0] == 4096).all() for d in ds.solve_diag)   # K3 rows
    img = chip_smoke.rasterize(got)
    ref = chip_smoke.rasterize(want)
    assert chip_smoke.boundary_f(img, ref) >= 0.98


DENSE_KNOBS = {
    "variance": (dict(), dict(descriptor="color_mean_variance",
                              merge_threshold=0.1, split_threshold=0.75)),
    "gradient": (dict(), dict(gradient_trait=True)),
    "two_stage": (dict(two_stage_oversegment=True), dict()),
}


def _knob_stages(knob):
    from video_segment_tpu.core import oversegmentation as jov
    from video_segment_tpu_torch.core import oversegmentation as tov
    opt_kw, solver_kw = DENSE_KNOBS[knob]
    opts = _options(**opt_kw)
    jp = jov.OversegParams(**solver_kw)
    return opts, jp, tov.params_from_jax(jp)


@pytest.mark.parametrize("knob", list(DENSE_KNOBS))
def test_dense_knobs_match_jax(knob):
    """The dense stage with the variance descriptor, the gradient trait
    (solver_params) and the two-stage solve (the dense option; the stage
    sets OversegParams.two_stage from it), felz pinned: exact against
    JAX over three chunk solves."""
    frames = clip(n=7)
    opts, jp, tp = _knob_stages(knob)
    want = run(jdense.DenseSegmentation(opts, W, H, solver_params=jp),
               frames)
    ds = tdense.DenseSegmentation(toptions(opts), W, H, solver_params=tp,
                                  device="cpu")
    got = run(ds, frames)
    assert ds._params.two_stage == (knob == "two_stage")
    assert_frames_equal(got, want)
    assert max(len(sf.region_ids) for sf in got) > 3


@pytest.mark.cuda
@pytest.mark.parametrize("knob", list(DENSE_KNOBS))
def test_dense_knobs_card_vs_cpu(knob):
    """Each knob's dense stage on the card against the port on the CPU:
    level-0 boundary F >= 0.9 (only float-atomic order differs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels have no CPU mode)")
    import chip_smoke
    frames = clip(n=7)
    opts, _, tp = _knob_stages(knob)
    imgs = [chip_smoke.rasterize(run(tdense.DenseSegmentation(
        toptions(opts), W, H, solver_params=tp, device=dev), frames))
        for dev in ("cuda", "cpu")]
    assert chip_smoke.boundary_f(*imgs) >= 0.9
