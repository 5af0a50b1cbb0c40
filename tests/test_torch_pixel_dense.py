"""The v1 pixel solver (OversegParams(edge_table=False)) through the port's
dense stage and its fused multi-clip stage, against the JAX package.

The seeded 10-frame 24x256 clip of tests/test_torch_dense.py streams with
chunk_size=4 (four chunk solves, three of them over overlap constraints)
with the felz pre-segmentation at ingest, with the flood at the
force-merge weight, and with no pre-segmentation (`tile_presegment=False`:
one seed a voxel); every SegFrame's RLE, frame id and level-0 hierarchy
must be exact.  `BatchDenseSegmentation` under v1 is held to the
standalone runs and to the JAX class.  A textured volume checks that the
v1 and the edge-table partitions track each other in both packages (the
JAX package's own check of that reads a video that is not in the repo).
"""

import numpy as np
import pytest
import torch

from test_torch_dense import W, H, _options, assert_frames_equal, clip, run, \
    toptions
from video_segment_tpu.core import dense as jdense
from video_segment_tpu.core import oversegmentation as jov
from video_segment_tpu_torch.core import dense as tdense
from video_segment_tpu_torch.core import oversegmentation as tov

torch.set_num_threads(2)

# name: (dense options, v1 solver knobs).  The flood and the per-voxel
# seeds leave more phase-A roots than the default half-size compact table
# holds at this size; the flood case keeps that (its sink voxels keep
# their phase-A roots), the per-voxel case sizes the table to the volume.
CASES = {
    "felz": (dict(), dict()),
    "flood": (dict(preseg_mode="flood"), dict()),
    "no_preseg": (dict(tile_presegment=False), dict(compact_divisor=1)),
}


def _stages(case):
    kw, knobs = CASES[case]
    opts = _options(**kw)
    return (opts, jov.OversegParams(edge_table=False, **knobs),
            tov.OversegParams(edge_table=False, **knobs))


@pytest.mark.parametrize("case", list(CASES))
def test_dense_v1_matches_jax(case, monkeypatch):
    frames = clip()
    opts, jp, tp = _stages(case)
    jds = jdense.DenseSegmentation(opts, W, H, solver_params=jp)
    want = run(jds, frames)
    from video_segment_tpu_torch.ops import tile_preseg
    thresholds = []
    flood = tile_preseg.tile_presegment
    monkeypatch.setattr(tile_preseg, "tile_presegment",
                        lambda v, thr, m: thresholds.append(thr)
                        or flood(v, thr, m))
    ds = tdense.DenseSegmentation(toptions(opts), W, H, solver_params=tp,
                                  device="cpu")
    got = run(ds, frames)
    assert_frames_equal(got, want)
    assert sorted(sf.frame_index for sf in got) == list(range(10))
    assert len(ds.solve_diag) == 4
    assert all(d.shape == (len(tp.schedule), 3) for d in ds.solve_diag)
    # v1 keeps the default table divisor and sizes its own compact table.
    assert ds._params.table_divisor == jds._params.table_divisor == 8
    assert ds._felz_at_ingest() == (case == "felz")
    assert thresholds == ([ds._params.force_merge_weight] * 4
                          if case == "flood" else [])
    assert max(len(sf.region_ids) for sf in got) > 3


def test_dense_v1_flood_overflow_hits_constraint_cap():
    """The flood at the force-merge weight leaves nearly one seed a voxel;
    at the default half-size compact table the overflow's voxels keep their
    phase-A roots, so the next chunk's overlap planes carry thousands of
    regions.  Past the solver's constraint cap both packages stop with the
    same ValueError (on a 272x480 clip the cap's default 65536 is passed:
    ROADMAP.md Queue 3, R9)."""
    frames = clip(n=6)
    opts = _options(preseg_mode="flood")
    errors = []
    for mod, params, kw in (
            (jdense, jov.OversegParams(edge_table=False,
                                       max_constraints=4096), {}),
            (tdense, tov.OversegParams(edge_table=False,
                                       max_constraints=4096),
             dict(device="cpu"))):
        o = opts if mod is jdense else toptions(opts)
        ds = mod.DenseSegmentation(o, W, H, solver_params=params, **kw)
        with pytest.raises(ValueError, match="exceed the solver cap") as e:
            run(ds, frames)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_batch_v1_matches_jax_and_standalone():
    """Two clips through the fused multi-clip stage under v1 (felz): each
    equals its standalone streaming run and the JAX
    BatchDenseSegmentation."""
    from test_torch_batch import clip as bclip, jopts, run_batch
    from test_torch_batch import W as BW, H as BH
    from test_torch_batch import assert_frames_equal as beq
    from video_segment_tpu.core import batch as jbatch
    from video_segment_tpu_torch.core import batch as tbatch
    from video_segment_tpu_torch.core.options import options_from_jax
    clips = [bclip(12, 0), bclip(12, 3)]
    jp = jov.OversegParams(edge_table=False)
    tp = tov.OversegParams(edge_table=False)
    want = run_batch(jbatch.BatchDenseSegmentation(jopts(), BW, BH, 2,
                                                   solver_params=jp), clips)
    bd = tbatch.BatchDenseSegmentation(options_from_jax(jopts()), BW, BH, 2,
                                       solver_params=tp, device="cpu")
    got = run_batch(bd, clips)
    for i, frames in enumerate(clips):
        ds = tdense.DenseSegmentation(options_from_jax(jopts()), BW, BH,
                                      solver_params=tp, device="cpu")
        single = []
        for fr in frames:
            single += ds.process_frame(False, fr)
        single += ds.process_frame(True)
        beq(got[i], single)
        beq(got[i], want[i])
        assert len(bd.clips[i].solve_diag) == len(ds.solve_diag) > 1


def _textured_volume():
    """A smooth random background under 8x8 random colour blocks with
    light noise, shifted 1 px a frame: (4,48,64,3) float32 in [0,1]."""
    import scipy.ndimage as ndi
    rng = np.random.default_rng(1)
    base = ndi.gaussian_filter(rng.random((48, 64, 3)), (4, 4, 0))
    base = (base - base.min()) / (base.max() - base.min())
    blocks = rng.random((6, 8, 3)).repeat(8, 0).repeat(8, 1)
    img = 0.5 * base + 0.5 * blocks + rng.normal(0, 0.01, (48, 64, 3))
    vol = np.stack([np.roll(img, f, axis=1) for f in range(4)])
    return np.clip(vol, 0, 1).astype(np.float32)


def test_v1_tracks_edge_table_solver():
    """The edge-table solver on flood presegs tracks the v1 pixel solver
    (level-0 boundary F >= 0.85 at 1 px, the JAX package's floor in
    tests/test_oversegmentation.py), in the port and in JAX on the same
    input, and each package's partitions are the other's."""
    import jax.numpy as jnp
    from video_segment_tpu.ops import tile_preseg as jtp
    from video_segment_tpu.segment_util.metrics import \
        boundary_f_measure as jbf
    from video_segment_tpu_torch.ops import tile_preseg as ttp
    from video_segment_tpu_torch.segment_util.metrics import \
        boundary_f_measure as tbf
    vol = _textured_volume()
    p1 = jov.OversegParams(min_region_size=12, edge_table=False,
                           compact_after_levels=1)
    p2 = jov.OversegParams(min_region_size=12, edge_table=True,
                           table_divisor=2, preseg_threshold=0.01)
    jv = jnp.asarray(vol)
    j1 = np.asarray(jov.oversegment(jv, params=p1).label)
    j2 = np.asarray(jov.oversegment(
        jv, init_label=jtp.tile_presegment(jv, 0.01, "l2"), params=p2).label)
    tv = torch.from_numpy(vol)
    t1 = tov.oversegment(tv, params=tov.params_from_jax(p1)).label.numpy()
    t2 = tov.oversegment(
        tv, init_label=ttp.tile_presegment(tv, 0.01, "l2"),
        params=tov.params_from_jax(p2)).label.numpy()
    np.testing.assert_array_equal(t1, j1)
    np.testing.assert_array_equal(t2, j2)
    f_port = tbf(t1, t2, tolerance=1)["f_measure"]
    f_jax = jbf(j1, j2, tolerance=1)["f_measure"]
    assert f_port >= 0.85 and f_jax >= 0.85, (f_port, f_jax)
    assert 10 < len(np.unique(t1)) < vol[..., 0].size // 20


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_dense_v1_card_vs_cpu(case):
    """The v1 dense stage on the card against the port on the CPU: level-0
    boundary F >= 0.9 (only the float-atomic order of the sums differs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels have no CPU mode)")
    import chip_smoke
    frames = clip(n=7)
    opts, _, tp = _stages(case)
    imgs = [chip_smoke.rasterize(run(tdense.DenseSegmentation(
        toptions(opts), W, H, solver_params=tp, device=dev), frames))
        for dev in ("cuda", "cpu")]
    assert chip_smoke.boundary_f(*imgs) >= 0.9
