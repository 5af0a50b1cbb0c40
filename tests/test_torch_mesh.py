"""The port's device mesh against the JAX package's.

The JAX side runs on the 8 virtual CPU devices of `conftest.py`; the port
side on a (2,4) mesh of `cpu` entries (`parallel/mesh.make_mesh(8,
device="cpu")`).  Each case of `tests/test_parallel.py` has its
counterpart here on the same seeded inputs: the mesh shape, the halo
exchange (exact), the sharded presmoothing (within the JAX test's own
tolerances of JAX's sharded filter, and bit for bit against the port's
single-device filter: both filters are elementwise in the same order and
the halo supplies the true neighbour rows), the mesh-sharded banded solve
(labels exact against JAX's and the port's single-device banded solve),
the constrained streaming dense stage on the mesh (id images exact against
JAX's mesh stream and the port's `solver_bands=4` stream), the
agglomeration fed from the mesh's devices (every level exact), the fused
multi-clip solve, the constrained chunk solver with flow, constraints and
the gradient trait, and the port's `entry()` and `dryrun_multichip`.
Tests marked `cuda` run the mesh on one card: every entry `cuda:0`, or
(F8) a mesh of `cuda:0` and the CPU, so that every transfer is real.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from video_segment_tpu.core import agglomeration as jagg
from video_segment_tpu.core import dense as jdense
from video_segment_tpu.core import oversegmentation as jov
from video_segment_tpu.core.options import DenseSegmentationOptions
from video_segment_tpu.ops import tile_felz as jtf
from video_segment_tpu.parallel import mesh as jmesh
from video_segment_tpu_torch.core import agglomeration as tagg
from video_segment_tpu_torch.core import dense as tdense
from video_segment_tpu_torch.core import oversegmentation as tov
from video_segment_tpu_torch.core.options import options_from_jax
from video_segment_tpu_torch.core.region import rasterize_ids
from video_segment_tpu_torch.ops import filters as tfilters
from video_segment_tpu_torch.parallel import entry as tentry
from video_segment_tpu_torch.parallel import mesh as tmesh

from test_parallel import _synthetic_clip
from test_torch_dense import assert_frames_equal
from test_torch_oversegmentation import _volume

torch.set_num_threads(2)

ROWS = P("data", None, "space", None, None)
# The JAX package's mesh test parameters (tests/test_parallel.py).
JPARAMS = jov.OversegParams(min_region_size=1, table_divisor=2,
                            preseg_schedule=(4,), edge_topk=8)
TPARAMS = tov.params_from_jax(JPARAMS)


@pytest.fixture(scope="module")
def jmesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jmesh.make_mesh(8)


@pytest.fixture(scope="module")
def tmesh8():
    return tmesh.make_mesh(8, device="cpu")


def _on(jm, x, spec=ROWS):
    return jax.device_put(jnp.asarray(x), NamedSharding(jm, spec))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_mesh_shape_matches_jax(n, jmesh8):
    """make_mesh's factorisation is JAX's: space = min(4, n) lowered until
    it divides n (8 devices: data 2, space 4)."""
    jm = jmesh.make_mesh(n)
    tm = tmesh.make_mesh(n, device="cpu")
    assert tm.shape == dict(zip(jm.axis_names, jm.devices.shape))
    assert tm.axis_names == jm.axis_names == ("data", "space")
    assert all(d == torch.device("cpu") for d in tm.devices.flat)
    if n == 8:
        assert tm.shape == {"data": 2, "space": 4}
    assert tmesh.make_mesh(n, 1, n, device="cpu").shape == {
        "data": 1, "space": n}


def test_cuda_mesh_raises_without_cuda(tmesh8):
    """A mesh whose devices are `cuda` raises without CUDA; nothing moves
    to the CPU on its own, and a dense stage on a mesh lives on the mesh's
    first device only."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        tmesh.make_mesh(4)
    with pytest.raises(RuntimeError, match="cuda"):
        tmesh.Mesh([["cuda:0"] * 4])
    with pytest.raises(ValueError, match="mesh"):
        tmesh.Mesh(["cpu"] * 4)
    with pytest.raises(ValueError, match="8 devices"):
        tmesh.make_mesh(8, 3, 3, device="cpu")
    opts = options_from_jax(DenseSegmentationOptions(chunk_size=4))
    with pytest.raises(RuntimeError, match="cuda"):
        tdense.DenseSegmentation(opts, 32, 32, mesh=tmesh8, device="cuda")
    ds = tdense.DenseSegmentation(opts, 32, 32, mesh=tmesh8)
    assert ds.device == torch.device("cpu")
    assert (ds._bands, ds._params.bands) == (4, 4)


@pytest.mark.parametrize("border", ["edge", "reflect"])
@pytest.mark.parametrize("halo", [1, 2])
def test_halo_exchange_rows_matches_jax(halo, border, jmesh8):
    rng = np.random.default_rng(5)
    h = 16
    x = rng.random((h, 3, 2)).astype(np.float32)

    def f(blk):
        return jmesh.halo_exchange_rows(blk, "space", halo, border)

    fn = jax.jit(jax.shard_map(f, mesh=jmesh8,
                               in_specs=P("space", None, None),
                               out_specs=P("space", None, None)))
    want = np.asarray(fn(_on(jmesh8, x, P("space", None, None))))
    shards = list(torch.split(torch.from_numpy(x), h // 4))
    got = tmesh.halo_exchange_rows(shards, halo, border)
    assert [tuple(g.shape) for g in got] == [(h // 4 + 2 * halo, 3, 2)] * 4
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)
    if halo == 1 and border == "edge":
        # tests/test_parallel.py's expectation on row indices.
        rows = torch.arange(h, dtype=torch.float32).reshape(h, 1, 1)
        out = torch.cat(tmesh.halo_exchange_rows(
            list(torch.split(rows, 4)), 1)).ravel().tolist()
        expected = []
        for s in range(4):
            r = list(range(s * 4, s * 4 + 4))
            expected += [r[0] if s == 0 else r[0] - 1] + r \
                + [r[-1] if s == 3 else r[-1] + 1]
        assert out == expected


@pytest.mark.parametrize("mode,halo,t,atol", [("gaussian", 1, 2, 1e-5),
                                              ("bilateral", 4, 1, 1e-4)],
                         ids=["gaussian", "bilateral"])
def test_sharded_presmooth_matches_jax(mode, halo, t, atol, jmesh8, tmesh8):
    """Against JAX's sharded filter within the JAX test's tolerance;
    against the port's single-device filter bit for bit."""
    rng = np.random.default_rng(0)
    b, h, w = 2, 32, 16
    vol = rng.random((b, t, h, w, 3), dtype=np.float32)
    want = np.asarray(jmesh.sharded_presmooth(jmesh8, mode, halo=halo)(
        _on(jmesh8, vol)))
    got = tmesh.sharded_presmooth(tmesh8, mode, halo=halo)(
        torch.from_numpy(vol))
    np.testing.assert_allclose(got.numpy(), want, atol=atol)
    single = torch.stack([torch.stack([tfilters.presmooth(img, mode)
                                       for img in clip])
                          for clip in torch.from_numpy(vol)])
    assert torch.equal(got, single)


def _two_clip_volume(rng, b, t, h, w, half):
    vol = np.zeros((b, t, h, w, 3), np.float32)
    colors = rng.random((b, 3, 3)).astype(np.float32)
    for ci in range(b):
        vol[ci, :, :, : w // 2] = colors[ci, 0]
        vol[ci, :, :, w // 2:] = colors[ci, 1]
        vol[ci, :, h // 2 - half:h // 2 + half, 2:7] = colors[ci, 2]
    return vol


@pytest.mark.parametrize("source", ["blocky", "textured"])
def test_sharded_oversegment_matches_jax(source, jmesh8, tmesh8):
    """Clips on "data", bands on "space": labels exact against JAX's
    sharded solve and against the port's single-device banded solve."""
    b, t, h, w = 2, 3, 32, 16
    if source == "blocky":
        vol = _two_clip_volume(np.random.default_rng(0), b, t, h, w, 4)
        params = JPARAMS
    else:
        vol = np.stack([_volume(s, (t, h, 64)) for s in (7, 8)])
        w = 64
        params = jov.OversegParams(min_region_size=8, schedule=(16, 2047),
                                   max_rounds_per_level=4,
                                   max_final_rounds=6, min_size_rounds=6)
    flow = np.zeros((b, t - 1, h, w, 2), np.float32)
    want = np.asarray(jmesh.sharded_oversegment(jmesh8, params)(
        _on(jmesh8, vol), _on(jmesh8, flow)))
    tparams = tov.params_from_jax(params)
    got = tmesh.sharded_oversegment(tmesh8, tparams)(torch.from_numpy(vol))
    assert got.dtype == torch.int32 and tuple(got.shape) == (b, t, h, w)
    np.testing.assert_array_equal(got.numpy(), want)
    for ci in range(b):
        single = tov.oversegment(torch.from_numpy(vol[ci]),
                                 params=tparams._replace(bands=4)).label
        assert torch.equal(got[ci], single)
    with pytest.raises(ValueError, match="data axis"):
        tmesh.sharded_oversegment(tmesh8, tparams)(
            torch.from_numpy(vol[:1]))


def _stream(ds, frames):
    out = []
    for fr in frames:
        out += ds.process_frame(False, fr)
    out += ds.process_frame(True)
    assert ds._chunk_id >= 2  # the constrained path actually ran
    return out


def _ids(frames_out, h, w):
    return [rasterize_ids(f.region_ids, f.interval_counts,
                          np.stack([f.ys, f.lxs, f.rxs], 1), h, w)
            for f in frames_out]


def test_mesh_constrained_streaming_matches_jax(jmesh8, tmesh8):
    """The streaming dense stage with every chunk solve through the mesh
    (constrained planes, frozen plane, global id continuity): id images
    exact against JAX's mesh stream and the port's `solver_bands=4`
    stream; every SegFrame equal to the latter's.  preseg_mode="felz" is
    pinned (the JAX package picks flood off a TPU)."""
    t, h, w = 10, 32, 32
    clip = (_synthetic_clip(np.random.default_rng(0), t, h, w)
            * 255).astype(np.uint8)

    def opts(bands):
        return DenseSegmentationOptions(
            chunk_size=4, enforce_spatial_connectedness=False,
            solver_bands=bands, preseg_mode="felz")

    want = _stream(jdense.DenseSegmentation(opts(0), w, h, mesh=jmesh8),
                   clip)
    ds = tdense.DenseSegmentation(options_from_jax(opts(0)), w, h,
                                  mesh=tmesh8)
    got = _stream(ds, clip)
    bands4 = _stream(tdense.DenseSegmentation(options_from_jax(opts(4)), w,
                                              h, device="cpu"), clip)
    assert len(got) == len(want) == t
    for a, b_, c in zip(_ids(got, h, w), _ids(want, h, w),
                        _ids(bands4, h, w)):
        np.testing.assert_array_equal(a, b_)
        np.testing.assert_array_equal(a, c)
    assert_frames_equal(got, bands4)
    assert len(ds.solve_diag) == 4
    assert max(len(sf.region_ids) for sf in got) > 1


def _agglo_tables():
    rng = np.random.default_rng(0)
    r, rcap, nb = 24, 32, 16
    hist = np.zeros((rcap, nb), np.float32)
    hist[np.arange(r), rng.integers(0, nb, r)] = 100.0
    hist[:r] += rng.random((r, nb)).astype(np.float32)
    sizes = np.zeros(rcap, np.float32)
    sizes[:r] = rng.integers(50, 500, r).astype(np.float32)
    edges = np.stack([np.arange(r - 1), np.arange(1, r)], axis=1)
    fh = np.zeros((0, rcap, 4), np.float32)
    fc = np.zeros((0, rcap), np.float32)
    return hist, fh, fc, sizes, edges, r


def test_mesh_agglomeration_matches_jax(jmesh8, tmesh8):
    """The region tables split by rows over the mesh's devices and
    gathered on the first: the hierarchy equals JAX's row-sharded one and
    the port's single-device one at every level."""
    hist, fh, fc, sizes, edges, r = _agglo_tables()
    want = jagg.agglomerate(
        _on(jmesh8, hist, P(("data", "space"), None)), fh, fc,
        _on(jmesh8, sizes, P(("data", "space"))), edges, r, use_flow=False)
    plain = tagg.agglomerate(hist, fh, fc, sizes, edges, r, use_flow=False,
                             device="cpu")
    got = tagg.agglomerate(tentry.gather_rows(tmesh8, hist), fh, fc,
                           tentry.gather_rows(tmesh8, sizes), edges, r,
                           use_flow=False, device="cpu")
    assert len(got) == len(want) == len(plain) > 0
    for a, b, c in zip(got, want, plain):
        np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(a, c)


def test_fused_oversegment_matches_jax():
    """Clips solved one after the other: labels exact against JAX's
    vmapped program and the port's single-clip solve; the up-front
    max_solve_voxels refusal."""
    b, t, h, w = 3, 3, 16, 16
    vol = _two_clip_volume(np.random.default_rng(0), b, t, h, w, 3)
    flow = np.zeros((b, t - 1, h, w, 2), np.float32)
    want = np.asarray(jmesh.fused_oversegment(JPARAMS)(
        jnp.asarray(vol), jnp.asarray(flow)))
    fn = tmesh.fused_oversegment(TPARAMS)
    got = fn(torch.from_numpy(vol), torch.from_numpy(flow))
    assert tuple(got.shape) == (b, t, h, w)
    np.testing.assert_array_equal(got.numpy(), want)
    for ci in range(b):
        single = tov.oversegment(torch.from_numpy(vol[ci]), params=TPARAMS)
        assert torch.equal(got[ci], single.label)
    small = b * t * h * w - 1
    with pytest.raises(ValueError, match="max_solve_voxels"):
        tmesh.fused_oversegment(TPARAMS, max_solve_voxels=small)(
            torch.from_numpy(vol))
    with pytest.raises(ValueError, match="max_solve_voxels"):
        jmesh.fused_oversegment(JPARAMS, max_solve_voxels=small)(
            jnp.asarray(vol), jnp.asarray(flow))


def test_fused_oversegment_flow_matches_jax():
    """With flow: the temporal edges displaced along it, as JAX's."""
    b, t, h, w = 2, 3, 16, 16
    vol = _two_clip_volume(np.random.default_rng(1), b, t, h, w, 3)
    flow = np.random.default_rng(2).uniform(
        -2, 2, (b, t - 1, h, w, 2)).astype(np.float32)
    want = np.asarray(jmesh.fused_oversegment(JPARAMS, has_flow=True)(
        jnp.asarray(vol), jnp.asarray(flow)))
    got = tmesh.fused_oversegment(TPARAMS, has_flow=True)(
        torch.from_numpy(vol), torch.from_numpy(flow))
    np.testing.assert_array_equal(got.numpy(), want)


def test_entry_matches_jax():
    """entry(): the same 4x64x64 solve step as the JAX package's entry,
    label for label."""
    import __graft_entry__ as ge
    jfn, jargs = ge.entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    fn, args = tentry.entry(device="cpu")
    got = fn(*args)
    assert tuple(got.shape) == (4, 64, 64)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dryrun_multichip_cpu():
    summary = tentry.dryrun_multichip(8, device="cpu")
    assert summary["mesh"] == {"data": 2, "space": 4}
    assert summary["labels"] == (2, 3, 32, 32)
    assert summary["levels"] > 0


def _chunk_inputs(bands=4):
    """A textured (5,32,256) chunk with tile felz presegs, two constrained
    head planes (plane 0 pre-merged per (constraint id, band), as the dense
    stage builds it), a frozen plane and random flow."""
    t, h, w = 5, 32, 256
    vol = _volume(21, (t, h, w))
    pj = jov.OversegParams()
    lab, fin, stats = jtf.tile_felz_reference(
        vol, schedule=pj.preseg_schedule, fin_margin=pj.preseg_fin_margin,
        fin_eager=True, fin_gated=True)
    init = lab.astype(np.int32)
    fin = fin.astype(np.int32)
    cells = tuple(s.astype(np.float32) for s in stats)
    plane = np.arange(h * w)
    left = (plane % w) < w // 2
    constr = np.full((t, h, w), -1, np.int32)
    constr[0] = np.where(left, 0, 1).reshape(h, w)
    constr[1] = np.where((plane % w) < w // 3, 0,
                         np.where(left, 1, 2)).reshape(h, w)
    key0 = (constr[0].astype(np.int64) * bands
            + (np.arange(h) // (h // bands))[:, None]).ravel()
    uniq, first = np.unique(key0, return_index=True)
    init[0] = first[np.searchsorted(uniq, key0)].reshape(h, w)
    key = init[1].astype(np.int64).ravel() * 4 + constr[1].ravel() + 1
    uniq, first = np.unique(key, return_index=True)
    init[1] = (h * w + first[np.searchsorted(uniq, key)]).reshape(h, w)
    fin[:2] = jov.NUM_BUCKETS
    frozen = np.zeros((t, h, w), bool)
    frozen[0] = True
    flow = np.random.default_rng(22).uniform(
        -2, 2, (t - 1, h, w, 2)).astype(np.float32)
    is_root = (init.reshape(-1) == np.arange(init.size)).reshape(
        t, bands, h // bands, w)
    n_seeds = int(is_root.sum(axis=(0, 2, 3)).max())
    params = pj._replace(
        table_divisor=16, min_region_size=20, bands=bands, bands_vmap=True,
        band_table_slots=((n_seeds + 1024 + 16383) // 16384) * 16384,
        gradient_trait=True, extract_tile=False)
    return (vol, flow, init, constr, frozen, fin, cells), params


def test_sharded_chunk_solver_matches_jax(jmesh8, tmesh8):
    """The constrained chunk solve with flow, cell stats, head planes and
    the gradient trait, bands over "space": every field exact against
    JAX's sharded_chunk_solver and the port's single-device banded
    `oversegment`."""
    args, params = _chunk_inputs()
    want = jmesh.sharded_chunk_solver(jmesh8, params, True, True, 2, True)(
        *[jnp.asarray(x) for x in args[:6]],
        tuple(jnp.asarray(c) for c in args[6]))
    tparams = tov.params_from_jax(params)
    targs = [torch.from_numpy(x) for x in args[:6]] + [
        tuple(torch.from_numpy(c) for c in args[6])]
    got = tmesh.sharded_chunk_solver(tmesh8, tparams, True, True, 2, True)(
        *targs)
    vol, flow, init, constr, frozen, fin, cells = targs
    single = tov.oversegment(vol, flow=flow, constraints=constr,
                             init_label=init, frozen=frozen, fin=fin,
                             params=tparams, cell_stats=cells,
                             head_planes=2)
    for field in ("label", "constr", "size", "orig"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
        assert torch.equal(getattr(got, field), getattr(single, field)), \
            field
    assert 2 < len(np.unique(got.label.numpy())) < init.numel() // 20
    with pytest.raises(ValueError, match="space axis"):
        tmesh.sharded_chunk_solver(tmesh8, tparams._replace(bands=2), True,
                                   True, 2, True)(*targs)


@pytest.mark.parametrize("n_dev", [None, 1, 2, 4])
def test_solve_banded_supplied_band_outputs_equal_loop(n_dev):
    """`_solve_banded(band_outputs=...)` with the band phase's outputs
    supplied, the bands spread over `n_dev` mesh entries, equals the solve
    that runs the band loop itself."""
    args, params = _chunk_inputs()
    tparams = tov.params_from_jax(params)
    vol, flow, init, constr, frozen, fin, cells = (
        [torch.from_numpy(x) for x in args[:6]]
        + [tuple(torch.from_numpy(c) for c in args[6])])
    from video_segment_tpu_torch.ops import pixel_distance as pd
    vol = torch.cat([vol, pd.gradient_features(vol)], dim=-1)
    n = init.numel()
    flat = [x.reshape(n) for x in (init, constr, frozen, fin)]
    cells = tuple(c.reshape(n) for c in cells)
    thetas, lr = tov._solve_schedule(tparams)
    outs = tov._band_phase(vol, flow, *flat, tparams, True, cells, 2,
                           devices=None if n_dev is None
                           else [torch.device("cpu")] * n_dev)
    assert len(outs) == 4
    loop = tov._solve_banded(vol, flow, *flat, tparams, thetas, lr, True,
                             cells, 2)
    supplied = tov._solve_banded(vol, flow, *flat, tparams, thetas, lr,
                                 True, cells, 2, band_outputs=outs)
    for field in ("label", "constr", "size", "orig"):
        assert torch.equal(getattr(loop, field), getattr(supplied, field))


# ---------------------------------------------------------------------------
# On the card: every mesh entry is cuda:0.


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the mesh's devices are cuda)")


@pytest.mark.cuda
def test_same_card_mesh_stream_matches_bands_on_card():
    _card()
    from video_segment_tpu_torch.ops import tile_extract
    t, h, w = 10, 32, 256
    clip = (_synthetic_clip(np.random.default_rng(0), t, h, w)
            * 255).astype(np.uint8)
    mesh = tmesh.Mesh([["cuda:0"] * 4])
    opts = options_from_jax(DenseSegmentationOptions(
        chunk_size=4, enforce_spatial_connectedness=False))
    # Float atomics make a sum's last bit depend on the launch's schedule:
    # both streams run with deterministic kernels.
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        tile_extract.tile_reduce_min.launches = 0
        got = _stream(tdense.DenseSegmentation(opts, w, h, mesh=mesh), clip)
        # 4 bands x 4 chunk solves (10 frames, chunk_size 4, flush).
        assert tile_extract.tile_reduce_min.launches == 4 * 4
        opts.solver_bands = 4
        want = _stream(tdense.DenseSegmentation(opts, w, h, device="cuda"),
                       clip)
    finally:
        torch.use_deterministic_algorithms(False)
    assert_frames_equal(got, want)


@pytest.mark.cuda
def test_dryrun_multichip_on_card():
    _card()
    summary = tentry.dryrun_multichip(4)
    assert summary["mesh"] == {"data": 1, "space": 4}


@pytest.mark.cuda
def test_mixed_device_mesh_on_card():
    """F8: a (1,2) mesh of cuda:0 and the CPU makes every transfer of the
    mesh code real.  `chip_smoke.mixed_mesh_check` (phase 28's check) at
    32x256 with chunk 4: the constrained streaming dense stage and
    `sharded_chunk_solver` on its constrained chunk raise no device
    mismatch and return every result on cuda:0; each band's outputs equal
    a single-device `_band_phase` on that band's device (band 1 on the
    CPU, the plain K2); the glued labels reach boundary F >= 0.9 against a
    mesh of cuda:0 alone (band 1's float sums ran on the CPU, F3);
    `halo_exchange_rows` and `sharded_presmooth` equal the single-device
    versions."""
    _card()
    import chip_smoke
    clip = (_synthetic_clip(np.random.default_rng(0), 10, 32, 256)
            * 255).astype(np.uint8)
    chip_smoke.mixed_mesh_check(list(clip), options_from_jax(
        DenseSegmentationOptions(chunk_size=4,
                                 enforce_spatial_connectedness=False)))
