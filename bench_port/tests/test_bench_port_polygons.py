"""The check's polygon rasterizer (`compare.polygon_intervals`): exact on
polygons that partition the frame, and on the port's own vectorized
`seg_tree` output (the CPU, a 64x128 flow-on clip) against the scanlines
the same run keeps with `--keep_rasterization`."""

import numpy as np
import pytest
import scipy.ndimage as ndi

from bench_port import compare


def _desc(h, w, mesh, polys):
    """A frame of the check's own message class: regions with boundary
    polygons over one vertex mesh, no scanlines."""
    d = compare._desc_class()()
    d.frame_width, d.frame_height = w, h
    d.vector_mesh.coord.extend(np.asarray(mesh, np.float32).tolist())
    for rid, rings in polys.items():
        r = d.region.add()
        r.id = rid
        for idx, hole in rings:
            p = r.vectorization.polygon.add()
            p.coord_idx.extend(np.asarray(idx).tolist())
            p.hole = hole
    return d


def _labels(d, h, w):
    return compare.fill(*(np.asarray(a, np.int64) for a in
                          compare.polygon_intervals(d, h, w)), h, w)


def _scene(seed, h=40, w=64):
    """Voronoi cells, a one-pixel stripe, a ring around a hole that holds
    an island of the ring's own id."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, [h, w], (9, 2))
    yy, xx = np.mgrid[0:h, 0:w]
    lab = np.argmin((yy[..., None] - pts[:, 0]) ** 2
                    + (xx[..., None] - pts[:, 1]) ** 2, -1)
    lab[:, w // 3] = 20
    lab[5:25, 30:50] = 21
    lab[9:21, 34:46] = 22
    lab[13:17, 38:42] = 21
    return lab


@pytest.mark.parametrize("seed", [0, 2 ** 33 + 1])
def test_exact_on_crack_polygons(seed):
    from video_segment_tpu_torch.segment_util import joint_boundary
    lab = _scene(seed)
    mesh, polys = joint_boundary.compute_vectorization(lab, max_error=0)
    assert any(hole for rings in polys.values() for _, hole in rings)
    assert np.array_equal(_labels(_desc(*lab.shape, mesh, polys),
                                  *lab.shape), lab)


def test_shared_diagonal_goes_to_one_side():
    # Two triangles of a 4x4 frame split by a diagonal through pixel
    # centres, walked in opposite directions by the two rings: each
    # centre on it goes to exactly one of them.
    mesh = [0, 0, 4, 0, 4, 4, 0, 4]
    for a, b in (((0, 1, 2), (0, 2, 3)), ((2, 3, 1), (1, 0, 3))):
        idx = [2 * v for v in a], [2 * v for v in b]
        lab = _labels(_desc(4, 4, mesh, {1: [(idx[0], False)],
                                         2: [(idx[1], False)]}), 4, 4)
        assert (lab >= 0).all() and (lab == 1).sum() in (6, 10)


def test_gaps_and_overlaps_read_minus_one():
    mesh = [0, 0, 3, 0, 3, 4, 0, 4, 4, 0, 4, 4, 2, 0, 2, 4]
    # Region 1 covers x in [0, 3), region 2 x in [2, 4): column 2 twice.
    lab = _labels(_desc(4, 4, mesh, {1: [([0, 2, 4, 6], False)],
                                     2: [([12, 8, 10, 14], False)]}), 4, 4)
    assert (lab[:, 2] == -1).all() and (lab[:, :2] == 1).all()
    # Region 2 alone: columns 0 and 1 uncovered.
    lab = _labels(_desc(4, 4, mesh, {2: [([12, 8, 10, 14], False)]}), 4, 4)
    assert (lab[:, :2] == -1).all() and (lab[:, 2:] == 2).all()


def _frames(path):
    out = []
    for p in compare.read_container(path):
        d = compare._desc_class()()
        d.ParseFromString(p)
        out.append(d)
    return out


def _overlap_area(d, h, w):
    """How far the polygons' areas (outer rings less holes, by the
    shoelace formula) exceed the frame's: what overlapping polygons
    cover twice."""
    coord = np.asarray(d.vector_mesh.coord, np.float64)
    area = 0.0
    for r in d.region:
        for p in r.vectorization.polygon:
            i = np.asarray(p.coord_idx)
            x, y = coord[i], coord[i + 1]
            area -= 0.5 * np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)
    return area - h * w


def test_port_polygons_against_its_raster(seg_tree_runs):
    """On the port's output the rasterizer leaves no pixel uncovered; the
    pixels it covers twice are exactly the area by which the port's
    polygons overlap (a 1-px region whose ring falls back to its crack
    points while its neighbours' shared segments are simplified across
    it), so those frames count in `frames_wrong`.  Labels that differ
    from the kept scanlines (the polygons' 1-px simplification) lie
    within 1 px of a scanline boundary; about 96.6% of pixels agree."""
    _, _, kept, _ = seg_tree_runs
    h, w = 64, 128
    agree = []
    for d in _frames(kept):
        raster, _ = compare.parse_frame(d.SerializeToString(), w, h)
        assert (raster >= 0).all()
        cover = np.zeros((h, w), int)
        ids, ys, lxs, rxs = compare.polygon_intervals(d, h, w)
        for y, lx, rx in zip(ys, lxs, rxs):
            cover[y, lx:rx + 1] += 1
        assert cover.min() == 1 and cover.max() <= 2
        assert (cover == 2).sum() == _overlap_area(d, h, w)
        poly = _labels(d, h, w)
        assert np.array_equal(poly < 0, cover != 1)
        diff = (poly != raster) & (cover == 1)
        lo = ndi.minimum_filter(raster, 3, mode="nearest")
        hi = ndi.maximum_filter(raster, 3, mode="nearest")
        assert not (diff & (lo == hi)).any()
        agree.append(1 - diff.mean())
    assert 0.95 < np.mean(agree) < 1


def test_stripped_frames_parse_from_polygons(seg_tree_runs):
    """Without `--keep_rasterization` each frame parses from its
    polygons, to the labels the kept run's polygons give, and a frame
    counts as wrong exactly where its polygons overlap."""
    _, stripped, kept, _ = seg_tree_runs
    h, w = 64, 128
    plain = _frames(stripped)
    assert all(d.rasterization_removed and not any(
        len(r.raster.scan_inter) for r in d.region) for d in plain)
    overlapping = 0
    for a, b in zip(plain, _frames(kept)):
        lab, _ = compare.parse_frame(a.SerializeToString(), w, h)
        assert np.array_equal(lab, _labels(b, h, w))
        overlapping += _overlap_area(b, h, w) > 0
    sets, wrong = compare.program_sets(stripped, len(plain), w, h)
    assert wrong == overlapping and sum(len(s) for s, _ in sets) == 24
