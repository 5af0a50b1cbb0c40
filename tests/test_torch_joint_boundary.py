"""The port's vectorized polygons partition every frame
(`segment_util/joint_boundary.compute_vectorization`).

A ring that degenerates after simplification (a 1-px-wide straight
region) is rebuilt from its crack points, and its neighbours walk the
same crack points along the segments they share with it, so every pixel
centre lies in exactly one region's rings and the rings' shoelace areas
sum to W x H.  Held on seeded label images with 1-px-wide and
single-pixel regions and on two flow-on `seg_tree --write_to_file` clips
at 64x128, by a rasterizer written here; frames without a degenerate ring
keep the JAX package's polygons exactly.  The native boundary tracer
(`native.trace_segments`) gives the Python walk's segments in its order,
and the polygons with it are those without it.
"""

import os

import numpy as np
import pytest
import torch

from video_segment_tpu.segment_util import joint_boundary as jjb
from video_segment_tpu_torch import native, proto
from video_segment_tpu_torch.dataio import seg_io
from video_segment_tpu_torch.runtime.trace import Trace
from video_segment_tpu_torch.segment_util import joint_boundary as tjb

torch.set_num_threads(2)


def coverage(h, w, mesh, rings):
    """(H, W) count of the regions whose rings hold each pixel centre
    (x + 0.5, y + 0.5) an odd number of times, and the rings' signed
    shoelace area (outer rings positive, holes negative).  `rings` is a
    list of (region, [vertex index into mesh x positions]) per ring.  A
    ray to the right counts an edge whose y range holds the centre's y,
    half open (lower end in, upper end out)."""
    mesh = np.asarray(mesh, np.float64)
    yc = np.arange(h) + 0.5
    xc = np.arange(w) + 0.5
    parity: dict = {}
    area = 0.0
    for rid, idx in rings:
        idx = np.asarray(idx, np.int64)
        x, y = mesh[idx], mesh[idx + 1]
        xn, yn = np.roll(x, -1), np.roll(y, -1)
        area -= 0.5 * np.sum(x * yn - xn * y)
        par = parity.setdefault(rid, np.zeros((h, w), bool))
        for x0, y0, x1, y1 in zip(x, y, xn, yn):
            if y0 == y1:
                continue
            if y0 > y1:
                x0, y0, x1, y1 = x1, y1, x0, y0
            rows = (yc >= y0) & (yc < y1)
            if rows.any():
                cross = x0 + (yc[rows] - y0) * (x1 - x0) / (y1 - y0)
                par[rows] ^= xc[None, :] < cross[:, None]
    cover = sum((p.astype(np.int64) for p in parity.values()),
                np.zeros((h, w), np.int64))
    return cover, area


def desc_coverage(desc):
    """`coverage` of a parsed frame's polygons, at its frame size."""
    rings = [(r.id, list(p.coord_idx)) for r in desc.region
             for p in r.vectorization.polygon]
    return coverage(desc.frame_height, desc.frame_width,
                    desc.vector_mesh.coord, rings)


def _rings(polys):
    return [(rid, idx) for rid, plist in polys.items() for idx, _ in plist]


def scene(seed, h=40, w=64):
    """Voronoi cells crossed by 1-px-wide rows, columns and a diagonal,
    with single-pixel regions: ids that need no connectedness."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, [h, w], (12, 2))
    yy, xx = np.mgrid[0:h, 0:w]
    lab = np.argmin((yy[..., None] - pts[:, 0]) ** 2
                    + (xx[..., None] - pts[:, 1]) ** 2, -1)
    for k in range(6):
        if rng.random() < 0.5:
            lab[:, rng.integers(w)] = 20 + k
        else:
            lab[rng.integers(h), :] = 30 + k
    for k in range(8):
        lab[rng.integers(h), rng.integers(w)] = 40 + k
    for t in range(min(h, w) - 5):
        lab[t + 2, t + rng.integers(0, 2)] = 50
    return lab


def noise(seed, h=32, w=48):
    """Random ids a pixel: regions of every shape, most of them 1 px."""
    return np.random.default_rng(seed).integers(0, 4, (h, w))


LABELS = ([pytest.param(scene, s, id=f"scene{s}") for s in (0, 2, 23, 29,
                                                             2 ** 33 + 1)]
          + [pytest.param(noise, s, id=f"noise{s}") for s in (1, 2 ** 32)])


@pytest.mark.parametrize("make,seed", LABELS)
def test_seeded_labels_are_partitioned(make, seed):
    lab = make(seed)
    h, w = lab.shape
    trace = Trace()
    mesh, polys = tjb.compute_vectorization(lab, trace=trace)
    cover, area = coverage(h, w, mesh, _rings(polys))
    assert (cover == 1).all(), (int((cover == 0).sum()),
                                int((cover > 1).sum()))
    assert area == h * w
    n = trace.counters
    assert n["encode.rings"] == sum(len(p) for p in polys.values()) > 0
    assert n["encode.ring_fallbacks"] > 0


def test_degenerate_rings_overlapped_before():
    """The JAX package (unchanged: it keeps the fallback ring alone) covers
    the pixels of a 1-px stripe twice on the same labels."""
    lab = scene(0)
    h, w = lab.shape
    mesh, polys = jjb.compute_vectorization(lab)
    cover, area = coverage(h, w, mesh, _rings(polys))
    assert cover.max() == 2 and (cover > 1).sum() == area - h * w > 0


def test_frames_without_degenerate_rings_keep_their_polygons():
    """Blocky labels (no 1-px-wide region): the same mesh and rings as
    the JAX package's, and no fallback counted."""
    rng = np.random.default_rng(6)
    small = rng.integers(0, 9, (6, 10))
    lab = np.repeat(np.repeat(small, 4, 0), 4, 1) * 3 + 100
    trace = Trace()
    mesh, polys = tjb.compute_vectorization(lab, trace=trace)
    jmesh, jpolys = jjb.compute_vectorization(lab)
    assert trace.counters["encode.ring_fallbacks"] == 0
    assert np.array_equal(mesh, jmesh) and polys.keys() == jpolys.keys()
    for rid, rings in polys.items():
        assert len(rings) == len(jpolys[rid])
        for (a, ha), (b, hb) in zip(rings, jpolys[rid]):
            assert ha == hb and np.array_equal(a, b)


def blocks(seed, h=24, w=40):
    """4x4 blocks of random ids: no 1-px-wide region."""
    small = np.random.default_rng(seed).integers(0, 9, (h // 4, w // 4))
    return np.repeat(np.repeat(small, 4, 0), 4, 1) * 3 + 100


def strip(seed, h=1, w=37):
    """A single row (or, transposed, column) of random ids."""
    lab = np.random.default_rng(seed).integers(0, 3, (h, w))
    return lab.T if seed % 2 else lab


def uniform(seed, h=7, w=9):
    return np.full((h, w), seed)


TRACED = LABELS + [pytest.param(blocks, 6, id="blocks6"),
                   pytest.param(strip, 3, id="column3"),
                   pytest.param(strip, 4, id="row4"),
                   pytest.param(uniform, 5, id="uniform5")]


@pytest.mark.parametrize("make,seed", TRACED)
def test_native_tracer_walks_as_python(make, seed):
    if not native.available():
        pytest.skip("the native library needs g++")
    lab = make(seed)
    got = tjb.trace_segments(lab)
    want = tjb._trace_segments_py(lab)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert np.array_equal(a.pop("points"), b.pop("points"))
        assert a == b


@pytest.mark.parametrize("make,seed", TRACED)
def test_polygons_without_native_tracer_are_equal(make, seed, monkeypatch):
    lab = make(seed)
    mesh, polys = tjb.compute_vectorization(lab)
    monkeypatch.setattr(native, "_load", lambda: None)
    pmesh, ppolys = tjb.compute_vectorization(lab)
    assert mesh.dtype == pmesh.dtype and np.array_equal(mesh, pmesh)
    assert list(polys) == list(ppolys)
    for rid, rings in polys.items():
        assert len(rings) == len(ppolys[rid])
        for (a, ha), (b, hb) in zip(rings, ppolys[rid]):
            assert ha == hb and a.dtype == b.dtype and np.array_equal(a, b)


def test_ids_beyond_int32_take_the_python_walk(monkeypatch):
    lab = scene(2).astype(np.int64) + 2 ** 40
    calls = []
    monkeypatch.setattr(native, "trace_segments",
                        lambda x: calls.append(x) or None)
    segs = tjb.trace_segments(lab)
    assert not calls
    assert max(max(g["left"], g["right"]) for g in segs) >= 2 ** 40


# Two flow-on 64x128 clips through `seg_tree --write_to_file`, polygons
# only, as the benchmark's flow cell writes them at 272x480.
CONFIG = {
    "name": "flow_small", "width": 128, "height": 64, "use_flow": True,
    "dense_options": {"chunk_size": 4},
    "region_options": {"chunk_set_size": 6, "chunk_set_overlap": 2,
                       "constraint_chunks": 1, "use_flow": True},
}
TRAFFIC = {
    "entry": "seg_tree_cli", "clip_frames": 24, "warmup_frames": 9,
    "shapes": 12, "sizes": "fixed", "texture": 20.0, "noise": 3.0,
    "texture_motion": "rigid", "checks": ["flow_epe"],
}


@pytest.fixture(scope="module", params=[2 ** 33 + 9, 2 ** 33 + 13])
def clip_run(request, tmp_path_factory):
    """(stripped .pb, the run's trace) of one clip."""
    from bench_port import harness
    from bench_port.entries import seg_tree_cli
    from video_segment_tpu_torch.tools import seg_tree
    work = str(tmp_path_factory.mktemp("clip"))
    frames, _ = harness.make_clip(TRAFFIC, CONFIG, request.param)
    entry = seg_tree_cli.Entry(CONFIG, "cpu", work)
    src = entry._link(entry.prepare(frames))
    pb = os.path.join(work, "out.pb")
    rc, trace = seg_tree.run(["--input_file", src, "--output_file", pb,
                              "--write_to_file", "--device", "cpu",
                              *entry.flags])
    assert rc == 0
    return pb, trace


def test_seg_tree_polygons_are_partitioned(clip_run):
    pb, trace = clip_run
    h, w = CONFIG["height"], CONFIG["width"]
    r = seg_io.SegmentationReader(pb)
    assert r.open_and_read_headers()
    n = 0
    for payload in r:
        d = proto.SegmentationDesc()
        d.ParseFromString(payload)
        assert d.rasterization_removed
        assert (d.frame_height, d.frame_width) == (h, w)
        cover, area = desc_coverage(d)
        assert (cover == 1).all(), (n, int((cover != 1).sum()))
        assert area == h * w, n
        n += 1
    r.close()
    assert n == TRAFFIC["clip_frames"]
    counters = trace.counters
    assert counters["encode.ring_fallbacks"] > 0
    assert counters["encode.rings"] > counters["encode.ring_fallbacks"]
