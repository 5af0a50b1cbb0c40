"""The port's command-line tools, on the CPU, against the JAX package's.

Everything runs with `--device cpu` on tiny seeded inputs (32x24 MJPG clips
written here with cv2, chunk_size 4-5).  MJPG is lossy, so every comparison
decodes the same file on both sides; where flow is on, both sides read the
same `.flow` cache.  Tolerance: exact (bytes or arrays equal) everywhere
except the flow fields the port's CLI computes itself, which are held to
the JAX engine's within the TV-L1 tolerance of tests/test_torch_flow.py,
and the vectorized polygons of a frame whose JAX polygons overlap (a
degenerate ring that the JAX package leaves apart from its neighbours, and
the port repairs): there the port's polygons partition the frame and all
else is equal (`assert_pb_matches_jax`).

The two packages resolve `preseg_mode="auto"` differently off a TPU (felz
here, flood there) and `seg_tree` has no flag for it, so the parity cases
pin the mode from the test: `DenseSegmentation` is wrapped in both packages
so that it receives `dataclasses.replace(options, preseg_mode=...)`.
"""

import dataclasses
import os
import shutil
import sys
import threading

import numpy as np
import pytest
import torch

from video_segment_tpu_torch import _build, proto
from video_segment_tpu_torch.core import dense as tdense
from video_segment_tpu_torch.core import flow as tflow
from video_segment_tpu_torch.core.options import DenseSegmentationOptions
from video_segment_tpu_torch.dataio import emit, seg_io
from video_segment_tpu_torch.tools import (batch_segment, converter, renderer,
                                           seg_tree, video_example, viewer)

torch.set_num_threads(2)

FLOW_TOL = 1e-3   # px, as tests/test_torch_flow.py
COMMON = ["--write_to_file", "--chunk_size", "4", "--max_rate", "0",
          "--no-dynamic_rate"]


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def assert_pb_matches_jax(got_path, want_path):
    """The port's `.pb` equals the JAX package's frame for frame, byte for
    byte, except in frames whose JAX polygons cover a pixel twice: there
    the port's polygons partition the frame (each pixel centre in one
    region, shoelace areas summing to W x H) and everything else in the
    frame is equal.  Returns the count of such frames."""
    from test_torch_joint_boundary import desc_coverage
    got, want = pb_frames(got_path), pb_frames(want_path)
    assert [p for p, _ in got] == [p for p, _ in want]
    repaired = 0
    for (_, a), (_, b) in zip(got, want):
        if a == b:
            continue
        da, db = proto.SegmentationDesc(), proto.SegmentationDesc()
        da.ParseFromString(a)
        db.ParseFromString(b)
        assert desc_coverage(db)[0].max() > 1
        cover, area = desc_coverage(da)
        assert (cover == 1).all()
        assert area == da.frame_width * da.frame_height
        for d in (da, db):
            d.ClearField("vector_mesh")
            for r in d.region:
                r.ClearField("vectorization")
        assert da.SerializeToString() == db.SerializeToString()
        repaired += 1
    return repaired


def write_clip(path, n_frames, seed=7, w=32, h=24):
    """A smooth textured background with a bright block moving 2 px a
    frame (TV-L1 on white noise amplifies float differences past any
    tolerance without telling anything)."""
    import cv2
    import scipy.ndimage as ndi
    rng = np.random.default_rng(seed)
    base = ndi.gaussian_filter(rng.random((h, w, 3)), (2.0, 2.0, 0))
    base = (40 + 80 * (base - base.min()) / (base.max() - base.min()))
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (w, h))
    for f in range(n_frames):
        img = base.copy()
        img[6:18, 4 + 2 * f:12 + 2 * f] = (220, 180, 90)
        vw.write(img.astype(np.uint8))
    vw.release()
    return path


@pytest.fixture(scope="module")
def tiny_video(tmp_path_factory):
    return write_clip(str(tmp_path_factory.mktemp("vid") / "tiny.avi"), 6)


@pytest.fixture(scope="module")
def long_video(tmp_path_factory):
    return write_clip(str(tmp_path_factory.mktemp("vid") / "long.avi"), 12,
                      seed=9)


def stage(tmp_path, name, video, flow_cache=None):
    """A private copy of `video` (and of a `.flow` cache beside it), so
    that each run writes its `.pb` and `.flow` next to its own input."""
    d = tmp_path / name
    d.mkdir()
    dst = str(d / os.path.basename(video))
    shutil.copy(video, dst)
    if flow_cache is not None:
        shutil.copy(flow_cache, dst + ".flow")
    return dst


def pin_preseg(monkeypatch, mode):
    """Both packages' DenseSegmentation receive preseg_mode=`mode`."""
    from video_segment_tpu.core import dense as jdense
    for mod in (jdense, tdense):
        class Pinned(mod.DenseSegmentation):
            def __init__(self, options, *args, **kw):
                super().__init__(
                    dataclasses.replace(options, preseg_mode=mode),
                    *args, **kw)
        monkeypatch.setattr(mod, "DenseSegmentation", Pinned)


def pb_frames(path):
    """(pts, payload bytes) of every frame of a .pb container."""
    r = seg_io.SegmentationReader(path)
    assert r.open_and_read_headers()
    frames = list(zip(r.frame_pts, r))
    r.close()
    assert len(frames) == r.num_frames > 0
    return frames


def run_jax(video, *flags):
    from video_segment_tpu.tools import seg_tree as jseg_tree
    assert jseg_tree.main(["--input_file", video, *COMMON, *flags]) == 0
    return video + ".pb"


def run_port(video, *flags):
    assert seg_tree.main(["--input_file", video, "--device", "cpu", *COMMON,
                          *flags]) == 0
    return video + ".pb"


# -- the port's counterparts of tests/test_tools.py ------------------------


@pytest.fixture(scope="module")
def seg_pb(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tools") / "seg.pb")
    opts = DenseSegmentationOptions(chunk_size=5, presmoothing="gaussian",
                                    frac_min_region_size=0.1)
    ds = tdense.DenseSegmentation(opts, 32, 24, device="cpu")
    w = seg_io.SegmentationWriter(path)
    w.open_file([0, 1])
    results = []
    for f in range(8):
        img = np.full((24, 32, 3), 60, np.uint8)
        img[6:18, 4 + f:16 + f] = 200
        results += ds.process_frame(False, img)
    results += ds.process_frame(True)
    for sf in results:
        w.add_to_chunk(emit.segframe_to_bytes(sf), pts=sf.frame_index * 100)
    w.write_term_and_close()
    return path


def test_converter_color_bitmaps(seg_pb, tmp_path):
    out = str(tmp_path / "conv")
    assert converter.main([f"--input={seg_pb}", f"--output_dir={out}",
                           "--mode=bitmap_color"]) == 0
    assert len([f for f in os.listdir(out) if f.endswith(".png")]) == 8


def test_converter_id_bitmaps_roundtrip(seg_pb, tmp_path):
    import cv2
    from video_segment_tpu_torch.segment_util import util
    out = str(tmp_path / "ids")
    assert converter.main([f"--input={seg_pb}", f"--output_dir={out}",
                           "--mode=bitmap_ids"]) == 0
    img = cv2.imread(os.path.join(out, "frame0000.png"))
    ids = (img[..., 0].astype(np.int64)
           | img[..., 1].astype(np.int64) << 8
           | img[..., 2].astype(np.int64) << 16)
    r = seg_io.SegmentationReader(seg_pb)
    r.open_and_read_headers()
    d = proto.SegmentationDesc()
    d.ParseFromString(r.read_frame())
    np.testing.assert_array_equal(ids, util.desc_to_id_image(d))


def test_converter_strip(seg_pb, tmp_path):
    out = str(tmp_path / "strip.pb")
    assert converter.main([f"--input={seg_pb}", "--mode=strip",
                           f"--strip_output={out}",
                           f"--output_dir={tmp_path}"]) == 0
    r = seg_io.SegmentationReader(out)
    assert r.open_and_read_headers()
    assert r.num_frames == 8
    d = proto.SegmentationDesc()
    d.ParseFromString(r.read_frame())
    assert not d.region[0].HasField("shape_moments")


def test_renderer_video(seg_pb, tmp_path):
    out = str(tmp_path / "render.mp4")
    assert renderer.main([f"--input={seg_pb}", f"--output_video={out}",
                          "--render_level=0.5"]) == 0
    assert os.path.getsize(out) > 0


def test_viewer_contact_sheet(seg_pb, tmp_path):
    out = str(tmp_path / "sheet.png")
    assert viewer.main([f"--input={seg_pb}", f"--dump={out}"]) == 0
    assert os.path.exists(out)


def test_seg_tree_cli_flow_both(tiny_video, tmp_path):
    """--flow_type both computes and caches both directions through the
    micro-batched flow stage, and the .pb stream verifies."""
    video = stage(tmp_path, "both", tiny_video)
    out = str(tmp_path / "tiny.pb")
    assert seg_tree.main([
        "--input_file", video, "--flow", "--flow_type", "both",
        "--save_flow", "--over_segment", "--output_file", out,
        "--device", "cpu", *COMMON]) == 0
    r = seg_io.SegmentationReader(out)
    assert r.open_and_read_headers()
    assert len(r.frame_offsets) == 6
    cache = tflow.FlowCacheReader(video + ".flow")
    assert cache.flow_type == tflow.FLOW_BOTH
    n = 0
    while cache.read() is not None:
        n += 1
    cache.close()
    assert n == 2 * 5  # forward + backward for frames 1..5


@pytest.mark.parametrize("mode", [["--fused"], ["--concurrent", "2"], []],
                         ids=["fused", "concurrent", "sequential"])
def test_batch_segment(tiny_video, tmp_path, mode):
    """Two clips through every mode of batch_segment; each emits an
    independently readable .pb stream."""
    outd = str(tmp_path / "out")
    assert batch_segment.main([tiny_video, tiny_video, *mode, "--no-flow",
                               "--output_dir", outd, "--device", "cpu"]) == 0
    pbs = sorted(os.listdir(outd))
    assert len(pbs) == 2
    for pb in pbs:
        r = seg_io.SegmentationReader(os.path.join(outd, pb))
        assert r.open_and_read_headers()
        assert len(r.frame_offsets) == 6
        r.close()


@pytest.mark.parametrize("pipeline", ["--use_pipeline", "--no-use_pipeline"])
def test_video_example(tiny_video, tmp_path, pipeline):
    out = str(tmp_path / "example.mp4")
    assert video_example.main(["--input_file", tiny_video, "--output_file",
                               out, pipeline, "--device", "cpu"]) == 0
    assert os.path.getsize(out) > 0


# -- offline tools against the JAX package's -------------------------------


@pytest.fixture(scope="module")
def port_pb(long_video, tmp_path_factory):
    """A hierarchical .pb written by the port's seg_tree, rasters kept."""
    d = tmp_path_factory.mktemp("portpb")
    video = str(d / "long.avi")
    shutil.copy(long_video, video)
    return run_port(video, "--no-flow", "--keep_rasterization")


def decode_video(path):
    import cv2
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, fr = cap.read()
        if not ok:
            break
        frames.append(fr)
    cap.release()
    return frames


@pytest.mark.parametrize("tool", ["bitmap_ids", "bitmap_color", "strip",
                                  "viewer", "renderer"])
def test_offline_tools_match_jax(port_pb, tmp_path, tool):
    """PNGs pixel for pixel, the stripped .pb byte for byte, rendered
    videos frame for frame after decoding."""
    import cv2
    from video_segment_tpu.tools import converter as jconverter
    from video_segment_tpu.tools import renderer as jrenderer
    from video_segment_tpu.tools import viewer as jviewer
    outs = {}
    for name, conv, rend, view in (("jax", jconverter, jrenderer, jviewer),
                                   ("port", converter, renderer, viewer)):
        d = tmp_path / name
        d.mkdir()
        if tool in ("bitmap_ids", "bitmap_color"):
            assert conv.main([f"--input={port_pb}", f"--output_dir={d}",
                              f"--mode={tool}", "--level=0.5"]) == 0
            outs[name] = [cv2.imread(str(d / f), cv2.IMREAD_UNCHANGED)
                          for f in sorted(os.listdir(d))]
            assert len(outs[name]) == 12
        elif tool == "strip":
            assert conv.main([f"--input={port_pb}", "--mode=strip",
                              f"--strip_output={d / 's.pb'}",
                              f"--output_dir={d}"]) == 0
            outs[name] = read_bytes(d / "s.pb")
        elif tool == "viewer":
            assert view.main([f"--input={port_pb}",
                              f"--dump={d / 'sheet.png'}"]) == 0
            outs[name] = [cv2.imread(str(d / "sheet.png"),
                                     cv2.IMREAD_UNCHANGED)]
        else:
            assert rend.main([f"--input={port_pb}",
                              f"--output_video={d / 'r.mp4'}",
                              "--render_level=0.4"]) == 0
            outs[name] = decode_video(str(d / "r.mp4"))
            assert len(outs[name]) == 12
    if tool == "strip":
        assert outs["port"] == outs["jax"] and len(outs["port"]) > 0
    else:
        for a, b in zip(outs["port"], outs["jax"], strict=True):
            np.testing.assert_array_equal(a, b)


# -- seg_tree against the JAX seg_tree ------------------------------------

FLAG_SETS = {
    "over_segment": ["--no-flow", "--over_segment"],
    "hierarchy": ["--no-flow"],
    "keep_rasterization": ["--no-flow", "--keep_rasterization"],
    "downscale": ["--no-flow", "--downscale_min_size", "16"],
    "no_pipeline": ["--no-flow", "--no-use_pipeline"],
    "flow_cached": ["--flow"],
}


@pytest.mark.parametrize("preseg", ["felz", "flood"])
@pytest.mark.parametrize("flags", list(FLAG_SETS), ids=list(FLAG_SETS))
def test_seg_tree_matches_jax(long_video, tmp_path, monkeypatch, flags,
                              preseg):
    """Same file, same flags: the .pb equal byte for byte but for the
    polygons the port repairs (`assert_pb_matches_jax`).  With flow the
    JAX run goes first with --save_flow and the port reads a copy of its
    `.flow` cache."""
    pin_preseg(monkeypatch, preseg)
    argv = FLAG_SETS[flags]
    jvideo = stage(tmp_path, "jax", long_video)
    cache = None
    if flags == "flow_cached":
        want = run_jax(jvideo, *argv, "--save_flow")
        cache = jvideo + ".flow"
    else:
        want = run_jax(jvideo, *argv)
    got = run_port(stage(tmp_path, "port", long_video, cache), *argv)
    assert_pb_matches_jax(got, want)
    r = seg_io.SegmentationReader(jvideo + ".pb")
    assert r.open_and_read_headers() and r.num_frames == 12
    r.close()


def test_seg_tree_computed_flow(long_video, tmp_path, monkeypatch):
    """Flow computed by the port's CLI (micro-batched TV-L1 on the CPU):
    the cache it writes is within the TV-L1 tolerance of the JAX CLI's,
    and a second run that reads it equals JAX's run on that cache (but for
    the polygons the port repairs)."""
    from video_segment_tpu.core import flow as jflow
    pin_preseg(monkeypatch, "felz")
    pvideo = stage(tmp_path, "port", long_video)
    run_port(pvideo, "--flow", "--save_flow")
    jvideo = stage(tmp_path, "jax", long_video)
    run_jax(jvideo, "--flow", "--save_flow")
    got, want = (tflow.FlowCacheReader(pvideo + ".flow"),
                 jflow.FlowCacheReader(jvideo + ".flow"))
    assert (got.width, got.height, got.flow_type) == \
        (want.width, want.height, want.flow_type) == (32, 24,
                                                      tflow.FLOW_BACKWARD)
    n = 0
    while True:
        a, b = got.read(), want.read()
        if a is None or b is None:
            assert a is None and b is None
            break
        assert np.abs(a - b).max() <= FLOW_TOL
        n += 1
    got.close()
    want.close()
    assert n == 11
    again = run_port(stage(tmp_path, "port2", long_video, pvideo + ".flow"),
                     "--flow")
    jagain = run_jax(stage(tmp_path, "jax2", long_video, pvideo + ".flow"),
                     "--flow")
    assert_pb_matches_jax(again, jagain)


# -- kill and resume through the CLI ---------------------------------------


@pytest.mark.parametrize("case", ["noflow", "flowcache", "oversegment"])
def test_seg_tree_kill_and_resume(long_video, tmp_path, case):
    """Stopped after a chunk boundary, then --resume: the appended .pb
    equals the straight run's byte for byte (with flow, both runs read the
    same `.flow` cache, whose fields are exact float32).  The hierarchical
    runs are cut before their first chunk set is written (the writer
    resumes behind the header).  The over-segmentation run is cut behind
    written chunks; its resumed container holds the straight run's frames
    and pts but groups them into other container chunks, as the JAX CLI's
    does (the writer closes a container chunk at every checkpoint and at
    every hierarchy frame after the first of a run, and a resumed run
    counts its frames from zero)."""
    cache = None
    flow_flags = ["--no-flow"]
    if case == "flowcache":
        cvideo = stage(tmp_path, "cache", long_video)
        run_port(cvideo, "--flow", "--save_flow", "--over_segment")
        cache = cvideo + ".flow"
        flow_flags = ["--flow"]
    elif case == "oversegment":
        flow_flags.append("--over_segment")
    flags = ["--no-use_pipeline", "--checkpoint_every", "1", *flow_flags]
    svideo = stage(tmp_path, "straight", long_video, cache)
    want = read_bytes(run_port(
        svideo, *flags, "--checkpoint_path", str(tmp_path / "s.ckpt")))
    kvideo = stage(tmp_path, "killed", long_video, cache)
    ckpt = str(tmp_path / "k.ckpt")
    run_port(kvideo, *flags, "--checkpoint_path", ckpt, "--trim_to", "9")
    from video_segment_tpu_torch.runtime import checkpoint
    extra = checkpoint.load_extra(ckpt)
    assert 0 < extra["writer_offset"] < os.path.getsize(kvideo + ".pb")
    assert (extra["writer_chunks"] > 0) == (case == "oversegment")
    got = read_bytes(run_port(kvideo, *flags, "--checkpoint_path", ckpt,
                              "--resume"))
    if case == "oversegment":
        assert pb_frames(kvideo + ".pb") == pb_frames(svideo + ".pb")
    else:
        assert got == want


def test_seg_tree_resume_with_flow_needs_cache(long_video, tmp_path):
    video = stage(tmp_path, "nocache", long_video)
    with pytest.raises(SystemExit, match="--resume with flow requires a "
                                         "<input>.flow cache"):
        seg_tree.main(["--input_file", video, "--device", "cpu", "--flow",
                       "--resume", "--checkpoint_path",
                       str(tmp_path / "none.ckpt")])


# -- overrides -------------------------------------------------------------


@dataclasses.dataclass
class Knobs:
    flag: bool = False
    tri: bool | None = None
    count: int = 3
    scale: float = 0.5
    sched: tuple = (1, 2)
    name: str = "a"


def set_knob(o, n, v):
    return dataclasses.replace(o, **{n: v})


@pytest.mark.parametrize("pair,field,want", [
    ("flag=true", "flag", True), ("flag=0", "flag", False),
    ("tri=auto", "tri", None), ("tri=1", "tri", True),
    ("count=7", "count", 7), ("count=24,2,2", "count", (24, 2, 2)),
    ("scale=1.25", "scale", 1.25), ("sched=4,5,6", "sched", (4, 5, 6)),
    ("name=b", "name", "b")])
def test_apply_overrides(pair, field, want):
    got = seg_tree._apply_overrides(Knobs(), [pair], "--x", set_knob)
    assert getattr(got, field) == want
    assert type(getattr(got, field)) is type(want)


def test_apply_overrides_unknown_field_exits():
    with pytest.raises(SystemExit, match="--x: unknown field 'nope'"):
        seg_tree._apply_overrides(Knobs(), ["nope=1"], "--x", set_knob)


def test_override_flags_reach_the_stages():
    p = seg_tree._solver_params_from_flags(
        ["preseg_fin_margin=1.5", "st_levels=3", "extract_tile=none"])
    assert (p.preseg_fin_margin, p.st_levels, p.extract_tile) == (1.5, 3,
                                                                  None)
    assert seg_tree._solver_params_from_flags([]) is None
    r = seg_tree._region_options_from_flags(["agglo_subrounds=12"])
    assert r.agglo_subrounds == 12


def test_seg_tree_rounds_per_level_tuple_matches_jax(long_video, tmp_path,
                                                     monkeypatch):
    """--solver_param preseg_rounds_per_level=24,2,2 through the dense
    stage (K1 takes the per-level counts) against JAX with the same flag."""
    pin_preseg(monkeypatch, "felz")
    flags = ["--no-flow", "--over_segment", "--solver_param",
             "preseg_rounds_per_level=24,2,2"]
    want = read_bytes(run_jax(stage(tmp_path, "jax", long_video), *flags))
    got = read_bytes(run_port(stage(tmp_path, "port", long_video), *flags))
    assert got == want


@pytest.mark.parametrize("flag,value,message", [
    ("--solver_param", "descriptor=color_mean_variance", "descriptor"),
    ("--solver_param", "gradient_trait=1", "gradient_trait"),
    ("--solver_param", "edge_table=0", "v1 pixel solver"),
    ("--region_param", "save_descriptors=1", "save_descriptors"),
    ("--region_param", "appearance_window_size=4", "windowed appearance")])
def test_seg_tree_refused_knob_raises(tiny_video, tmp_path, monkeypatch,
                                      flag, value, message):
    """The off-default solver and region knobs through the CLI flags,
    the v1 pixel solver (edge_table=0) among them: every one runs, and the
    port's .pb equals the JAX seg_tree's byte for byte but for the polygons
    the port repairs (`assert_pb_matches_jax`; felz pinned, and
    cv2's Lab in the port's region stage, ROADMAP.md Queue 3, F6); with
    save_descriptors every region of a hierarchy frame carries a
    RegionFeatures record."""
    from video_segment_tpu_torch.core import region as tregion
    import cv2
    pin_preseg(monkeypatch, "felz")
    monkeypatch.setattr(tregion, "bgr_to_lab_u8",
                        lambda im: cv2.cvtColor(im, cv2.COLOR_BGR2Lab))
    flags = ["--no-flow", flag, value]
    want = run_jax(stage(tmp_path, "jax", tiny_video), *flags)
    path = run_port(stage(tmp_path, "port", tiny_video), *flags)
    assert_pb_matches_jax(path, want)
    if value == "save_descriptors=1":
        n_hier = 0
        for _, payload in pb_frames(path):
            desc = proto.SegmentationDesc()
            desc.ParseFromString(payload)
            if len(desc.hierarchy):
                n_hier += 1
                assert len(desc.features) == len(desc.region) > 0
                assert [f.id for f in desc.features] == \
                    [r.id for r in desc.region]
        assert n_hier > 0


# -- --device --------------------------------------------------------------


@pytest.mark.parametrize("tool", ["seg_tree", "video_example",
                                  "batch_segment"])
def test_device_cuda_without_a_card_fails_early(tiny_video, tmp_path, tool):
    """Every CLI that builds a device stage defaults to cuda and stops with
    device.resolve's error before it opens an output."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    video = stage(tmp_path, "nocard", tiny_video)
    outd = tmp_path / "out"
    argv = {"seg_tree": ["--input_file", video, "--write_to_file"],
            "video_example": ["--input_file", video, "--output_file",
                              str(tmp_path / "e.mp4")],
            "batch_segment": [video, "--output_dir", str(outd)]}[tool]
    mod = {"seg_tree": seg_tree, "video_example": video_example,
           "batch_segment": batch_segment}[tool]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        mod.main(argv)
    assert sorted(os.listdir(tmp_path / "nocard")) == ["tiny.avi"]
    assert not outd.exists() and not (tmp_path / "e.mp4").exists()


def test_seg_tree_profile_writes_a_trace(tiny_video, tmp_path, monkeypatch):
    import json
    prof = tmp_path / "prof"
    monkeypatch.setenv("VST_PROFILE", str(prof))
    video = stage(tmp_path, "prof_in", tiny_video)
    assert seg_tree.main(["--input_file", video, "--device", "cpu",
                          "--no-flow", "--over_segment",
                          "--no-use_pipeline"]) == 0
    with open(prof / "seg_tree_trace.json") as f:
        trace = json.load(f)
    assert len(trace["traceEvents"]) > 0


# -- launch counters -------------------------------------------------------


def test_count_launch_is_exact_across_threads():
    """The kernels' launch counters are incremented from the pipeline's
    stage threads: no update may be lost."""
    def wrapper():
        pass
    wrapper.launches = 0
    n_threads, n_each = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [_build.count_launch(wrapper)
                            for _ in range(n_each)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == n_threads * n_each
