"""The port's own copies of the JAX package's host modules equal them.

On seeded numpy inputs: option classes (fields, defaults,
`options_from_jax`), `ops/rle`, `core/connectedness` (with and without
flow), the native g++ helpers, the committed protobuf descriptor (field
for field against the schema protoc compiles from the JAX `.proto`), and
the bytes of `dataio/emit.segframe_to_bytes` for a frame with a
hierarchy, with and without vectorization.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from video_segment_tpu import native as jnative
from video_segment_tpu.core import connectedness as jconn
from video_segment_tpu.core import options as jopts
from video_segment_tpu.ops import rle as jrle
from video_segment_tpu_torch import native as tnative
from video_segment_tpu_torch.core import connectedness as tconn
from video_segment_tpu_torch.core import options as topts
from video_segment_tpu_torch.core.dense import HierarchyLevelData, SegFrame
from video_segment_tpu_torch.dataio import emit as temit
from video_segment_tpu_torch.ops import rle as trle

torch.set_num_threads(2)

OPTION_CLASSES = ("DenseSegmentationOptions", "RegionSegmentationOptions")


def _blocky_labels(rng, shape, block=4, n=40):
    """(T,H,W) int32 labels: random ids over block x block cells, so
    regions have runs, islands and neighbours."""
    t, h, w = shape
    small = rng.integers(0, n, (t, -(-h // block), -(-w // block)))
    lab = np.repeat(np.repeat(small, block, 1), block, 2)[:, :h, :w]
    return np.ascontiguousarray(lab, np.int32)


def _compact(lab):
    return trle.compact_labels(lab)[0]


@pytest.mark.parametrize("name", OPTION_CLASSES)
def test_option_fields_and_defaults_match(name):
    jcls, tcls = getattr(jopts, name), getattr(topts, name)
    assert ([(f.name, f.type) for f in dataclasses.fields(tcls)]
            == [(f.name, f.type) for f in dataclasses.fields(jcls)])
    assert dataclasses.asdict(tcls()) == dataclasses.asdict(jcls())
    if name == "DenseSegmentationOptions":
        for o in (tcls(chunk_size=7), jcls(chunk_size=7)):
            assert o.overlap_frames() == 2
            assert o.constraint_frames() == 1
        assert (tcls(chunk_size=7).min_region_size(480, 272)
                == jcls(chunk_size=7).min_region_size(480, 272))


@pytest.mark.parametrize("name", OPTION_CLASSES)
def test_options_from_jax(name):
    jcls, tcls = getattr(jopts, name), getattr(topts, name)
    fields = dataclasses.fields(jcls)
    # Change every field away from its default.
    changed = {}
    for f in fields:
        v = getattr(jcls(), f.name)
        changed[f.name] = (not v if isinstance(v, bool)
                           else v + 1 if isinstance(v, (int, float))
                           else "l1" if v == "l2" else v + "_x")
    got = topts.options_from_jax(jcls(**changed))
    assert type(got) is tcls
    assert dataclasses.asdict(got) == changed
    with pytest.raises(TypeError):
        topts.options_from_jax(object())


@pytest.mark.parametrize("seed", [0, 1])
def test_rle_matches_jax(seed):
    rng = np.random.default_rng(seed)
    lab = _blocky_labels(rng, (3, 19, 37))
    for f in range(3):
        for a, b in zip(trle.frame_rle(lab[f]), jrle.frame_rle(lab[f])):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            trle.enforce_n4_connectivity(lab[f]),
            jrle.enforce_n4_connectivity(lab[f]))
    comp = _compact(lab)
    for a, b in zip(trle.compact_labels(lab), jrle.compact_labels(lab)):
        np.testing.assert_array_equal(a, b)
    n = int(comp.max()) + 1
    for a, b in zip(trle.region_presence(comp, n),
                    jrle.region_presence(comp, n)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(trle.region_sizes(comp, n),
                                  jrle.region_sizes(comp, n))
    np.testing.assert_array_equal(trle.neighbor_pairs(comp),
                                  jrle.neighbor_pairs(comp))
    ids, counts, ys, lxs, rxs = jrle.frame_rle(lab[0])
    np.testing.assert_array_equal(trle.shape_moments(counts, ys, lxs, rxs),
                                  jrle.shape_moments(counts, ys, lxs, rxs))


@pytest.mark.parametrize("with_flow", [False, True], ids=["noflow", "flow"])
def test_spatial_connectedness_matches_jax(with_flow):
    rng = np.random.default_rng(3)
    lab = _compact(_blocky_labels(rng, (4, 32, 48), block=3, n=12))
    n = int(lab.max()) + 1
    flow = (rng.normal(0, 2, (3, 32, 48, 2)).astype(np.float32)
            if with_flow else None)
    got = tconn.enforce_spatial_connectedness(lab, n, flow=flow)
    want = jconn.enforce_spatial_connectedness(lab, n, flow=flow)
    assert got[1] == want[1] and got[1] > n   # islands were split
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])


def test_native_builds_from_the_port_source():
    assert tnative.available()
    path = tnative._build()
    assert os.path.dirname(path) == os.path.join(
        os.path.dirname(os.path.dirname(tnative.__file__)), "_build")
    assert os.path.basename(path).startswith("vst_native-")


def test_native_accumulate_lab_hist_matches_jax():
    rng = np.random.default_rng(4)
    labels = rng.integers(0, 50, (3, 20, 30)).astype(np.int32)
    lab_u8 = rng.integers(0, 256, (3, 20, 30, 3)).astype(np.uint8)
    gains = rng.uniform(0.8, 1.2, (3, 3)).astype(np.float32)
    win = np.array([0, 1, 1], np.int32)
    for kw in (dict(), dict(gains=gains, win_slot=win, wcap=2)):
        got = tnative.accumulate_lab_hist(labels, lab_u8, 64, 10, 20,
                                          n_threads=3, **kw)
        want = jnative.accumulate_lab_hist(labels, lab_u8, 64, 10, 20,
                                           n_threads=3, **kw)
        np.testing.assert_array_equal(got, want)


def test_native_weighted_bincount_and_neighbor_pairs_match_jax():
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 300, 5000)
    w = rng.random(5000).astype(np.float32)
    np.testing.assert_array_equal(tnative.weighted_bincount(keys, w, 300, 1),
                                  jnative.weighted_bincount(keys, w, 300, 1))
    lab = _blocky_labels(rng, (3, 25, 41), block=2, n=90)
    np.testing.assert_array_equal(tnative.neighbor_pairs(lab),
                                  jnative.neighbor_pairs(lab))
    for a, b in zip(tnative.multi_label_cc(lab[0]),
                    jnative.multi_label_cc(lab[0])):
        np.testing.assert_array_equal(a, b)


def test_descriptor_matches_compiled_proto():
    from google.protobuf import descriptor_pb2

    # Imported here: the JAX package compiles its schema with protoc at
    # import, and the card tests run where there is none.
    from video_segment_tpu import proto as jproto
    from video_segment_tpu_torch import proto as tproto
    from video_segment_tpu_torch.proto._descriptor import DESCRIPTOR_SET

    want = descriptor_pb2.FileDescriptorProto()
    jproto.SegmentationDesc.DESCRIPTOR.file.CopyToProto(want)
    got = descriptor_pb2.FileDescriptorSet()
    got.ParseFromString(DESCRIPTOR_SET)
    assert len(got.file) == 1
    got_file = got.file[0]
    # CopyToProto leaves out json_name; compare the schema field for field.
    for fd in (got_file, want):
        for msg in fd.message_type:
            stack = [msg]
            while stack:
                m = stack.pop()
                for f in m.field:
                    f.ClearField("json_name")
                stack.extend(m.nested_type)
    assert got_file == want
    for name in ("SegmentationDesc", "RegionFeatures"):
        t = getattr(tproto, name).DESCRIPTOR
        j = getattr(jproto, name).DESCRIPTOR
        assert [(f.name, f.number, f.type) for f in t.fields] == \
            [(f.name, f.number, f.type) for f in j.fields]
    # The .proto copy is the JAX package's, line for line, comments aside.
    here = os.path.dirname(os.path.abspath(__file__))
    jsrc = _schema_lines(os.path.join(here, "..", "video_segment_tpu",
                                      "proto", "segmentation.proto"))
    assert len(jsrc) > 50
    assert _schema_lines(os.path.join(os.path.dirname(tproto.__file__),
                                      "segmentation.proto")) == jsrc


def _schema_lines(path):
    """The non-blank lines of a .proto file with `//` comments removed."""
    with open(path) as f:
        lines = (line.split("//", 1)[0].rstrip() for line in f)
        return [line for line in lines if line]


def _segframe(seed):
    """A SegFrame with RLE, moments and a two-level hierarchy."""
    rng = np.random.default_rng(seed)
    lab = _blocky_labels(rng, (1, 24, 40), block=4, n=9)[0].astype(np.int64)
    lab = lab * 3 + 100
    ids, counts, ys, lxs, rxs = trle.frame_rle(lab)
    pairs = trle.neighbor_pairs(lab[None].astype(np.int32)).astype(np.int64)
    r = len(ids)
    parents = 1000 + ids % 3
    lvl0 = HierarchyLevelData(
        ids=ids.astype(np.int64), sizes=counts.astype(np.int64) * 5,
        start_frames=np.zeros(r, np.int64), end_frames=np.full(r, 3),
        neighbor_pairs=pairs, parent_ids=parents.astype(np.int64))
    top = np.unique(parents).astype(np.int64)
    lvl1 = HierarchyLevelData(
        ids=top, sizes=np.full(len(top), 40, np.int64),
        start_frames=np.zeros(len(top), np.int64),
        end_frames=np.full(len(top), 3),
        neighbor_pairs=np.array([[top[0], top[-1]]], np.int64),
        child_pairs=np.stack([parents, ids], 1).astype(np.int64))
    return SegFrame(frame_width=40, frame_height=24, region_ids=ids,
                    interval_counts=counts, ys=ys, lxs=lxs, rxs=rxs,
                    chunk_size=4, overlap_start=4, chunk_id=2,
                    hierarchy_frame_idx=8, hierarchy=[lvl0, lvl1],
                    frame_index=8,
                    moments=trle.shape_moments(counts, ys, lxs, rxs))


@pytest.mark.parametrize("vectorize", [False, True],
                         ids=["raster", "vectorized"])
def test_segframe_bytes_match_jax(vectorize):
    from video_segment_tpu import proto as jproto
    from video_segment_tpu.dataio import emit as jemit
    sf = _segframe(6)
    got = temit.segframe_to_bytes(sf, vectorize=vectorize,
                                  save_descriptors=True)
    want = jemit.segframe_to_bytes(sf, vectorize=vectorize,
                                   save_descriptors=True)
    assert got == want
    desc = jproto.SegmentationDesc()
    desc.ParseFromString(got)
    assert len(desc.hierarchy) == 2 and len(desc.region) == len(sf.region_ids)
    assert bool(desc.vector_mesh.coord) == vectorize


# ---------------------------------------------------------------------------
# runtime/pipeline, runtime/conversion, segment_util/{render,metrics}, the
# flow helpers and runtime/checkpoint.

from video_segment_tpu.runtime import checkpoint as jckpt
from video_segment_tpu.runtime import conversion as jconv
from video_segment_tpu.runtime import pipeline as jpl
from video_segment_tpu.segment_util import render as jrender
from video_segment_tpu_torch.runtime import checkpoint as tckpt
from video_segment_tpu_torch.runtime import conversion as tconv
from video_segment_tpu_torch.runtime import pipeline as tpl
from video_segment_tpu_torch.segment_util import render as trender

PIPELINES = pytest.mark.parametrize("pl", [tpl, jpl], ids=["port", "jax"])


def _code_lines(path):
    """Source lines without the package imports (the only allowed edit)."""
    with open(path) as f:
        return [ln for ln in f.read().splitlines()
                if "video_segment_tpu" not in ln]


@pytest.mark.parametrize("rel", ["runtime/pipeline.py",
                                 "runtime/conversion.py",
                                 "segment_util/render.py",
                                 "segment_util/metrics.py"])
def test_host_module_is_a_copy(rel):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert _code_lines(os.path.join(root, "video_segment_tpu_torch", rel)) \
        == _code_lines(os.path.join(root, "video_segment_tpu", rel))


@PIPELINES
def test_pipeline_order_and_flush(pl):
    buffered = []

    def buffer3(x):
        buffered.append(x)
        if len(buffered) == 3:
            out, buffered[:] = list(buffered), []
            return out
        return []

    p = pl.Pipeline([pl.Stage("double", lambda x: [x * 2]),
                     pl.Stage("buf", buffer3, flush=lambda: list(buffered))],
                    queue_size=2)
    assert list(p.run(range(7))) == [0, 2, 4, 6, 8, 10, 12]
    assert p.stages[0].stats.processed == 7


@PIPELINES
@pytest.mark.parametrize("where", ["stage", "midchain", "source"])
def test_pipeline_error_propagates(pl, where):
    """A raising stage or source re-raises from run() promptly and leaves
    no thread wedged on a full queue."""
    import time

    def boom(x):
        if x >= 3:
            raise ValueError("boom")
        return [x]

    def bad_source():
        yield 1
        raise ValueError("boom")

    stages = [pl.Stage("boom", boom)]
    if where == "midchain":
        stages.insert(0, pl.Stage("fast", lambda x: [x]))
    p = pl.Pipeline(stages, queue_size=2)
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="boom"):
        list(p.run(bad_source() if where == "source" else range(10_000)))
    assert time.monotonic() - t0 < 5.0
    for t in p._threads:
        t.join(timeout=2.0)
        assert not t.is_alive()


@PIPELINES
def test_rate_policy_max_rate_caps_source(pl):
    import time
    p = pl.Pipeline([pl.Stage("id", lambda x: [x])],
                    rate_policy=pl.RatePolicy(max_rate=50.0))
    t0 = time.monotonic()
    assert list(p.run(range(10))) == list(range(10))
    assert time.monotonic() - t0 >= 9 / 50.0  # 9 gaps at 50 a second


@PIPELINES
def test_rate_policy_dynamic_throttles_on_queue_depth(pl):
    import queue
    rp = pl.RatePolicy(dynamic_rate=True, dynamic_rate_scale=1.0,
                       startup_frames=0, update_interval=0.0,
                       queue_throttle_threshold=2, num_throttle_frames=1,
                       min_throttle_rate=0.25)
    p = pl.Pipeline([pl.Stage("id", lambda x: [x])], queue_size=8,
                    rate_policy=rp)
    p.queues = [queue.Queue(maxsize=8) for _ in range(2)]
    p.stages[0].stats.record(0.01)  # measured stage rate: 100/s
    for _ in range(4):  # depth 4 = threshold 2 + 2 excess -> scale 0.25
        p.queues[0].put(object())
    rate, _ = p._current_rate(fed=10, last_update=0.0)
    assert rate == pytest.approx(100.0 * 0.25, rel=1e-6)
    while not p.queues[0].empty():
        p.queues[0].get()
    rate, _ = p._current_rate(fed=10, last_update=0.0)
    assert rate == pytest.approx(100.0, rel=1e-6)


@PIPELINES
def test_unit_tree_fanout_flush_and_collect(pl):
    root = pl.Unit("src", lambda x: [x * 2])
    root.add_child(pl.Unit("a", lambda x: [("a", x)]))
    buffered = []
    mid = root.add_child(pl.Unit("buf", lambda x: buffered.append(x) or [],
                                 flush=lambda: list(buffered), collect=True))
    sink_seen = []
    mid.add_child(pl.Unit("sink", lambda x: sink_seen.append(x) or [],
                          collect=False))
    tree = pl.UnitTree(root)
    out = list(tree.run(range(5)))
    assert sorted(v for n, v in out if n == "a") == \
        [("a", 0), ("a", 2), ("a", 4), ("a", 6), ("a", 8)]
    assert sorted(v for n, v in out if n == "buf") == [0, 2, 4, 6, 8]
    assert sorted(sink_seen) == [0, 2, 4, 6, 8]  # flush outputs reach children
    assert {st.name: st.stats.processed for st in tree.stages}["a"] == 5


@PIPELINES
def test_unit_tree_seek_propagation_stops_at_false(pl):
    calls = []

    def seeker(name, ok=True):
        def s(pts):
            calls.append((name, pts))
            return ok
        return s

    root = pl.Unit("root", seek=seeker("root"))
    mid = root.add_child(pl.Unit("mid", seek=seeker("mid", False)))
    mid.add_child(pl.Unit("leaf", seek=seeker("leaf")))
    root.add_child(pl.Unit("sib", seek=seeker("sib")))
    assert root.seek(42) is True
    assert {("root", 42), ("mid", 42), ("sib", 42)} <= set(calls)
    assert all(n != "leaf" for n, _ in calls)


@PIPELINES
def test_unit_tree_branch_error_aborts_whole_tree(pl):
    import time

    def boom(x):
        if x == 2:
            raise ValueError("branch boom")
        return [x]

    root = pl.Unit("src", lambda x: [x])
    root.add_child(pl.Unit("ok", lambda x: [x]))
    root.add_child(pl.Unit("boom", boom))
    tree = pl.UnitTree(root, queue_size=2)
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="branch boom"):
        list(tree.run(range(10_000)))
    assert time.monotonic() - t0 < 5.0
    for t in tree._threads:
        t.join(timeout=2.0)
        assert not t.is_alive()


def test_conversion_units_match_jax():
    """LuminanceUnit / FlipBGRUnit / ColorTwistUnit counterparts run in a
    UnitTree and convert seeded frames exactly as the JAX package's."""
    rng = np.random.default_rng(8)
    frames = [rng.integers(0, 256, (4, 6, 3)).astype(np.uint8)
              for _ in range(3)]
    got = {}
    for conv, pl in ((tconv, tpl), (jconv, jpl)):
        root = pl.Unit("src")
        flip = root.add_child(conv.flip_bgr_unit())
        flip.add_child(conv.luminance_unit())
        root.add_child(conv.color_twist_unit(scale=(2, 1, 0.5),
                                             offset=(0, 10, 0)))
        res = {"luminance": [], "color_twist": []}
        for name, item in pl.UnitTree(root).run(iter(frames)):
            res[name].append(item)
        got[conv] = res
    assert isinstance(tconv.luminance_unit(), tpl.Unit)
    for name in ("luminance", "color_twist"):
        assert len(got[tconv][name]) == 3
        for a, b in zip(got[tconv][name], got[jconv][name]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    b, g, r = (int(v) for v in frames[0][0, 0])
    assert abs(float(got[tconv]["luminance"][0][0, 0])
               - (0.114 * r + 0.587 * g + 0.299 * b) / 255.0) < 1e-6
    assert tuple(got[tconv]["color_twist"][0][0, 0]) == \
        (min(2 * b, 255), g + 10 if g + 10 < 256 else 255, int(0.5 * r))


def test_render_matches_jax():
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 1 << 40, 500)
    np.testing.assert_array_equal(trender.pseudo_random_colors(ids),
                                  jrender.pseudo_random_colors(ids))
    lab = _blocky_labels(rng, (1, 16, 24))[0]
    for hb in (False, True):
        np.testing.assert_array_equal(trender.render_label_image(lab, hb),
                                      jrender.render_label_image(lab, hb))
    sf = _segframe(3)
    img = trender.render_segframe(sf)
    np.testing.assert_array_equal(img, jrender.render_segframe(sf))
    assert img.shape == (sf.frame_height, sf.frame_width, 3)
    assert img.dtype == np.uint8


def test_metrics_match_jax():
    pytest.importorskip("cv2")
    from video_segment_tpu.segment_util import metrics as jmetrics
    from video_segment_tpu_torch.segment_util import metrics as tmetrics
    rng = np.random.default_rng(10)
    a = _blocky_labels(rng, (3, 32, 48))
    b = np.roll(a, 1, axis=2)
    assert tmetrics.boundary_f_measure(a, b) == \
        jmetrics.boundary_f_measure(a, b)
    assert tmetrics.boundary_f_measure(a[0], a[0])["f_measure"] == 1.0
    assert 0.5 < tmetrics.boundary_f_measure(a, b, 0)["f_measure"] < 1.0
    assert tmetrics.segmentation_covering(a, b) == \
        jmetrics.segmentation_covering(a, b)
    np.testing.assert_array_equal(tmetrics.boundary_map(a[0]),
                                  jmetrics.boundary_map(a[0]))


def test_flow_helpers_match_jax():
    """`flow_to_hsv_bgr`, `as_flow_host` and `FlowField.shape`."""
    pytest.importorskip("cv2")
    import jax.numpy as jnp
    from video_segment_tpu.core import flow as jflow
    from video_segment_tpu_torch.core import flow as tflow
    rng = np.random.default_rng(12)
    fl = rng.normal(0, 4, (10, 14, 2)).astype(np.float32)
    want = jflow.flow_to_hsv_bgr(fl)
    np.testing.assert_array_equal(tflow.flow_to_hsv_bgr(fl), want)
    tf = tflow.FlowField(dev=torch.from_numpy(fl))
    jf = jflow.FlowField(dev=jnp.asarray(fl))
    np.testing.assert_array_equal(tflow.flow_to_hsv_bgr(tf),
                                  jflow.flow_to_hsv_bgr(jf))
    assert tf.shape == jf.shape == (10, 14, 2)
    assert tflow.FlowField(host=fl).shape == (10, 14, 2)
    assert tflow.as_flow_host(None) is None
    for prefer in (True, False):
        np.testing.assert_array_equal(tflow.as_flow_host(tf, prefer),
                                      jflow.as_flow_host(jf, prefer))
    np.testing.assert_array_equal(tflow.as_flow_host(fl.tolist()), fl)
    batch = tflow._LazyFlowBatch(torch.from_numpy(fl[None]))
    half = tflow.as_flow_host(tflow.FlowField(dev=torch.from_numpy(fl),
                                              batch=batch))
    assert half.dtype == np.float16


# -- checkpoint ---------------------------------------------------------------

def _ckpt_video(n, h=24, w=40):
    rng = np.random.default_rng(11)
    noise = (rng.random((h, w, 3)) * 18).astype(np.uint8)
    frames = []
    for i in range(n):
        img = np.full((h, w, 3), 70, np.uint8) + noise
        img[:, : w // 3] = (180, 90, 60)
        img[5:17, (6 + i) % (w - 10):(6 + i) % (w - 10) + 8] = (40, 190, 130)
        frames.append(img)
    return frames


def _ckpt_stages(bands=0, package="port", window=0):
    dopts = dict(chunk_size=5, presmoothing="gaussian",
                 frac_min_region_size=0.08, preseg_mode="felz",
                 solver_bands=bands)
    ropts = dict(chunk_set_size=2, chunk_set_overlap=1, min_region_num=2,
                 max_region_num=40, use_flow=False,
                 appearance_window_size=window)
    if package == "jax":
        from video_segment_tpu.core import dense, region
        return (dense.DenseSegmentation(
                    jopts.DenseSegmentationOptions(**dopts), 40, 24),
                region.RegionSegmentation(
                    jopts.RegionSegmentationOptions(**ropts), 40, 24))
    from video_segment_tpu_torch.core import dense, region
    return (dense.DenseSegmentation(
                topts.DenseSegmentationOptions(**dopts), 40, 24,
                device="cpu"),
            region.RegionSegmentation(
                topts.RegionSegmentationOptions(**ropts), 40, 24,
                device="cpu"))


def _feed(ds, rs, frames, start, flush):
    out = []
    for i, fr in enumerate(frames, start=start):
        rs.add_frame(i, fr)
        out += rs.process_frames(False, ds.process_frame(False, fr))
    if flush:
        out += rs.process_frames(True, ds.process_frame(True))
    return out


def _sig(frames_out):
    sig = []
    for sf in frames_out:
        hier = None
        if sf.hierarchy is not None:
            hier = tuple((tuple(h.ids.tolist()), tuple(h.sizes.tolist()),
                          None if h.parent_ids is None
                          else tuple(np.asarray(h.parent_ids).tolist()))
                         for h in sf.hierarchy)
        sig.append((sf.frame_index, tuple(sf.region_ids.tolist()),
                    tuple(sf.ys.tolist()), tuple(sf.lxs.tolist()),
                    tuple(sf.rxs.tolist()), hier))
    return sig


@pytest.mark.parametrize("bands,window", [(0, 0), (2, 0), (0, 4)],
                         ids=["monolithic", "banded", "windowed"])
def test_kill_and_resume_matches_straight_run(tmp_path, bands, window):
    """Run half, checkpoint, build fresh stages, restore, continue: the
    output stream equals the straight run's bit for bit (RLE and
    hierarchies), also with padded, banded buffers, and with windowed
    appearance (the cut falls inside a window whose anchor and frame means
    the checkpoint carries)."""
    frames = _ckpt_video(20)
    ref_out = _feed(*_ckpt_stages(bands, window=window), frames, 0, True)
    ds1, rs1 = _ckpt_stages(bands, window=window)
    cut = 11
    out_a = _feed(ds1, rs1, frames[:cut], 0, False)
    if window:
        assert 11 // window in rs1._window_anchor and rs1._frame_means
    path = str(tmp_path / "ckpt.pkl")
    tckpt.save(path, ds1, rs1, frames_consumed=cut, extra={"pos": 7})
    del ds1, rs1
    ds2, rs2 = _ckpt_stages(bands, window=window)
    assert tckpt.restore(path, ds2, rs2) == cut
    assert tckpt.load_extra(path) == {"pos": 7}
    assert ds2._buffer[0].shape[0] == (32 if bands else 24)
    assert len(ds2._preseg_buffer) == len(ds2._buffer) > 0
    out_b = _feed(ds2, rs2, frames[cut:], cut, True)
    assert len(ref_out) == 20 and any(s[5] for s in _sig(ref_out))
    assert _sig(out_a + out_b) == _sig(ref_out)


def test_restore_rejects_geometry_mismatch_and_foreign_files(tmp_path):
    import pickle
    from video_segment_tpu_torch.core import dense
    ds, rs = _ckpt_stages()
    path = str(tmp_path / "ckpt.pkl")
    tckpt.save(path, ds, rs, frames_consumed=0)
    other = dense.DenseSegmentation(
        topts.DenseSegmentationOptions(chunk_size=5), 64, 48, device="cpu")
    with pytest.raises(ValueError, match="geometry"):
        tckpt.restore(path, other)
    # A dense-only checkpoint cannot restore a region stage.
    tckpt.save(path, ds, None)
    with pytest.raises(ValueError, match="no region-stage state"):
        tckpt.restore(path, *_ckpt_stages())
    # The region block carries the appearance-window state as the JAX
    # package's does: the stage's own anchors and frame means.
    rs.add_frame(0, _ckpt_video(1)[0])
    tckpt.save(path, ds, rs)
    with open(path, "rb") as f:
        state = pickle.load(f)
    assert state["magic"] == jckpt._MAGIC == tckpt._MAGIC
    assert state["region"]["window_anchor"] == {}
    np.testing.assert_array_equal(state["region"]["frame_means"][0],
                                  rs._frame_means[0])
    with open(path, "wb") as f:
        pickle.dump({"magic": "something else"}, f)
    with pytest.raises(ValueError, match="not a video_segment_tpu"):
        tckpt.restore(path, ds)
    with pytest.raises(ValueError, match="not a video_segment_tpu"):
        tckpt.load_extra(path)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("bands", [0, 2], ids=["monolithic", "banded"])
def test_dense_checkpoint_crosses_packages(tmp_path, direction, bands):
    """The dense block of a checkpoint written by one package restores in
    the other (same pickle layout and magic): the continued dense stream
    equals the writer's own continuation."""
    frames = _ckpt_video(16)
    cut = 8
    src_pkg, dst_pkg = (("jax", "port") if direction == "jax_to_port"
                        else ("port", "jax"))
    src, _ = _ckpt_stages(bands, src_pkg)
    dst, _ = _ckpt_stages(bands, dst_pkg)
    for fr in frames[:cut]:
        src.process_frame(False, fr)
    assert src._overlap_gids
    path = str(tmp_path / "ckpt.pkl")
    (jckpt if src_pkg == "jax" else tckpt).save(path, src,
                                                frames_consumed=cut)
    assert (jckpt if dst_pkg == "jax" else tckpt).restore(path, dst) == cut
    want, got = [], []
    for fr in frames[cut:]:
        want += src.process_frame(False, fr)
        got += dst.process_frame(False, fr)
    want += src.process_frame(True)
    got += dst.process_frame(True)
    assert len(want) >= 8
    assert [s[:5] for s in _sig(got)] == [s[:5] for s in _sig(want)]
