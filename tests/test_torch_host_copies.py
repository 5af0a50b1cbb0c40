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
