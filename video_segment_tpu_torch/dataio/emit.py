"""SegFrame -> serialized SegmentationDesc bytes.

Bridges the core drivers' numpy result records to the wire format: hot RLE
payload through the vectorized encoder, the (small, per-chunk) hierarchy
through regular protobuf objects.
"""

from __future__ import annotations

import contextlib

import numpy as np

from video_segment_tpu_torch import proto
from video_segment_tpu_torch.dataio import fast_proto


def _neighbor_lists(ids: np.ndarray, pairs: np.ndarray):
    """Per-region sorted neighbor id lists from unique (a,b) pairs."""
    if len(pairs) == 0:
        return {int(i): [] for i in ids}
    src = np.concatenate([pairs[:, 0], pairs[:, 1]])
    dst = np.concatenate([pairs[:, 1], pairs[:, 0]])
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    out = {int(i): [] for i in ids}
    uniq, starts = np.unique(src, return_index=True)
    bounds = np.append(starts, len(src))
    for i, s in enumerate(uniq):
        out[int(s)] = dst[bounds[i]:bounds[i + 1]].tolist()
    return out


def _child_lists(parent_ids_of_children: np.ndarray | None,
                 child_ids: np.ndarray | None):
    if parent_ids_of_children is None:
        return {}
    order = np.lexsort((child_ids, parent_ids_of_children))
    p, c = parent_ids_of_children[order], child_ids[order]
    out = {}
    uniq, starts = np.unique(p, return_index=True)
    bounds = np.append(starts, len(p))
    for i, s in enumerate(uniq):
        out[int(s)] = c[bounds[i]:bounds[i + 1]].tolist()
    return out


def hierarchy_to_proto(levels) -> list:
    """list[HierarchyLevelData] -> list[proto HierarchyLevel]."""
    out = []
    for lvl in levels:
        msg = proto.HierarchyLevel()
        nbrs = _neighbor_lists(lvl.ids, lvl.neighbor_pairs)
        if lvl.child_pairs is not None and len(lvl.child_pairs):
            children = _child_lists(lvl.child_pairs[:, 0], lvl.child_pairs[:, 1])
        else:
            children = {}
        parent = lvl.parent_ids
        for i, rid in enumerate(lvl.ids):
            cr = msg.region.add()
            cr.id = int(rid)
            cr.size = int(lvl.sizes[i])
            cr.neighbor_id.extend(nbrs.get(int(rid), []))
            if parent is not None:
                cr.parent_id = int(parent[i])
            cr.child_id.extend(children.get(int(rid), []))
            cr.start_frame = int(lvl.start_frames[i])
            cr.end_frame = int(lvl.end_frames[i])
        out.append(msg)
    return out


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _region_features_bytes(region_ids: np.ndarray) -> bytes:
    """Serialized `repeated RegionFeatures features = 10` entries, one per
    region with only the required `fixed32 id = 1` set — exactly what the
    reference emits under save_descriptors (segmentation.cpp:491-501; every
    AddToRegionFeatures implementation is empty, region_descriptor.cpp:137,
    :333).  Appended raw: protobuf fields parse in any byte order."""
    out = bytearray()
    for rid in np.asarray(region_ids).tolist():
        body = b"\x0d" + int(rid).to_bytes(4, "little")   # field 1, fixed32
        out += b"\x52" + _varint(len(body)) + body         # field 10, LEN
    return bytes(out)


def segframe_to_bytes(sf, vectorize: bool = False,
                      remove_rasterization: bool = False,
                      output_dims: tuple | None = None,
                      save_descriptors: bool = False,
                      trace=None) -> bytes:
    """Serialize a core.dense.SegFrame to SegmentationDesc wire bytes.

    With `vectorize`, region boundary polygons are computed and attached
    (and rasterizations optionally stripped, the reference's
    --write_to_file output shape, seg_tree.cpp:302-312).  `output_dims`
    (width, height) upscales the vector mesh and the emitted frame
    dimensions when segmentation ran on a downscaled video — requires
    remove_rasterization (the reference writer unit's upscale path,
    segmentation_unit.cpp:373-411).  With a `trace` (`runtime/trace.py`)
    the label raster and its polygons are an `encode.vectorize` span, and
    the polygons' rings are counted (`joint_boundary.compute_vectorization`)."""
    hierarchy = hierarchy_to_proto(sf.hierarchy) if sf.hierarchy else None
    payload = fast_proto.encode_frame(
        sf.region_ids, sf.interval_counts, sf.ys, sf.lxs, sf.rxs,
        getattr(sf, "moments", None),
        frame_width=sf.frame_width, frame_height=sf.frame_height,
        chunk_size=sf.chunk_size, overlap_start=sf.overlap_start,
        chunk_id=sf.chunk_id, hierarchy_frame_idx=sf.hierarchy_frame_idx,
        connectedness=proto.N4_CONNECT, hierarchy=hierarchy)
    if save_descriptors and hierarchy is not None:
        # The reference gates on output_hierarchy (segmentation.cpp:491):
        # features ride only on hierarchy (chunk-start) frames.
        payload += _region_features_bytes(sf.region_ids)
    if not vectorize:
        return payload

    from video_segment_tpu_torch.segment_util import (boundary,
                                                      joint_boundary, util)
    with (trace.span("encode.vectorize") if trace is not None
          else contextlib.nullcontext()):
        intervals = np.stack([sf.ys, sf.lxs, sf.rxs], axis=1)
        lab = util.rasterize_ids(sf.region_ids.astype(np.int64),
                                 sf.interval_counts, intervals,
                                 sf.frame_height, sf.frame_width)
        mesh, polys = joint_boundary.compute_vectorization(lab, trace=trace)
    desc = proto.SegmentationDesc()
    desc.ParseFromString(payload)
    if output_dims and (output_dims != (sf.frame_width, sf.frame_height)):
        if not remove_rasterization:
            raise ValueError("upscaled output requires remove_rasterization")
        ow, oh = output_dims
        boundary.vectorization_to_proto(desc, mesh, polys, True)
        boundary.scale_vectorization(desc, ow / sf.frame_width,
                                     oh / sf.frame_height)
        desc.frame_width = ow
        desc.frame_height = oh
    else:
        boundary.vectorization_to_proto(desc, mesh, polys,
                                        remove_rasterization)
    return desc.SerializeToString()
