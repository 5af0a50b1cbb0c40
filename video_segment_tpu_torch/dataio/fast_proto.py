"""Vectorized wire-format encoding for SegmentationDesc frames.

Encoding one frame of a 1080p segmentation means serializing on the order of
10^5 ScanInterval messages; doing that through Python protobuf objects costs
~1 us per message and would dominate the whole pipeline.  This module emits
the proto2 wire format for the hot part — the `region` list with RLE
rasterizations (reference schema: segment_util/segmentation.proto:56-98) —
directly from NumPy arrays, vectorizing varint layout and byte emission.
The slow-changing scalar fields and the per-chunk hierarchy are serialized
with the regular protobuf classes and concatenated (proto2 permits fields in
any order on the wire).

Wire layout emitted per region entry (field numbers < 16 → 1-byte tags):

    0x12 <len: region payload>
      0x08 <varint id>
      0x1A <len: raster payload>
        repeat: 0x0A <len> 0x08 <y> 0x10 <left_x> 0x18 <right_x>
"""

from __future__ import annotations

import numpy as np

from video_segment_tpu_torch import proto


def _varint_len(v: np.ndarray) -> np.ndarray:
    """Byte length of the varint encoding of non-negative int64 values."""
    v = v.astype(np.int64)
    l = np.ones(v.shape, np.int64)
    for k in (7, 14, 21, 28, 35, 42, 49, 56):
        l += v >= (1 << k)
    return l


def _write_varints(buf: np.ndarray, off: np.ndarray, v: np.ndarray,
                   lens: np.ndarray | None = None) -> None:
    """Write varint(v[i]) at buf[off[i]:] for all i (vectorized)."""
    v = v.astype(np.int64)
    if lens is None:
        lens = _varint_len(v)
    max_len = int(lens.max()) if lens.size else 0
    for i in range(max_len):
        m = lens > i
        if i > 0 and not m.any():
            break
        vv = v[m]
        byte = (vv >> (7 * i)) & 0x7F
        cont = (lens[m] - 1) > i
        buf[off[m] + i] = (byte | (cont.astype(np.int64) << 7)).astype(np.uint8)


def encode_varint(v: int) -> bytes:
    out = bytearray()
    v = int(v)
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


_MOMENTS_PAYLOAD = 30                    # six 1-byte tags + float32 each
_MOMENTS_ENTRY = 2 + _MOMENTS_PAYLOAD    # 0x2A + len + payload


def encode_regions(region_ids: np.ndarray,
                   interval_counts: np.ndarray,
                   ys: np.ndarray,
                   lxs: np.ndarray,
                   rxs: np.ndarray,
                   moments: np.ndarray | None = None) -> bytes:
    """Serialize the `region` field (repeated Region2D with rasters).

    Args:
      region_ids: (R,) int region ids, ascending (invariant: sorted ids,
        reference segmentation.proto:49-52).
      interval_counts: (R,) number of scan intervals per region; intervals of
        region r occupy the next `interval_counts[r]` slots of ys/lxs/rxs in
        (y, x) lexicographic order.
      ys, lxs, rxs: (I,) scanline y, left_x, right_x (inclusive) per interval.
      moments: optional (R,6) float32 ShapeMoments
        [size, mean_x, mean_y, moment_xx, moment_xy, moment_yy].
    """
    region_ids = np.asarray(region_ids, np.int64)
    interval_counts = np.asarray(interval_counts, np.int64)
    ys = np.asarray(ys, np.int64)
    lxs = np.asarray(lxs, np.int64)
    rxs = np.asarray(rxs, np.int64)
    R = region_ids.shape[0]
    if R == 0:
        return b""

    sy = _varint_len(ys)
    sl = _varint_len(lxs)
    sr = _varint_len(rxs)
    ipayload = 3 + sy + sl + sr          # three 1-byte tags + varints
    ientry = 2 + ipayload                # 0x0A + 1-byte len (payload <= 29)

    starts = np.zeros(R, np.int64)
    starts[1:] = np.cumsum(interval_counts[:-1])
    ends = starts + interval_counts
    centry = np.concatenate(([0], np.cumsum(ientry)))
    raster_len = centry[ends] - centry[starts]

    m_entry = _MOMENTS_ENTRY if moments is not None else 0
    s_id = _varint_len(region_ids)
    s_rlen = _varint_len(raster_len)
    region_payload = (1 + s_id) + (1 + s_rlen) + raster_len + m_entry
    s_rp = _varint_len(region_payload)
    region_entry = 1 + s_rp + region_payload

    rstart = np.concatenate(([0], np.cumsum(region_entry)))
    total = int(rstart[-1])
    buf = np.zeros(total, np.uint8)

    # Region entry headers.
    buf[rstart[:-1]] = 0x12
    o = rstart[:-1] + 1
    _write_varints(buf, o, region_payload, s_rp)
    o = o + s_rp
    buf[o] = 0x08
    _write_varints(buf, o + 1, region_ids, s_id)
    o = o + 1 + s_id
    buf[o] = 0x1A
    _write_varints(buf, o + 1, raster_len, s_rlen)
    iblock = o + 1 + s_rlen              # start of this region's intervals

    if moments is not None:
        # Fixed 32-byte shape_moments block after the raster.
        m = np.ascontiguousarray(moments, "<f4").view(np.uint8).reshape(R, 6, 4)
        mo = (iblock + raster_len)[:, None]
        buf[mo[:, 0]] = 0x2A
        buf[mo[:, 0] + 1] = _MOMENTS_PAYLOAD
        tags = np.arange(1, 7, dtype=np.uint8) << 3 | 5  # wire type 5
        pos = mo + 2 + np.arange(6)[None, :] * 5
        buf[pos] = tags[None, :]
        for b_i in range(4):
            buf[pos + 1 + b_i] = m[:, :, b_i]

    # Interval entries: global offset = region block start + intra-region csum.
    region_of = np.repeat(np.arange(R), interval_counts)
    ioff = iblock[region_of] + (centry[:-1] - centry[starts][region_of])

    buf[ioff] = 0x0A
    buf[ioff + 1] = ipayload.astype(np.uint8)
    buf[ioff + 2] = 0x08
    _write_varints(buf, ioff + 3, ys, sy)
    o = ioff + 3 + sy
    buf[o] = 0x10
    _write_varints(buf, o + 1, lxs, sl)
    o = o + 1 + sl
    buf[o] = 0x18
    _write_varints(buf, o + 1, rxs, sr)

    return buf.tobytes()


def encode_frame(region_ids: np.ndarray,
                 interval_counts: np.ndarray,
                 ys: np.ndarray,
                 lxs: np.ndarray,
                 rxs: np.ndarray,
                 moments: np.ndarray | None = None,
                 *,
                 frame_width: int,
                 frame_height: int,
                 chunk_size: int | None = None,
                 overlap_start: int | None = None,
                 chunk_id: int | None = None,
                 hierarchy_frame_idx: int | None = None,
                 connectedness: int | None = None,
                 hierarchy: list | None = None) -> bytes:
    """Serialize a full SegmentationDesc for one frame.

    `hierarchy` is an optional list of HierarchyLevel protobuf messages
    (cold path, regular protobuf serialization).
    """
    desc = proto.SegmentationDesc()
    desc.frame_width = int(frame_width)
    desc.frame_height = int(frame_height)
    if chunk_size is not None:
        desc.chunk_size = int(chunk_size)
    if overlap_start is not None:
        desc.overlap_start = int(overlap_start)
    if chunk_id is not None:
        desc.chunk_id = int(chunk_id)
    if hierarchy_frame_idx is not None:
        desc.hierarchy_frame_idx = int(hierarchy_frame_idx)
    if connectedness is not None:
        desc.connectedness = int(connectedness)
    if hierarchy:
        for level in hierarchy:
            desc.hierarchy.add().CopyFrom(level)
    tail = desc.SerializeToString()
    head = encode_regions(region_ids, interval_counts, ys, lxs, rxs, moments)
    return head + tail


def decode_rasterizations(desc) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Extract (region_ids, interval_counts, intervals[y,lx,rx]) from a parsed
    SegmentationDesc (protobuf object)."""
    ids = []
    counts = []
    rows = []
    for r in desc.region:
        ids.append(r.id)
        counts.append(len(r.raster.scan_inter))
        for si in r.raster.scan_inter:
            rows.append((si.y, si.left_x, si.right_x))
    intervals = np.array(rows, np.int32).reshape(-1, 3)
    return (np.array(ids, np.int32), np.array(counts, np.int32), intervals)
