"""Chunked binary container for segmentation protobuf streams.

Byte-compatible with the reference container (format spec at
segment_util/segmentation_io.h:31-66) so files written here open in the
reference tools and vice versa:

    HEAD  num_flags:int32  flags:int32[num_flags]
    CHNK  header_id:int32  num_frames:int32
          file_offsets:int64[N]  pts:int64[N]  next_chunk_offset:int64
    SEGD  size:int32  payload:bytes[size]          (x N per chunk)
    TERM  num_chunks:int32

All integers little-endian.  Frame payloads are serialized
`segmentation.SegmentationDesc` messages (bytes in, bytes out here; parsing
is the caller's concern so the fast encoder can feed this directly).
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, Sequence

HEAD = b"HEAD"
CHNK = b"CHNK"
SEGD = b"SEGD"
TERM = b"TERM"


class SegmentationWriter:
    """Buffers frames per chunk and flushes with offset/pts tables."""

    def __init__(self, filename: str):
        self._filename = filename
        self._file = None
        self._chunk_payloads: list[bytes] = []
        self._chunk_pts: list[int] = []
        self._num_chunks = 0

    def open_file(self, header_flags: Sequence[int] = ()) -> bool:
        try:
            self._file = open(self._filename, "wb")
        except OSError:
            return False
        self._file.write(HEAD)
        self._file.write(struct.pack("<i", len(header_flags)))
        for f in header_flags:
            self._file.write(struct.pack("<i", int(f)))
        return True

    def open_for_append(self, offset: int, num_chunks: int) -> bool:
        """Reopen an existing container to continue after `num_chunks`
        complete chunks ending at byte `offset` (as recorded by `tell()`
        after a `write_chunk`).  Anything after the offset (e.g. a TERM
        from an interrupted close) is truncated."""
        try:
            self._file = open(self._filename, "r+b")
        except OSError:
            return False
        self._file.seek(offset)
        self._file.truncate(offset)
        self._num_chunks = num_chunks
        return True

    def tell(self) -> int:
        return self._file.tell()

    @property
    def num_chunks(self) -> int:
        return self._num_chunks

    def add_to_chunk(self, payload: bytes, pts: int = 0) -> None:
        self._chunk_payloads.append(payload)
        self._chunk_pts.append(int(pts))

    def write_chunk(self) -> None:
        if not self._chunk_payloads:
            return
        f = self._file
        n = len(self._chunk_payloads)
        header_pos = f.tell()
        # CHNK + id + n + offsets + pts + next offset.
        header_size = 4 + 4 + 4 + 8 * n + 8 * n + 8
        offsets = []
        pos = header_pos + header_size
        for p in self._chunk_payloads:
            offsets.append(pos)
            pos += 4 + 4 + len(p)
        f.write(CHNK)
        f.write(struct.pack("<ii", self._num_chunks, n))
        f.write(struct.pack(f"<{n}q", *offsets))
        f.write(struct.pack(f"<{n}q", *self._chunk_pts))
        f.write(struct.pack("<q", pos))
        for p in self._chunk_payloads:
            f.write(SEGD)
            f.write(struct.pack("<i", len(p)))
            f.write(p)
        self._num_chunks += 1
        self._chunk_payloads.clear()
        self._chunk_pts.clear()

    def write_term_and_close(self) -> None:
        if self._chunk_payloads:
            self.write_chunk()
        self._file.write(TERM)
        self._file.write(struct.pack("<i", self._num_chunks))
        self._file.close()
        self._file = None

    def flush_and_reopen(self) -> None:
        """Flush current chunk to disk without terminating the stream."""
        self.write_chunk()
        self._file.flush()


def strip_to_essentials(desc, save_vectorization: bool = True,
                        save_shape_moments: bool = False) -> bytes:
    """Compact custom binary frame encoding for the web annotator
    (byte-compatible with StripToEssentials, segmentation_io.cpp:311-440):
    little-endian width/height, optional short-packed vector mesh, per-region
    id + polygons (or int16 scanlines) + optional integer moments, then the
    hierarchy (id, size, parent, children per compound region)."""
    import io

    out = io.BytesIO()

    def w_i32(v):
        out.write(struct.pack("<i", int(v)))

    def w_i16(v):
        out.write(struct.pack("<h", int(v)))

    def w_u8(v):
        out.write(struct.pack("<B", int(v)))

    w_i32(desc.frame_width)
    w_i32(desc.frame_height)

    if save_vectorization:
        coords = desc.vector_mesh.coord
        w_i32(len(coords))
        for c in coords:
            w_i16(int(c))

    w_i32(len(desc.region))
    for r in desc.region:
        w_i32(r.id)
        if save_vectorization:
            w_i32(len(r.vectorization.polygon))
            for poly in r.vectorization.polygon:
                w_i16(len(poly.coord_idx))
                w_u8(1 if poly.hole else 0)
                for idx in poly.coord_idx:
                    w_i16(idx)
        else:
            w_i32(len(r.raster.scan_inter))
            for si in r.raster.scan_inter:
                w_i16(si.y)
                w_i16(si.left_x)
                w_i16(si.right_x)
        if save_shape_moments:
            sm = r.shape_moments
            for v in (sm.size, sm.mean_x, sm.mean_y, sm.moment_xx,
                      sm.moment_xy, sm.moment_yy):
                w_i32(v)

    w_i32(len(desc.hierarchy))
    for level in desc.hierarchy:
        w_i32(len(level.region))
        for cr in level.region:
            w_i32(cr.id)
            w_i32(cr.size)
            w_i32(cr.parent_id)
            w_i32(len(cr.child_id))
            for c in cr.child_id:
                w_i32(c)
            w_i32(cr.start_frame)
            w_i32(cr.end_frame)
    return out.getvalue()


class SegmentationReader:
    """Random-access reader over the chunked container."""

    def __init__(self, filename: str):
        self._filename = filename
        self._file = None
        self.frame_offsets: list[int] = []
        self.frame_pts: list[int] = []
        self.header_flags: list[int] = []
        self._next_frame = 0

    def open_and_read_headers(self) -> bool:
        if not os.path.exists(self._filename):
            return False
        self._file = open(self._filename, "rb")
        f = self._file
        magic = f.read(4)
        if magic != HEAD:
            return False
        (m,) = struct.unpack("<i", f.read(4))
        self.header_flags = list(struct.unpack(f"<{m}i", f.read(4 * m))) if m else []
        while True:
            tag = f.read(4)
            if tag == TERM or len(tag) < 4:
                break
            if tag != CHNK:
                raise IOError(f"corrupt container: unexpected tag {tag!r}")
            _hid, n = struct.unpack("<ii", f.read(8))
            offs = struct.unpack(f"<{n}q", f.read(8 * n))
            pts = struct.unpack(f"<{n}q", f.read(8 * n))
            (next_off,) = struct.unpack("<q", f.read(8))
            self.frame_offsets.extend(offs)
            self.frame_pts.extend(pts)
            f.seek(next_off)
        self._next_frame = 0
        return True

    @property
    def num_frames(self) -> int:
        return len(self.frame_offsets)

    def seek_to_frame(self, idx: int) -> None:
        self._next_frame = idx

    def read_frame(self) -> bytes:
        idx = self._next_frame
        f = self._file
        f.seek(self.frame_offsets[idx])
        tag = f.read(4)
        if tag != SEGD:
            raise IOError(f"corrupt container: expected SEGD, got {tag!r}")
        (sz,) = struct.unpack("<i", f.read(4))
        payload = f.read(sz)
        self._next_frame = idx + 1
        return payload

    def __iter__(self) -> Iterator[bytes]:
        self.seek_to_frame(0)
        for _ in range(self.num_frames):
            yield self.read_frame()

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None
