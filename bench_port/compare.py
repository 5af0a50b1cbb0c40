"""The check that decides `correct`: the program's `.pb` output, parsed
here from the file with the benchmark's own reader, against the scene the
generator drew and against the guarantees the configuration states.

Nothing here runs or imports the program.  The reference is the
generator's ground truth (each pixel's object: `generator.synthetic_clip`
with `truth`) and the plain arithmetic below.  Numbers compared, each
against its limit in `limits/<cell>.json`:

- `frames_wrong`: frames missing over every clip of the window, and frames
  unparseable, of the wrong size or with a pixel that no scanline of
  exactly one region covers, over the clips compared (limit 0).  A frame
  whose regions carry no scanlines (`seg_tree --write_to_file`, which
  keeps only the boundary polygons) is rasterized here from its
  `vector_mesh` (`polygon_intervals`): a pixel that no region's polygons,
  or more than one region's, hold counts the same way.
- `hierarchy_faults`: over the clips compared, chunk sets whose first
  frame carries no hierarchy, or a hierarchy of one level; level-0 ids of
  a set's frames that its hierarchy's level 0 lacks; regions below the top
  level whose parent is not a region of the next level; and levels with
  more regions than the level below (limit 0).
- `leak`: over the frames of the clips compared, the largest share of a
  frame's pixels whose level-0 region (its whole extent in the clip) is
  mostly another object: 1 less the frame's achievable segmentation
  accuracy (Xu and Corso, CVPR 2012) over the drawn objects.  A region
  that spans two objects, a frame whose regions were merged, labels that
  stop following the scene, or a solve without the minimum region size
  (the control, `control.py`) read high.
"""

from __future__ import annotations

import struct

import numpy as np

_MSG = None


def _desc_class():
    global _MSG
    if _MSG is None:
        from google.protobuf import (descriptor_pb2, descriptor_pool,
                                     message_factory)
        from bench_port.proto_schema import DESCRIPTOR_SET
        fds = descriptor_pb2.FileDescriptorSet()
        fds.ParseFromString(DESCRIPTOR_SET)
        pool = descriptor_pool.DescriptorPool()
        for f in fds.file:
            pool.Add(f)
        _MSG = message_factory.GetMessageClass(
            pool.FindMessageTypeByName("segmentation.SegmentationDesc"))
    return _MSG


def read_container(path: str) -> list:
    """Frame payloads of a segmentation container (HEAD, CHNK tables of
    SEGD frames, TERM), in file order."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"HEAD":
        raise ValueError("no HEAD")
    (nflags,) = struct.unpack_from("<i", data, 4)
    pos = 8 + 4 * nflags
    frames = []
    while data[pos:pos + 4] == b"CHNK":
        _, n = struct.unpack_from("<ii", data, pos + 4)
        offsets = struct.unpack_from(f"<{n}q", data, pos + 12)
        (nxt,) = struct.unpack_from("<q", data, pos + 12 + 16 * n)
        for off in offsets:
            if data[off:off + 4] != b"SEGD":
                raise ValueError("no SEGD at a frame offset")
            (size,) = struct.unpack_from("<i", data, off + 4)
            frames.append(data[off + 8:off + 8 + size])
        pos = nxt
    if data[pos:pos + 4] != b"TERM":
        raise ValueError("no TERM")
    return frames


def count_wrong(pb_path: str, n_frames: int) -> int:
    """Frames missing from a `.pb` (or all, where it does not read), by
    its container alone."""
    try:
        return abs(len(read_container(pb_path)) - n_frames)
    except (OSError, ValueError, struct.error):
        return n_frames


def parse_frame(payload: bytes, w: int, h: int):
    """(labels (h, w) int64, hierarchy or None) of one frame; hierarchy:
    per level, (ids, parent ids) int64 arrays."""
    desc = _desc_class()()
    desc.ParseFromString(payload)
    if desc.frame_width != w or desc.frame_height != h:
        raise ValueError(f"frame is {desc.frame_width}x{desc.frame_height}")
    ids, ys, lxs, rxs = [], [], [], []
    for r in desc.region:
        for s in r.raster.scan_inter:
            ids.append(r.id)
            ys.append(s.y)
            lxs.append(s.left_x)
            rxs.append(s.right_x)
    if not ids and desc.HasField("vector_mesh"):
        ids, ys, lxs, rxs = polygon_intervals(desc, h, w)
    lab = fill(np.asarray(ids, np.int64), np.asarray(ys, np.int64),
               np.asarray(lxs, np.int64), np.asarray(rxs, np.int64), h, w)
    hier = None
    if len(desc.hierarchy):
        hier = [(np.asarray([c.id for c in lv.region], np.int64),
                 np.asarray([c.parent_id if c.HasField("parent_id") else -1
                             for c in lv.region], np.int64))
                for lv in desc.hierarchy]
    return lab, hier


def polygon_intervals(desc, h: int, w: int) -> tuple:
    """(ids, ys, lxs, rxs) of the scanline intervals that a frame's
    boundary polygons enclose.  Vertex N of a polygon is (coord[i],
    coord[i + 1]) for i = coord_idx[N], in corner space [0, W] x [0, H];
    the ring closes from its last vertex to its first.  A pixel belongs to
    a region when its centre (x + 0.5, y + 0.5) lies inside an odd number
    of the region's rings (inside its outer rings, outside its holes):
    a ray to the right counts an edge whose y range holds the centre's y,
    half open (lower end in, upper end out), where it crosses strictly to
    the right of the centre.  Each edge is taken from its lower end, so
    that two regions sharing it (neighbouring polygons share vertices
    exactly) compute the same crossing, and a centre on it goes to
    exactly one of them."""
    coord = np.asarray(desc.vector_mesh.coord, np.float64)
    reg, x0, y0, x1, y1 = [], [], [], [], []
    for k, r in enumerate(desc.region):
        for poly in r.vectorization.polygon:
            idx = np.asarray(poly.coord_idx, np.int64)
            if len(idx) < 3:
                continue
            if idx.min() < 0 or idx.max() + 1 >= len(coord):
                raise ValueError("polygon vertex outside the mesh")
            px, py = coord[idx], coord[idx + 1]
            reg.append(np.full(len(idx), k))
            x0.append(px)
            y0.append(py)
            x1.append(np.roll(px, -1))
            y1.append(np.roll(py, -1))
    if not reg:
        return [], [], [], []
    reg, x0, y0, x1, y1 = map(np.concatenate, (reg, x0, y0, x1, y1))
    down = y0 > y1
    x0, x1 = np.where(down, x1, x0), np.where(down, x0, x1)
    y0, y1 = np.where(down, y1, y0), np.where(down, y0, y1)
    # Rows whose centre y + 0.5 lies in [y0, y1).
    r0 = np.ceil(y0 - 0.5).astype(np.int64)
    nrow = np.maximum(np.ceil(y1 - 0.5).astype(np.int64) - r0, 0)
    e = np.repeat(np.arange(len(reg)), nrow)
    row = r0[e] + np.arange(int(nrow.sum())) - np.repeat(
        np.cumsum(nrow) - nrow, nrow)
    if len(row) and (row.min() < 0 or row.max() >= h):
        raise ValueError("polygon outside the frame")
    xc = x0[e] + (row + 0.5 - y0[e]) * (x1[e] - x0[e]) / (y1[e] - y0[e])
    # The crossing holds the pixels x < k: their centres lie left of it.
    k = np.clip(np.ceil(xc - 0.5), 0, w).astype(np.int64)
    rg = reg[e]
    order = np.lexsort((k, row, rg))
    rg, row, k = rg[order], row[order], k[order]
    if len(k) % 2 or (rg[0::2] != rg[1::2]).any() or \
            (row[0::2] != row[1::2]).any():
        raise ValueError("a ring that does not close")
    lx, rx = k[0::2], k[1::2] - 1
    keep = rx >= lx
    ids = np.asarray([r.id for r in desc.region], np.int64)
    return ids[rg[0::2][keep]], row[0::2][keep], lx[keep], rx[keep]


def fill(ids, ys, lxs, rxs, h: int, w: int) -> np.ndarray:
    """Scanline fill; pixels that no interval, or more than one, covers
    read -1."""
    lens = rxs - lxs + 1
    if len(lens) and ((lens < 1).any() or (ys < 0).any() or (ys >= h).any()
                      or (lxs < 0).any() or (rxs >= w).any()):
        raise ValueError("interval outside the frame")
    offs = np.arange(int(lens.sum())) - np.repeat(
        np.concatenate(([0], np.cumsum(lens)[:-1])), lens)
    pix = np.repeat(ys * w + lxs, lens) + offs
    img = np.full(h * w, -1, np.int64)
    img[pix] = np.repeat(ids, lens)
    img[np.bincount(pix, minlength=h * w) != 1] = -1
    return img.reshape(h, w)


def program_sets(pb_path: str, n_frames: int, w: int, h: int):
    """([(labels (T, H, W), hierarchy)] per chunk set, a set starting at
    each frame that carries a hierarchy; frames_wrong) of one clip's
    `.pb`.  A frame that does not parse counts as wrong and is left out."""
    try:
        payloads = read_container(pb_path)
    except (OSError, ValueError, struct.error):
        return [], n_frames
    wrong = abs(len(payloads) - n_frames)
    sets = []
    for p in payloads[:n_frames]:
        try:
            lab, hier = parse_frame(p, w, h)
        except Exception:   # any parse failure is a wrong frame
            wrong += 1
            lab, hier = np.full((h, w), -1, np.int64), None
        if (lab < 0).any():
            wrong += 1
        if hier is not None or not sets:
            sets.append(([], hier))
        sets[-1][0].append(lab)
    return [(np.stack(labs), hier) for labs, hier in sets], wrong


def hierarchy_faults(sets: list) -> int:
    """The structural faults of the clip's hierarchies (module doc)."""
    faults = 0
    for labels, hier in sets:
        if not hier or len(hier) < 2:
            faults += 1
            continue
        faults += int(np.setdiff1d(np.unique(labels[labels >= 0]),
                                   hier[0][0]).size)
        for lv in range(len(hier) - 1):
            ids, parents = hier[lv]
            faults += int((~np.isin(parents, hier[lv + 1][0])).sum())
            faults += int(len(hier[lv + 1][0]) > len(ids))
    return faults


def leak(labels: np.ndarray, truth: np.ndarray) -> float:
    """The largest, over frames, share of a frame's pixels whose level-0
    region is mostly another object (module doc).  `labels` (N, H, W),
    -1 where unlabelled (counted as leaked); `truth` (N, H, W)."""
    n = labels.shape[0]
    lab = labels.reshape(n, -1)
    obj = truth.reshape(n, -1).astype(np.int64)
    _, inv = np.unique(lab, return_inverse=True)
    inv = inv.reshape(n, -1)
    k = int(obj.max()) + 1
    joint = np.bincount((inv * k + obj).ravel(),
                        minlength=(int(inv.max()) + 1) * k)
    major = joint.reshape(-1, k).argmax(1)
    wrong = (major[inv] != obj) | (lab < 0)
    return float(wrong.mean(1).max())


def clip_numbers(sets: list, truth: np.ndarray) -> dict:
    """`hierarchy_faults` and `leak` of one clip."""
    if not sets:
        return {"hierarchy_faults": 1, "leak": 1.0}
    labels = np.concatenate([lab for lab, _ in sets])
    if labels.shape[0] != truth.shape[0]:
        truth = truth[:labels.shape[0]]
    return {"hierarchy_faults": hierarchy_faults(sets),
            "leak": leak(labels, truth)}


def judge(numbers: dict, limits: dict) -> bool:
    """Every number within its limit (a number with no limit fails)."""
    return all(k in limits and numbers[k] <= limits[k] for k in numbers)
