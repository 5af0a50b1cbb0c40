"""segment_viewer: interactive viewer for .pb segmentation streams.

Equivalent of the reference segment_viewer (segment_viewer/viewer.cpp:47-216):
frame and hierarchy-level trackbars, play/pause, on-demand re-render.  Runs
with cv2's HighGUI when a display is available; `--dump` renders a contact
sheet instead (headless environments).

Copy of video_segment_tpu/tools/viewer.py over the port's own host
modules; it touches no tensor and takes no `--device`.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", "-i", required=True)
    p.add_argument("--dump", default="",
                   help="headless: write a contact sheet PNG and exit")
    args = p.parse_args(argv)

    import cv2
    import numpy as np

    from video_segment_tpu_torch import proto
    from video_segment_tpu_torch.dataio import seg_io
    from video_segment_tpu_torch.segment_util import render

    reader = seg_io.SegmentationReader(args.input)
    if not reader.open_and_read_headers():
        print(f"cannot open {args.input}", file=sys.stderr)
        return 1

    # Seek-based random access (the reference viewer seeks the hierarchy
    # frame via hierarchy_frame_idx, viewer.cpp:146-168): frames are read
    # on demand through the container's per-frame offset table instead of
    # loading the whole stream into memory.
    n_frames = reader.num_frames
    desc_cache: dict[int, object] = {}
    cache_order: list[int] = []

    def desc_at(idx: int):
        d = desc_cache.get(idx)
        if d is None:
            reader.seek_to_frame(idx)
            d = proto.SegmentationDesc()
            d.ParseFromString(reader.read_frame())
            desc_cache[idx] = d
            cache_order.append(idx)
            if len(cache_order) > 64:
                desc_cache.pop(cache_order.pop(0), None)
        return d

    def hierarchy_of(d):
        if len(d.hierarchy):
            return list(d.hierarchy)
        hd = desc_at(d.hierarchy_frame_idx)
        return list(hd.hierarchy) if len(hd.hierarchy) else None

    levels = len(hierarchy_of(desc_at(0)) or []) or 1

    def frame_at(idx: int, level: int):
        d = desc_at(idx)
        hier = hierarchy_of(d)
        lvl = min(level, len(hier) - 1) if hier else 0
        return render.render_desc(d, hier, lvl)

    if args.dump:
        n = n_frames
        picks = sorted({0, n // 4, n // 2, 3 * n // 4, n - 1})
        rows = []
        for lvl in range(0, levels, max(1, levels // 3)):
            rows.append(np.concatenate([frame_at(i, lvl) for i in picks],
                                       axis=1))
        cv2.imwrite(args.dump, np.concatenate(rows, axis=0))
        print(f"wrote contact sheet to {args.dump}")
        return 0

    win = "segment_viewer"
    cv2.namedWindow(win)
    state = {"frame": 0, "level": 0, "play": False}
    cv2.createTrackbar("frame", win, 0, n_frames - 1,
                       lambda v: state.update(frame=v))
    cv2.createTrackbar("level", win, 0, max(levels - 1, 1),
                       lambda v: state.update(level=v))
    while True:
        cv2.imshow(win, frame_at(state["frame"], state["level"]))
        key = cv2.waitKey(30 if state["play"] else 100) & 0xFF
        if key == ord(" "):
            state["play"] = not state["play"]
        elif key in (27, ord("q")):
            break
        if state["play"]:
            state["frame"] = (state["frame"] + 1) % n_frames
            cv2.setTrackbarPos("frame", win, state["frame"])
    cv2.destroyAllWindows()
    return 0


if __name__ == "__main__":
    sys.exit(main())
