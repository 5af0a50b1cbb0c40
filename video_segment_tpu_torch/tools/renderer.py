"""segment_renderer: .pb stream -> rendered video / image directory.

Equivalent of the reference segment_renderer (segment_renderer/
renderer.cpp:177-320): renders random-color regions at a fractional or
absolute hierarchy level, tracking the current hierarchy across chunks;
optional JSON annotation project supplying labeled per-region colors
(JsonProjectParser, renderer.cpp:59-175).

Copy of video_segment_tpu/tools/renderer.py over the port's own host
modules; it touches no tensor and takes no `--device`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _load_project(path):
    """JSON annotation project: {level, regions:[{id, color:[b,g,r]}...]}."""
    with open(path) as f:
        data = json.load(f)
    colors = {}
    for entry in data.get("regions", []):
        rid = int(entry["id"])
        c = entry.get("color", [255, 255, 255])
        colors[rid] = (int(c[0]), int(c[1]), int(c[2]))
    return float(data.get("level", 0.0)), colors


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", "-i", required=True, help="input .pb file")
    p.add_argument("--output_video", default="", help="output mp4 path")
    p.add_argument("--output_image_dir", default="",
                   help="write PNGs here instead of video")
    p.add_argument("--render_level", type=float, default=0.0)
    p.add_argument("--fps", type=float, default=24.0)
    p.add_argument("--project", default="",
                   help="JSON annotation project with per-region colors")
    p.add_argument("--highlight_boundary",
                   action=argparse.BooleanOptionalAction, default=True)
    args = p.parse_args(argv)

    import cv2
    import numpy as np

    from video_segment_tpu_torch import proto
    from video_segment_tpu_torch.dataio import seg_io, video
    from video_segment_tpu_torch.segment_util import render, util

    level_override = None
    project_colors = {}
    if args.project:
        level_override, project_colors = _load_project(args.project)

    reader = seg_io.SegmentationReader(args.input)
    if not reader.open_and_read_headers():
        print(f"cannot open {args.input}", file=sys.stderr)
        return 1

    writer = None
    if args.output_image_dir:
        os.makedirs(args.output_image_dir, exist_ok=True)

    hierarchy = None
    n = 0
    for idx, payload in enumerate(reader):
        desc = proto.SegmentationDesc()
        desc.ParseFromString(payload)
        if len(desc.hierarchy):
            hierarchy = list(desc.hierarchy)
        frac = level_override if level_override is not None \
            else args.render_level
        level = util.absolute_level(hierarchy, frac)

        lab = util.desc_to_id_image(desc, hierarchy, level)
        if project_colors:
            img = np.zeros((*lab.shape, 3), np.uint8)
            for rid, c in project_colors.items():
                img[lab == rid] = c
        else:
            img = render.render_label_image(lab, args.highlight_boundary)

        if args.output_video:
            if writer is None:
                writer = video.VideoWriter(args.output_video,
                                           desc.frame_width,
                                           desc.frame_height, args.fps)
            writer.write(img)
        if args.output_image_dir:
            cv2.imwrite(os.path.join(args.output_image_dir,
                                     f"frame{idx:04d}.png"), img)
        n += 1
    if writer is not None:
        writer.close()
    reader.close()
    print(f"rendered {n} frames at level {args.render_level}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
