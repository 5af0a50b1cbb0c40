"""segment_converter: .pb stream -> per-frame text/binary/id-image/color dumps.

Equivalent of the reference segment_converter (segment_converter/
converter.cpp:60-231): modes text, binary, bitmap_ids, bitmap_color, strip;
fractional or absolute hierarchy level; maintains the current hierarchy
across chunks.

Copy of video_segment_tpu/tools/converter.py over the port's own host
modules (`proto`, `dataio/seg_io`, `segment_util`); it touches no tensor
and takes no `--device`.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", "-i", required=True, help="input .pb file")
    p.add_argument("--output_dir", "-o", default=".")
    p.add_argument("--mode", choices=["text", "binary", "bitmap_ids",
                                      "bitmap_color", "strip"],
                   default="bitmap_color")
    p.add_argument("--level", type=float, default=0.0,
                   help="hierarchy level; fractional in [0,1) or absolute")
    p.add_argument("--strip_output", default="",
                   help="output file for strip mode")
    args = p.parse_args(argv)

    import cv2
    import numpy as np

    from video_segment_tpu_torch import proto
    from video_segment_tpu_torch.dataio import seg_io
    from video_segment_tpu_torch.segment_util import render, util

    reader = seg_io.SegmentationReader(args.input)
    if not reader.open_and_read_headers():
        print(f"cannot open {args.input}", file=sys.stderr)
        return 1
    os.makedirs(args.output_dir, exist_ok=True)

    strip_writer = None
    if args.mode == "strip":
        out = args.strip_output or os.path.join(args.output_dir, "strip.pb")
        strip_writer = seg_io.SegmentationWriter(out)
        strip_writer.open_file(list(reader.header_flags))

    hierarchy = None
    for idx, payload in enumerate(reader):
        desc = proto.SegmentationDesc()
        desc.ParseFromString(payload)
        if len(desc.hierarchy):
            hierarchy = list(desc.hierarchy)
        level = util.absolute_level(hierarchy, args.level)

        if args.mode == "text":
            path = os.path.join(args.output_dir, f"frame{idx:04d}.pbtxt")
            with open(path, "w") as f:
                f.write(str(desc))
        elif args.mode == "binary":
            path = os.path.join(args.output_dir, f"frame{idx:04d}.pb")
            with open(path, "wb") as f:
                f.write(payload)
        elif args.mode == "bitmap_ids":
            img = util.desc_to_id_image(desc, hierarchy, level)
            # 24-bit id encoding over BGR channels (converter.cpp id bitmap).
            out = np.zeros((*img.shape, 3), np.uint8)
            out[..., 0] = img & 0xFF
            out[..., 1] = (img >> 8) & 0xFF
            out[..., 2] = (img >> 16) & 0xFF
            cv2.imwrite(os.path.join(args.output_dir,
                                     f"frame{idx:04d}.png"), out)
        elif args.mode == "bitmap_color":
            img = render.render_desc(desc, hierarchy, level)
            cv2.imwrite(os.path.join(args.output_dir,
                                     f"frame{idx:04d}.png"), img)
        elif args.mode == "strip":
            stripped = proto.SegmentationDesc()
            stripped.ParseFromString(payload)
            for r in stripped.region:
                r.ClearField("shape_moments")
            strip_writer.add_to_chunk(stripped.SerializeToString(),
                                      reader.frame_pts[idx])
            if (idx + 1) % 10 == 0:
                strip_writer.write_chunk()
    if strip_writer is not None:
        strip_writer.write_term_and_close()
    reader.close()
    print(f"converted {reader.num_frames} frames ({args.mode})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
