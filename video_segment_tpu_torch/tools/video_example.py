"""video_example: framework demo (reader -> luminance/flow -> writer).

Equivalent of the reference video_example (video_example.cpp:46-152): shows
both execution modes of the runtime — a single-threaded chain and a
pipelined multi-stage variant computing luminance + dense optical flow,
writing an annotated video.

Port of video_segment_tpu/tools/video_example.py; `--device` (default
"cuda", an error without a card) is where the flow engine runs.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_file", "-i", required=True)
    p.add_argument("--output_file", default="",
                   help="output mp4 (default <input>_example.mp4)")
    p.add_argument("--use_pipeline", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--flow", action=argparse.BooleanOptionalAction,
                   default=True, help="compute + visualize dense flow")
    p.add_argument("--trim_to", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device of the flow engine (cuda or cpu); "
                        "cuda without a card is an error")
    args = p.parse_args(argv)

    from video_segment_tpu_torch import device as devmod
    device = devmod.resolve(args.device)

    import cv2
    import numpy as np

    from video_segment_tpu_torch.core import flow as flow_mod
    from video_segment_tpu_torch.dataio import video
    from video_segment_tpu_torch.runtime import pipeline as pl

    reader = video.VideoReader(args.input_file, trim_to=args.trim_to)
    info = reader.info
    out_path = args.output_file or (args.input_file.rsplit(".", 1)[0]
                                    + "_example.mp4")
    writer = video.VideoWriter(out_path, info.width, info.height, info.fps)
    eng = (flow_mod.FlowEngine(info.width, info.height, device=device)
           if args.flow else None)

    def flow_to_hsv(flow):
        """HSV flow rendering (flow_reader.cpp:306-330)."""
        flow = flow_mod.as_flow_host(flow)
        mag, ang = cv2.cartToPolar(flow[..., 0].astype(np.float32),
                                   flow[..., 1].astype(np.float32))
        hsv = np.zeros((*mag.shape, 3), np.uint8)
        hsv[..., 0] = (ang * 180 / np.pi / 2).astype(np.uint8)
        hsv[..., 1] = 255
        hsv[..., 2] = np.clip(mag * 32, 0, 255).astype(np.uint8)
        return cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)

    def stage_fn(item):
        idx, frame = item
        if eng is not None:
            fl = eng.compute(frame, idx)
            vis = flow_to_hsv(fl) if fl is not None else frame
        else:
            vis = cv2.cvtColor(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY),
                               cv2.COLOR_GRAY2BGR)
        return [vis]

    t0 = time.time()
    n = 0
    if args.use_pipeline:
        pipe = pl.Pipeline([pl.Stage("process", stage_fn)])
        for vis in pipe.run(enumerate(reader)):
            writer.write(vis)
            n += 1
    else:
        for idx, frame in enumerate(reader):
            for vis in stage_fn((idx, frame)):
                writer.write(vis)
                n += 1
    writer.close()
    reader.close()
    print(f"wrote {n} frames to {out_path} "
          f"({n / max(time.time() - t0, 1e-6):.1f} fps)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
