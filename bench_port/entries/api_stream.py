"""Entry `api_stream`: `video_segment_tpu_torch.api.segment_frames` over
the clip's frames, each SegFrame encoded with the port's
`dataio.emit.segframe_to_bytes` and written through
`dataio.seg_io.SegmentationWriter`, as `api.segment_video` does, minus
decoding."""

from __future__ import annotations

import time


class Entry:
    def __init__(self, config: dict, device: str, workdir: str):
        from video_segment_tpu_torch.core.options import (
            DenseSegmentationOptions, RegionSegmentationOptions)
        self.config = config
        self.device = device
        self.dense_options = DenseSegmentationOptions(
            **config["dense_options"])
        self.region_options = RegionSegmentationOptions(
            **config["region_options"])

    def prepare(self, frames: list) -> list:
        """The clip as this entry reads it: the frames themselves."""
        return frames

    def run_clip(self, frames: list, pb_path: str) -> dict:
        """Segment one clip (from `prepare`) as a new stream into
        `pb_path`.  Returns the per-frame pull and yield times (host
        clock), the end time (the `.pb` closed) and the stream's stage
        seconds and counters."""
        from video_segment_tpu_torch import api
        from video_segment_tpu_torch.dataio import emit, seg_io

        cfg = self.config
        pulled, done = {}, {}

        def feed():
            for i, frame in enumerate(frames):
                pulled[i] = time.monotonic()
                yield frame

        stream = api.segment_frames(
            feed(), cfg["width"], cfg["height"], use_flow=cfg["use_flow"],
            dense_options=self.dense_options,
            region_options=self.region_options, device=self.device)
        writer = seg_io.SegmentationWriter(pb_path)
        if not writer.open_file(header_flags=[0, 1]):
            raise IOError(f"cannot open {pb_path}")
        n = 0
        for sf in stream:
            done[sf.frame_index] = time.monotonic()
            if sf.hierarchy is not None and n > 0:
                writer.write_chunk()
            writer.add_to_chunk(emit.segframe_to_bytes(sf),
                                pts=sf.frame_index)
            n += 1
        writer.write_term_and_close()
        end = time.monotonic()
        latencies = [done[i] - pulled[i] for i in sorted(done)
                     if i in pulled]
        return {"frames": n, "end": end, "latencies": latencies,
                "stage_seconds": dict(stream.stage_seconds),
                "counters": dict(stream.counters)}
