"""High-level user API of the PyTorch port.

    from video_segment_tpu_torch.api import segment_frames, segment_video

    for sf in segment_frames(frame_iter, w, h):       # on CUDA, flow on
        ...
    segment_video("clip.mp4", "clip.pb")

Same signatures as video_segment_tpu.api plus `device` (default "cuda";
a machine without CUDA raises instead of falling back).  With `use_flow`
(the default) a `core/flow.FlowEngine` on `device` computes each frame's
backward TV-L1 flow, which feeds the solver's temporal edges, the dense
stage's connectedness and the region stage's flow descriptors.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from video_segment_tpu_torch import device as devmod
from video_segment_tpu_torch.core import dense as dense_mod
from video_segment_tpu_torch.core.options import (DenseSegmentationOptions,
                                                  RegionSegmentationOptions)
from video_segment_tpu_torch.runtime.trace import Trace


def segment_frames(frames: Iterable[np.ndarray], frame_width: int,
                   frame_height: int, *,
                   use_flow: bool = True,
                   over_segment_only: bool = False,
                   dense_options: DenseSegmentationOptions | None = None,
                   region_options: RegionSegmentationOptions | None = None,
                   device: str | torch.device = "cuda",
                   ) -> "SegmentStream":
    """Stream BGR uint8 frames through the full segmentation pipeline on
    `device`, yielding SegFrame results (RLE regions + hierarchy on set
    starts).  The stage objects are built (and the arguments checked)
    before the first frame is consumed; they share the stream's `Trace`."""
    trace = Trace()
    dense = dense_mod.DenseSegmentation(
        dense_options or DenseSegmentationOptions(), frame_width,
        frame_height, device=device, trace=trace)
    region = None
    if not over_segment_only:
        from video_segment_tpu_torch.core import region as region_mod
        region = region_mod.RegionSegmentation(
            region_options or RegionSegmentationOptions(use_flow=use_flow),
            frame_width, frame_height, device=device, trace=trace)
    flow = None
    if use_flow:
        from video_segment_tpu_torch.core import flow as flow_mod
        flow = flow_mod.FlowEngine(frame_width, frame_height, device=device)
    return SegmentStream(frames, dense, region, flow)


class SegmentStream:
    """Iterator over the SegFrames of one `segment_frames` call, with the
    pipeline's counters: `stage_seconds` (every span of the stream's
    `trace`: ingest+preseg, chunk solve, host tail, region, flow when a
    flow engine runs, and their dotted parts, `runtime/trace.py`),
    `counters` (the trace's counters) and `solve_diag` (per chunk solve,
    per schedule level: [table cap (the v1 pixel solver: its
    segment-domain size), merge rounds, live regions]).  The trace is the
    dense stage's, which the region stage shares when `segment_frames`
    built both; a region stage built with its own trace adds its spans
    and counters to these views."""

    def __init__(self, frames, dense, region, flow=None):
        self.dense = dense
        self.region = region
        self.flow = flow
        self.trace = dense.trace
        self._gen = self._run(frames)

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._gen)

    def _traces(self) -> list:
        if self.region is None or self.region.trace is self.trace:
            return [self.trace]
        return [self.trace, self.region.trace]

    @property
    def stage_seconds(self) -> dict:
        out = {}
        for trace in self._traces():
            out.update(trace.seconds)
        if self.region is not None:
            out.setdefault("region", 0.0)
        if self.flow is not None:
            out.setdefault("flow", 0.0)
        return out

    @property
    def counters(self) -> dict:
        out = {}
        for trace in self._traces():
            out.update(trace.counters)
        return out

    @property
    def solve_diag(self) -> list:
        return self.dense.solve_diag

    def _run(self, frames):
        dense, region, flow = self.dense, self.region, self.flow
        for idx, frame in enumerate(frames):
            fl = None
            if flow is not None:
                with self.trace.span("flow"):
                    fl = flow.compute(frame, idx)
                    devmod.synchronize(flow.device)
            if region is not None:
                region.add_frame(idx, frame, fl)
            out = dense.process_frame(False, frame, fl)
            if region is not None:
                out = region.process_frames(False, out)
            yield from out
        out = dense.process_frame(True)
        if region is not None:
            out = region.process_frames(True, out)
        yield from out


def segment_video(input_path: str, output_path: str | None = None, *,
                  use_flow: bool = True, over_segment_only: bool = False,
                  trim_to: int = 0, downscale_min_size: int = 0,
                  vectorize: bool = False,
                  dense_options: DenseSegmentationOptions | None = None,
                  region_options: RegionSegmentationOptions | None = None,
                  device: str | torch.device = "cuda") -> str:
    """Segment a video file end to end; writes and returns the .pb path.
    Decoding (cv2) and the .pb writer (protobuf) are imported here only,
    so `segment_frames` needs neither."""
    from video_segment_tpu_torch.dataio import emit, seg_io, video

    reader = video.VideoReader(
        input_path, downscale="to_min" if downscale_min_size else "none",
        downscale_size=downscale_min_size, trim_to=trim_to)
    out_path = output_path or (input_path + ".pb")
    writer = seg_io.SegmentationWriter(out_path)
    if not writer.open_file(header_flags=[1 if vectorize else 0, 1]):
        raise IOError(f"cannot open {out_path}")
    try:
        n = 0
        for sf in segment_frames(reader, reader.info.width,
                                 reader.info.height, use_flow=use_flow,
                                 over_segment_only=over_segment_only,
                                 dense_options=dense_options,
                                 region_options=region_options,
                                 device=device):
            if sf.hierarchy is not None and n > 0:
                writer.write_chunk()
            writer.add_to_chunk(emit.segframe_to_bytes(sf,
                                                       vectorize=vectorize),
                                pts=reader.pts_of(sf.frame_index))
            n += 1
        writer.write_term_and_close()
    finally:
        reader.close()
    return out_path
