"""Milliseconds a frame in the `region.emit` span, a chunk set's re-emitted
frames: rasterization, RLE and moments, over the window's untraced clips."""

from bench_port.metrics._stage import ms_per_frame


def read(rec):
    return ms_per_frame(rec, "region.emit")
