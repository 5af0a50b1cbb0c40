"""Milliseconds a frame in the `region.accumulate` span, a chunk's close in
the region stage: rasterization and the native Lab histograms, over the
window's untraced clips."""

from bench_port.metrics._stage import ms_per_frame


def read(rec):
    return ms_per_frame(rec, "region.accumulate")
