"""Milliseconds a frame in the `host_tail.rle` span, the dense host tail's
per-frame RLE, moments and SegFrames, over the window's untraced clips."""

from bench_port.metrics._stage import ms_per_frame


def read(rec):
    return ms_per_frame(rec, "host_tail.rle")
