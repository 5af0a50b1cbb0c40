"""Milliseconds a frame in the `region.levels` span, agglomeration's level
loop, through its labels on the host, over the window's untraced clips."""

from bench_port.metrics._stage import ms_per_frame


def read(rec):
    return ms_per_frame(rec, "region.levels")
