"""Milliseconds a frame in the `region.hierarchy` span, a chunk set's level
ids, id inheritance and hierarchy, over the window's untraced clips."""

from bench_port.metrics._stage import ms_per_frame


def read(rec):
    return ms_per_frame(rec, "region.hierarchy")
