"""Milliseconds a frame in the `host_tail.ids` span, the dense host tail's
global ids, region presence, sizes and neighbour pairs, over the window's
untraced clips."""

from bench_port.metrics._stage import ms_per_frame


def read(rec):
    return ms_per_frame(rec, "host_tail.ids")
