"""Milliseconds a frame in the `host_tail.connect` span, the dense host
tail's spatial connectedness, over the window's untraced clips."""

from bench_port.metrics._stage import ms_per_frame


def read(rec):
    return ms_per_frame(rec, "host_tail.connect")
