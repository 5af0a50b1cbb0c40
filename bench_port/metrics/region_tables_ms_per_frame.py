"""Milliseconds a frame in the `region.tables` span, a chunk set's statistics
tables, edges and constraints, merged on the host, over the window's untraced
clips."""

from bench_port.metrics._stage import ms_per_frame


def read(rec):
    return ms_per_frame(rec, "region.tables")
