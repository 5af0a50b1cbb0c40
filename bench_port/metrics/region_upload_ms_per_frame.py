"""Milliseconds a frame in the `region.upload` span, the copies of a chunk
set's tables to the card: blocking, from pageable memory, over the window's
untraced clips."""

from bench_port.metrics._stage import ms_per_frame


def read(rec):
    return ms_per_frame(rec, "region.upload")
