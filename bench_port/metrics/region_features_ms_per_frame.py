"""Milliseconds a frame in the `region.features` span, the region stage's
`add_frame`: Lab conversion and flow features, over the window's untraced
clips."""

from bench_port.metrics._stage import ms_per_frame


def read(rec):
    return ms_per_frame(rec, "region.features")
