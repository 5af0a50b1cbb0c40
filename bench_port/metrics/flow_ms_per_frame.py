"""Milliseconds a frame in the `flow` span of `seg_tree`'s trace (each flow
micro-batch of six pairs: its launches and, under `--save_flow`, the
fields' download), summed over the window's untraced clips, over their
frames; None where the program has no such span."""

from bench_port.metrics._stage import ms_per_frame


def read(rec):
    return ms_per_frame(rec, "flow")
