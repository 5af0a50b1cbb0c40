"""Milliseconds a frame in the `encode.vectorize` span of `seg_tree`'s
trace (inside `encode`: the frame's label raster and its boundary
polygons), summed over the window's untraced clips, over their frames;
None where the program has no such span."""

from bench_port.metrics._stage import ms_per_frame


def read(rec):
    return ms_per_frame(rec, "encode.vectorize")
