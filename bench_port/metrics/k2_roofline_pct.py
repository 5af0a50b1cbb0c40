"""K2 (`csrc/tile_extract.cu`, kernel `tile_reduce_min_kernel`), one
launch a chunk solve: the least time of the traced launches' solves,
counted in the real frames of each (roofline.k2_least_seconds, in the
protocol's order), over their device time summed from the profiler's
trace, in percent."""

from bench_port import roofline
from bench_port.metrics._kernel import launch_seconds


def read(rec):
    secs = launch_seconds(rec, "tile_reduce_min_kernel")
    solves = rec.get("traced_solves") or []
    if not secs or sum(secs) <= 0 or len(secs) > len(solves):
        return None
    return 100.0 * roofline.k2_least_seconds(
        solves[:len(secs)], rec["height"], rec["width"]) / sum(secs)
