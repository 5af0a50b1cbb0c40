"""K1 (`csrc/tile_felz.cu`, kernel `tile_felz_kernel`), one launch a
frame: the least time of the frames its traced launches ran
(roofline.k1_least_seconds) over their device time summed from the
profiler's trace, in percent."""

from bench_port import roofline
from bench_port.metrics._kernel import launch_seconds


def read(rec):
    secs = launch_seconds(rec, "tile_felz_kernel")
    if not secs or sum(secs) <= 0:
        return None
    return 100.0 * roofline.k1_least_seconds(
        len(secs), rec["height"], rec["width"]) / sum(secs)
