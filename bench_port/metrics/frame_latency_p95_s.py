"""95th percentile over every frame of the window of the seconds from the
port pulling the frame from the benchmark's iterator to the port yielding
its SegFrame (numpy's linear percentile)."""

import numpy as np


def read(rec):
    if not rec["latencies"]:
        return None
    return float(np.percentile(np.asarray(rec["latencies"]), 95))
