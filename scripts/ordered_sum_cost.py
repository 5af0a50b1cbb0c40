"""Cost on the card of summing histograms in the JAX package's order.

    python3 scripts/ordered_sum_cost.py

Runs chip_smoke.py's 60-frame 272x480 main path (flow off) six times on
one CUDA card, alternating the histogram sums in XLA's order
(`ops/histograms.xla_order_sum`, what the CPU path runs) with the one
torch.sum a CUDA tensor takes, and prints fps and stage seconds of each
run.
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from video_segment_tpu_torch import api  # noqa: E402
from video_segment_tpu_torch.ops import histograms as th  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card_sum, card_dot = th.ordered_sum, th.ordered_dot

    def xla_dot(x, w):
        return th.xla_order_sum(x * w)

    frames = cs.synthetic_clip(60)
    list(api.segment_frames(iter(frames[:8]), cs.W, cs.H, use_flow=False))
    for tag in ("xla-order", "torch.sum", "torch.sum", "xla-order",
                "xla-order", "torch.sum"):
        if tag == "xla-order":
            th.ordered_sum, th.ordered_dot = th.xla_order_sum, xla_dot
        else:
            th.ordered_sum, th.ordered_dot = card_sum, card_dot
        torch.cuda.synchronize()
        t0 = time.monotonic()
        stream = api.segment_frames(iter(frames), cs.W, cs.H, use_flow=False)
        out = list(stream)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        st = {k: round(v, 3) for k, v in stream.stage_seconds.items()}
        print(f"{tag}: {len(out) / wall:.3f} fps; stage seconds {st}",
              flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
