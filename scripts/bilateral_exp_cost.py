"""Cost on the card of the bilateral filter in the JAX package's rounding.

    python3 scripts/bilateral_exp_cost.py

Runs chip_smoke.py's 60-frame 272x480 main path (flow off) eight times on
one CUDA card, alternating the bilateral presmooth's weight function
between `ops/histograms.xla_exp` (XLA's exp polynomial with its fused
multiply-adds emulated in float64: what the port runs on every device) and
`torch.exp`, and prints fps and stage seconds of each run, then the mean
`ingest_preseg` seconds of each form and their ratio.  The filter's other
fused multiply-adds (colour distance, value sums) run in both forms.
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from video_segment_tpu_torch import api  # noqa: E402
from video_segment_tpu_torch.ops import filters  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    forms = {"xla_exp": filters.xla_exp, "torch.exp": torch.exp}
    frames = cs.synthetic_clip(60)
    list(api.segment_frames(iter(frames[:8]), cs.W, cs.H, use_flow=False))
    ingest = {name: [] for name in forms}
    try:
        for tag in ("xla_exp", "torch.exp", "torch.exp", "xla_exp") * 2:
            filters.xla_exp = forms[tag]
            torch.cuda.synchronize()
            t0 = time.monotonic()
            stream = api.segment_frames(iter(frames), cs.W, cs.H,
                                        use_flow=False)
            out = list(stream)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            ingest[tag].append(stream.stage_seconds["ingest_preseg"])
            st = {k: round(v, 3) for k, v in stream.stage_seconds.items()}
            print(f"{tag}: {len(out) / wall:.3f} fps; stage seconds {st}",
                  flush=True)
    finally:
        filters.xla_exp = forms["xla_exp"]
    mean = {k: sum(v) / len(v) for k, v in ingest.items()}
    print(f"ingest_preseg mean seconds {mean}; xla_exp / torch.exp = "
          f"{mean['xla_exp'] / mean['torch.exp']:.4f}", flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
