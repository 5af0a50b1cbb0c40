"""Cost on the card of the size penalty in the JAX package's float order.

    python3 scripts/size_penalty_cost.py

Runs chip_smoke.py's 60-frame 272x480 main path (flow off) eight times on
one CUDA card, alternating the agglomeration's combined distance in XLA's
order (`ops/histograms.combined_distance`: XLA's log polynomial and fused
multiply-adds, what the port runs on every device) with a plain form
(torch.log2, unfused products), and prints fps and stage seconds of each
run, then the mean region-stage seconds of each form and their ratio.
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
    xla = th.combined_distance

    def plain(color_d, flow_d, size_a, size_b, inv_median_size,
              penalizer=0.25, use_flow=True):
        prod = 1.0 - color_d
        if use_flow:
            prod = prod * (1.0 - flow_d)
        base = (1.0 - prod) * (1.0 - prod)
        min_sz = torch.minimum(size_a, size_b)
        scale = torch.clamp(1.0 + penalizer * torch.log2(
            torch.clamp(min_sz * inv_median_size, min=1e-20)), max=1.0)
        return torch.clamp(base * scale, 0.0, 1.0)

    frames = cs.synthetic_clip(60)
    list(api.segment_frames(iter(frames[:8]), cs.W, cs.H, use_flow=False))
    region = {"xla-order": [], "torch.log2": []}
    for tag in ("xla-order", "torch.log2", "torch.log2", "xla-order") * 2:
        th.combined_distance = xla if tag == "xla-order" else plain
        torch.cuda.synchronize()
        t0 = time.monotonic()
        stream = api.segment_frames(iter(frames), cs.W, cs.H, use_flow=False)
        out = list(stream)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        region[tag].append(stream.stage_seconds["region"])
        st = {k: round(v, 3) for k, v in stream.stage_seconds.items()}
        print(f"{tag}: {len(out) / wall:.3f} fps; stage seconds {st}",
              flush=True)
    th.combined_distance = xla
    mean = {k: sum(v) / len(v) for k, v in region.items()}
    print(f"region stage mean seconds {mean}; xla-order / torch.log2 = "
          f"{mean['xla-order'] / mean['torch.log2']:.4f}", flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
