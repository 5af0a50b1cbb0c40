"""Bench config 3's geometry on the card: 2 row bands against 1 band.

    python3 scripts/banded_vs_monolithic.py [--frames 41] [--runs 2]

Runs `segment_frames(use_flow=True)` over chip_smoke.py's seeded synthetic
clip made 480 wide and 854 tall, on one CUDA card, alternating the default
options (a 21-frame chunk is 8,608,320 voxels, over `max_solve_voxels`, so
the solve splits into 2 bands of 432 rows with 10 pad rows) with
`max_solve_voxels` raised to the chunk's size (one band, no pad rows), and
prints fps, stage seconds and peak device memory of each run, then the
means, and the boundary F-measure between the two forms' level-0 output.
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from video_segment_tpu_torch import api  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=41)
    ap.add_argument("--runs", type=int, default=2,
                    help="runs of each form (alternating a, b, b, a)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    frames = cs.synthetic_clip(args.frames, seed=1, h=cs.BH, w=cs.BW)
    forms = {"2 bands": api.DenseSegmentationOptions(),
             "1 band": api.DenseSegmentationOptions(
                 max_solve_voxels=21 * cs.BW * cs.BH)}
    # Warm-up: kernels built, allocator primed.
    list(api.segment_frames(iter(frames[:6]), cs.BW, cs.BH, use_flow=True))
    fps = {k: [] for k in forms}
    peaks = {k: [] for k in forms}
    level0 = {}
    order = (["2 bands", "1 band", "1 band", "2 bands"]
             * -(-args.runs // 2))[:2 * args.runs]
    for tag in order:
        stream = api.segment_frames(iter(frames), cs.BW, cs.BH,
                                    use_flow=True, dense_options=forms[tag])
        geometry = (stream.dense._bands, stream.dense._pad_rows)
        out, wall, peak = cs.run_stream(stream, dev)
        fps[tag].append(len(out) / wall)
        peaks[tag].append(peak / 2 ** 20)
        level0[tag] = cs.rasterize(out)
        st = {k: round(v, 3) for k, v in stream.stage_seconds.items()}
        print(f"{tag} (bands, pad rows) {geometry}: {len(out) / wall:.3f} "
              f"fps; stage seconds {st}; peak device memory "
              f"{peak / 2 ** 20:.1f} MiB; level-0 regions "
              f"{len(np.unique(level0[tag]))}", flush=True)
    for tag in forms:
        print(f"{tag}: mean fps {sum(fps[tag]) / len(fps[tag]):.3f} "
              f"(runs {[round(v, 3) for v in fps[tag]]}); peak device "
              f"memory MiB {[round(v, 1) for v in peaks[tag]]}", flush=True)
    print(f"boundary F, 2 bands vs 1 band: "
          f"{cs.boundary_f(level0['2 bands'], level0['1 band']):.4f}",
          flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
