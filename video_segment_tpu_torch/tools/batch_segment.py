"""Batch throughput: segment multiple clips through one device.

Three modes:
- sequential (default --concurrent=1): clips run back to back; the
  kernels built for the first clip serve the rest.
- interleaved (--concurrent=N): N clips' pipelines run at once — their
  device programs serialize on the chip, but each clip's host stages
  (decode, RLE/proto emission, native histogram accumulation, hierarchy
  assembly) fill the gaps left while other clips own the device, as far
  as the interpreter lock lets threads overlap.  This is the batch-serving
  topology for one card (the JAX package's multi-device mesh is not
  ported).
- fused (--fused): same-resolution clips stream in LOCKSTEP through
  `core.batch.BatchDenseSegmentation` — the ready clips of each chunk
  index are prepared together and solved back to back (free and
  constrained chunks alike), host tails and region stages stay per-clip
  and overlap the next clip's solve.  The batch scales each clip's voxel
  budget by the clip count, so high resolutions pick more row bands.

Port of video_segment_tpu/tools/batch_segment.py; `--device` (default
"cuda", an error without a card) reaches every stage of every mode.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _run_one(path, args, idx=0):
    import os

    from video_segment_tpu_torch.api import segment_video
    from video_segment_tpu_torch.dataio import seg_io

    out = None
    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
        # Index-prefix when the same basename appears twice in the batch.
        base = os.path.basename(path)
        if sum(1 for p in args.inputs if os.path.basename(p) == base) > 1:
            base = f"{idx:03d}_{base}"
        out = os.path.join(args.output_dir, base + ".pb")
    t1 = time.time()
    pb = segment_video(path, out, use_flow=args.flow,
                       over_segment_only=args.over_segment,
                       trim_to=args.trim_to,
                       downscale_min_size=args.downscale_min_size,
                       device=args.device)
    r = seg_io.SegmentationReader(pb)
    r.open_and_read_headers()
    n = r.num_frames
    r.close()
    print(f"{path}: {n} frames in {time.time() - t1:.1f}s -> {pb}")
    return n


def _run_fused(args):
    """Lockstep fused batch: the clips' dense solves of one chunk index
    dispatched together, per-clip region stages and writers."""
    import os
    import tempfile

    from video_segment_tpu_torch.core import region
    from video_segment_tpu_torch.core.batch import BatchDenseSegmentation
    from video_segment_tpu_torch.core.options import (DenseSegmentationOptions,
                                                RegionSegmentationOptions)
    from video_segment_tpu_torch.dataio import emit, seg_io, video

    ds_mode = "to_min" if args.downscale_min_size else "none"
    readers = [video.VideoReader(p, trim_to=args.trim_to, downscale=ds_mode,
                                 downscale_size=args.downscale_min_size)
               for p in args.inputs]
    w, h = readers[0].info.width, readers[0].info.height
    for r in readers[1:]:
        if (r.info.width, r.info.height) != (w, h):
            raise SystemExit("--fused requires same-resolution clips")
    n = len(readers)
    bd = BatchDenseSegmentation(
        DenseSegmentationOptions(async_tail=True), w, h, n,
        device=args.device)
    regs = [region.RegionSegmentation(
        RegionSegmentationOptions(use_flow=False), w, h, device=args.device)
        for _ in range(n)]
    writers = []
    for i, path in enumerate(args.inputs):
        out = os.path.join(args.output_dir or tempfile.gettempdir(),
                           f"{i:03d}_{os.path.basename(path)}.pb")
        if args.output_dir:
            os.makedirs(args.output_dir, exist_ok=True)
        writers.append(seg_io.SegmentationWriter(out))
        writers[-1].open_file()
    iters = [iter(r) for r in readers]
    total = 0
    n_out = [0] * n

    def consume(i, sfs, flush):
        nonlocal total
        for sf in regs[i].process_frames(flush, sfs):
            if sf.hierarchy is not None and n_out[i] > 0:
                writers[i].write_chunk()
            writers[i].add_to_chunk(emit.segframe_to_bytes(sf))
            n_out[i] += 1
            total += 1

    live = [True] * n
    n_in = [0] * n
    while any(live):
        frames = []
        for i, it in enumerate(iters):
            fr = next(it, None) if live[i] else None
            live[i] = live[i] and fr is not None
            frames.append(fr if live[i] else None)
            if fr is not None and live[i]:
                regs[i].add_frame(n_in[i], fr, None)
                n_in[i] += 1
        if not any(live):
            break
        for i, sfs in enumerate(bd.process_frames(False, frames)):
            consume(i, sfs, False)
    final = bd.process_frames(True)
    for i in range(n):
        consume(i, final[i], True)
        writers[i].write_chunk()
        writers[i].write_term_and_close()
        readers[i].close()
    return total


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("inputs", nargs="+", help="video files")
    p.add_argument("--output_dir", default="", help="where to put .pb files")
    p.add_argument("--flow", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--over_segment", action="store_true")
    p.add_argument("--trim_to", type=int, default=0)
    p.add_argument("--downscale_min_size", type=int, default=0)
    p.add_argument("--concurrent", type=int, default=1,
                   help="clips interleaved through the device at once")
    p.add_argument("--fused", action="store_true",
                   help="lockstep clips through one batched dispatch per "
                        "chunk (same resolution)")
    p.add_argument("--device", default="cuda",
                   help="torch device of every stage (cuda or cpu); cuda "
                        "without a card is an error")
    args = p.parse_args(argv)

    from video_segment_tpu_torch import device as devmod
    args.device = devmod.resolve(args.device)

    t0 = time.time()
    total_frames = 0
    if args.fused:
        total_frames = _run_fused(args)
    elif args.concurrent > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=args.concurrent) as ex:
            for n in ex.map(lambda iv: _run_one(iv[1], args, iv[0]),
                            enumerate(args.inputs)):
                total_frames += n
    else:
        for i, path in enumerate(args.inputs):
            total_frames += _run_one(path, args, i)
    dt = time.time() - t0
    print(json.dumps({"clips": len(args.inputs), "frames": total_frames,
                      "seconds": round(dt, 2),
                      "fps": round(total_frames / max(dt, 1e-6), 3)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
