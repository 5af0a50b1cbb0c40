"""On-card checks of the PyTorch / CUDA port, on one NVIDIA card.

    python3 chip_smoke.py

Each phase checks something and prints what it found; any failure exits
non-zero.  Whole paths are timed by the benchmark (`bench_port/`: fps,
latency, spans, peak memory of each cell), not here: this script times
kernels alone (phases 3, 4, 7, 8, 12 and 32, and the kernel lines of 29
and 30) and phase 17's chunk solve in 2 bands against 1.  Every line starts
with the seconds since the start, for the script's own time budget.

Phases:
 1. environment: torch / CUDA versions, card name, power limit;
 2. build: the six hand-written kernels from video_segment_tpu_torch/csrc
    (one nvcc each, sm_90a, all started together) and the native host
    helpers (g++); a resource line per kernel (registers, spills, shared
    memory, CTAs per SM from the occupancy API, waves at the main path's
    grid);
 3. K1 tile_felzenszwalb equals its plain PyTorch version bit for bit on
    textured, clip and flat volumes; its time on a textured, a clip and a
    flat 272x480 frame, and its bound;
 4. K2 tile_reduce_min equals its plain version and one library call
    (scatter_reduce_ "amin" plus a gather) at a chunk's shape, and its
    plain version at one band's shape of the banded 480x854 path,
    (13,21,432,480), with the times and bounds; the presmoothed clip's
    colours in (0, 2^-20), where K1's float64 sums stop being exact;
 5. the main path: segment_frames(use_flow=False, device="cuda") over a
    seeded 60-frame 272x480 synthetic clip (bench config 2's geometry):
    frames in order, every pixel labelled, ascending ids, parent links
    inside the next level, the protocol's chunk solves, K1 once a frame,
    K2 once a chunk solve and K6 once a frame;
 6. the dense stage on the card against the same port on the CPU
    (level-0 boundary F);
 7. K4 tile_presegment equals its plain version on a (21,272,480) chunk
    (raw roots and collapsed labels): the raw flood's time, bound and
    share, and the iterations the slowest tile ran before its fixed point;
 8. K3 tile_table_rounds equals its plain version on quantized random
    tables and on the first gated level of a real fine-preseg 272x480
    chunk, with the time, bound and share of each;
 9. the flood path: segment_frames with preseg_mode="flood" over 31
    frames (2 chunk solves): the checks of 5, K4 and K2 once a chunk
    solve, K1 never;
10. the supertile path: SegmentStream(DenseSegmentation(solver_params=
    fine presegs + 3 K3 levels), RegionSegmentation) over 31 frames: the
    checks of 5, K1, K2 and K3 launches exact;
11. the flood and supertile dense stages, card vs CPU (boundary F), and
    the K3 path against the masked rounds on the card;
12. TV-L1 on the card: card vs CPU on a 272x480 pair, the panning
    background's motion recovered, the pair's time; then K5
    (csrc/tvl1.cu) on a batch of 6 pairs: the fields equal the eager
    body's on the card bit for bit, the launches, the kernels' time
    against their bound (and by limit: the finest scale against its
    bytes, the coarse scales against a launch floor), the whole batch on
    the card and as the host issues it, the eager body's time, and
    TV-L1's peak memory both ways (the resource line of K5's iteration
    kernel is printed here, after its first launch);
13. the flow path: segment_frames(use_flow=True) over 31 frames: the checks
    of 5, the flow engine ran, K1 and K2 exact, one K5 launch sequence a
    pair;
14. the flow dense stage, card vs CPU on the same host flow arrays;
15. the banded path: segment_frames(use_flow=True) at default options over
    the seeded clip drawn 480 wide and 854 tall (bench config 3's
    geometry), 31 frames: 2 row bands and 10 pad rows, output frames of
    the true 854 rows, the checks of 5, K1 once a frame, K2 once a band a
    chunk solve, K5 once a pair;
16. the banded dense stage (flow off, 5 frames), card vs CPU (boundary F);
17. one 480x854 chunk on the card solved in 2 bands and, with
    max_solve_voxels raised, in one band: boundary F between them, and
    the chunk_solve seconds and peak memory of both;
18. checkpoint kill-and-resume on the card over the 31-frame 272x480 clip
    (dense and region stage, flow off), bitwise against the straight run;
19. tools/seg_tree on the card, 272x480, flow on (its defaults): the
    first 21 frames of the clip written to an MJPG .avi, then
    seg_tree.main with --use_pipeline and with --no-use_pipeline: the run
    finishes with 21 frames, 21 frames in the .pb, every pixel labelled,
    a hierarchy on each set start, one stage of each kind, every stage on
    the card, launch counts exact (K1 21, K2 2, K5 four batches of pairs);
    then both modes again under deterministic algorithms: launches exact,
    the two .pb files equal;
20. the same at 480x854 (2 bands and 10 pad rows), both modes, over 11
    frames: K1 11, K2 2;
21. seg_tree --no-flow against segment_frames(use_flow=False) over the
    same decoded 31 frames (level-0 boundary F), and once with
    --solver_param st_levels=3 --solver_param preseg_pair_merge=1 (K3
    launches exact);
22. kill and resume through the CLI on the card, flow read from the .flow
    cache: the restored buffer on the card, the appended .pb equal to the
    straight cached run's;
23. the offline tools on the .pb just written: converter --mode
    bitmap_ids round-trips frame 0's id image, renderer and viewer --dump
    write files;
24. the fused batch: BatchDenseSegmentation over two different 21-frame
    clips, flow off, async tails, each clip equal to its standalone run
    with the synchronous tail (K1 42, K2 4); then batch_segment
    sequential, --fused and --concurrent 2 over the same clips as .avi
    files: every frame segmented, launches exact;
25. the off-default knobs, each a 21-frame 272x480 path with the full
    hierarchy, flow off, launch counts exact: the variance descriptor and
    the gradient trait (K1 21, K2 2), the gradient trait with st_levels=3
    and fine presegs (K3 0: the masked rounds, as the JAX package's gate),
    the two-stage solve, the gradient trait at 480x854 (2 bands: K2 4),
    windowed appearance (window 10: tables non-empty); the three dense
    knobs card vs CPU over 5 frames (boundary F); a windowed kill and
    resume over 30 frames (bitwise); seg_tree --solver_param
    gradient_trait=1 --region_param appearance_window_size=10
    --region_param save_descriptors=1 (one RegionFeatures per region on
    hierarchy frames);
26. no module of the JAX package (video_segment_tpu) and no jax was
    imported (checked at the end, after phase 31);
27. the v1 pixel solver (OversegParams(edge_table=False)): one flood chunk
    at the default compact table (the overflow it leaves); SegmentStream
    over the 31-frame 272x480 clip, flow off, full hierarchy, with the
    felz presegs at ingest (K1 31, K2 0, K3 0, K4 0) and in flood mode (K4
    once a chunk solve, at the force-merge weight; no other kernel), the
    flow path over 21 frames, the felz v1 dense stage card vs CPU over 5
    frames (boundary F), and seg_tree --no-flow --solver_param
    edge_table=0 over 21 frames (K1 21, K2 0);
28. the device mesh (parallel/mesh.py): make_mesh() over the machine's
    cards (one line says so where there is one card: transfers between
    cards are then not exercised); a (1,4) mesh of cuda:0 whose
    DenseSegmentation stream over 21 frames of the 272x480 clip equals
    solver_bands=4 id image for id image (K1 21, K2 8 = 4 bands x 2
    chunk solves); sharded_oversegment on a (2,2) mesh of cuda:0 against
    the single-device banded solve (K2 4); sharded_presmooth (bilateral)
    against the filter; fused_oversegment over 2 clips against each
    clip's solve; dryrun_multichip(4); then a (1,2) mesh of cuda:0 and the
    CPU, so that every transfer is real: the stream and
    sharded_chunk_solver raise no device mismatch, return on cuda:0, each
    band's outputs equal a single-device band phase on that band's device
    (band 1 on the CPU, the plain K2), the glued labels reach boundary F
    >= 0.9 against a mesh of cuda:0 alone, and halo_exchange_rows and
    sharded_presmooth equal the single-device versions;
29. bench config 4's steady state: the 140-frame clip upscaled to
    720x1280 as bench.py upscales its clip, through
    api.segment_frames(use_flow=False) with the dense stage's async tail,
    each SegFrame written to a .pb as api.segment_video writes it: 3 bands
    and 16 pad rows, 8 chunk solves, K1 140 and K2 24 exactly, 140 frames
    in order in the .pb read back; a full chunk set of chunks 0-5, then
    the flush set of chunks 4-7 under the first set's overlap constraints,
    with the seam property at every level; the peak memory and where it
    was reached; per chunk solve its seeds per band, glued table and
    constraint ids, per chunk set (host counts, no sync added) the
    over-segmentation regions, rcap, the bytes of one (rcap, 4000) table
    and whether rcap * 4000 >= 2^31 (where the JAX package stops, R10);
    the dense stage in 3 forced bands card vs CPU over 5 frames (boundary
    F); K1 per padded frame and K2 per band at this geometry against their
    plain versions, with times and bounds;
30. bench config 5: two 21-frame clips (seeds 0 and 1; the bench runs 40)
    upscaled to 1080x1920; BatchDenseSegmentation over both, each clip
    equal to its standalone run at the halved budget the batch gives it
    (bands, launch counts exact); then batch_segment --fused --no-flow
    over both clips as MJPG .avi files and the renderer at render level
    0.1 on each .pb: launch counts exact, each .pb read back with a
    hierarchy, each video non-empty, the peak memory; K1 and K2 at this
    geometry as in 29;
31. the region stage's streaming steady state at 272x480: segment_frames
    with its defaults, flow off, over 140 frames (8 chunk solves): the
    checks of 5, K1 140, K2 8, K3 0, K4 0; the dense buffer within
    chunk_size + 1 frames; a full chunk set of chunks 0-5, then the flush
    set of chunks 4-7 under the first set's constraints; the seam
    property (overlap regions that shared a level-l id in one set share
    one at level l in the next, at every level) and level-0 ids shared
    across the seam; the peak memory and where it was reached.  The same
    API across seams on the card against the CPU is the cuda test
    tests/test_torch_region_continuity.py::test_seams_card_vs_cpu_on_card;
32. (run after phase 4) K6, the bilateral presmoothing filter
    (csrc/bilateral.cu), equals the eager body (bilateral_filter_plain on
    the same CUDA tensors) bit for bit on a textured 8-frame 272x480 batch
    and a 480x854 frame, one launch a frame; its time a frame at both
    sizes (launches back to back) against its bound, the eager body's
    time, and its resource line.
Phases 19-23, 24's batch_segment runs, 25's and 27's seg_tree runs, 29
and 30 decode or resize with cv2 and write with protobuf; where either is
missing one line names it and the phases left out.
Then a JSON line of per-kernel results (time, launches on each path,
bound, plain and library times), the card's name and power limit from
nvidia-smi, and the final {"ok": true, ...} line.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from bench_port import generator, roofline
from bench_port.generator import synthetic_clip

H, W = 272, 480
BH, BW = 854, 480    # the banded path: bench config 3's geometry
N_FRAMES = 60
N_PATH_FRAMES = 31   # the flood, supertile, flow and banded paths: 2 solves
N_SHORT_FRAMES = 21  # seg_tree at 480x854, the deterministic pair: 2 solves
C4_W, C4_H = 720, 1280    # bench config 4 (bench.py's scale_to)
C5_W, C5_H = 1080, 1920   # bench config 5
N_LONG_FRAMES = 140       # 8 chunk solves: a full chunk set, then a seam
KERNELS = ("tile_felz", "tile_extract", "tile_preseg", "tile_table", "tvl1",
           "bilateral")
_START = time.monotonic()


def log(phase: str, msg: str) -> None:
    print(f"[{time.monotonic() - _START:7.1f}s {phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds of fn() on the card (CUDA events, after warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_cycles_per_ms = None


def device_ms(fn, iters: int) -> float:
    """Mean milliseconds of fn() on the card with its launches back to
    back: every call is queued behind a sleep kernel before the first one
    runs.  `cuda_ms` times calls as the host issues them, so a kernel that
    is shorter than its wrapper's host work reads as the host's time."""
    global _cycles_per_ms
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if _cycles_per_ms is None:
        torch.cuda._sleep(1000)
        start.record()
        torch.cuda._sleep(10 ** 7)
        end.record()
        torch.cuda.synchronize()
        _cycles_per_ms = 10 ** 7 / start.elapsed_time(end)
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    # Twice the host's time to issue the calls, plus 5 ms.
    torch.cuda._sleep(int((2 * host_ms + 5) * _cycles_per_ms))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def textured(rng, shape, sigma):
    import scipy.ndimage as ndi
    vol = rng.random(shape + (3,)).astype(np.float32)
    return ndi.gaussian_filter(vol, (0, sigma, sigma, 0)).astype(np.float32)


def expected_chunk_solves(n_frames: int, chunk_size: int) -> int:
    return len(generator.chunk_solves(n_frames, chunk_size))


def boundary_f(a: np.ndarray, b: np.ndarray, tol: int = 2) -> float:
    """Boundary F-measure of two (T,H,W) label stacks (boundary pixels
    match within a (2*tol+1)^2 window)."""
    def bmap(x):
        x = torch.as_tensor(x)
        m = torch.zeros(x.shape, dtype=torch.bool)
        m[:, :, :-1] |= x[:, :, 1:] != x[:, :, :-1]
        m[:, :-1, :] |= x[:, 1:, :] != x[:, :-1, :]
        return m

    def dilate(m):
        return torch.nn.functional.max_pool2d(
            m[:, None].float(), 2 * tol + 1, 1, tol)[:, 0] > 0

    ba, bb = bmap(a), bmap(b)
    prec = float((ba & dilate(bb)).sum()) / max(float(ba.sum()), 1.0)
    rec = float((bb & dilate(ba)).sum()) / max(float(bb.sum()), 1.0)
    return 2 * prec * rec / max(prec + rec, 1e-12)


def rasterize(frames_out) -> np.ndarray:
    from video_segment_tpu_torch.core.region import rasterize_ids
    return np.stack([rasterize_ids(
        sf.region_ids, sf.interval_counts,
        np.stack([sf.ys, sf.lxs, sf.rxs], axis=1), sf.frame_height,
        sf.frame_width) for sf in frames_out])


def check_stream(out, stream, n_frames: int) -> list:
    """The output checks of a full-pipeline run: ordered frames, full
    coverage, ascending ids, parent links, the protocol's chunk-solve
    count.  Returns the SegFrames that carry a chunk set's hierarchy."""
    n_solves = expected_chunk_solves(n_frames, 20)
    if [sf.frame_index for sf in out] != list(range(n_frames)):
        raise AssertionError("frames missing or out of order")
    img = rasterize(out)
    if (img < 0).any():
        raise AssertionError("unlabelled pixels in the output")
    for sf in out:
        if not np.all(np.diff(sf.region_ids) > 0):
            raise AssertionError(f"region ids not ascending, frame "
                                 f"{sf.frame_index}")
    sets = [sf for sf in out if sf.hierarchy is not None]
    if not sets:
        raise AssertionError("no hierarchy emitted")
    for sf in sets:
        hier = sf.hierarchy
        if len(hier) < 2:
            raise AssertionError(f"set at frame {sf.frame_index}: "
                                 f"{len(hier)} hierarchy levels")
        for lo, hi in zip(hier, hier[1:]):
            if lo.parent_ids is None or not np.isin(lo.parent_ids,
                                                    hi.ids).all():
                raise AssertionError("parent links point outside the next "
                                     "level")
        if not np.isin(sf.region_ids, hier[0].ids).all():
            raise AssertionError("frame regions missing from level 0")
    if len(stream.solve_diag) != n_solves:
        raise AssertionError(f"{len(stream.solve_diag)} chunk solves, "
                             f"protocol says {n_solves}")
    return sets


def bound(nbytes: float, ops: dict) -> tuple:
    """(`roofline.least_seconds` in ms, the limit that sets it: "bytes"
    or "operations")."""
    ms = 1e3 * roofline.least_seconds(nbytes, ops)
    by_bytes = 1e3 * roofline.least_seconds(nbytes, {})
    return ms, "bytes" if ms == by_bytes else "operations"


def resource_line(name: str, ctas: int) -> str:
    from video_segment_tpu_torch import _build
    r = _build.resources(name)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    waves = -(-ctas // max(r["ctas_per_sm"] * sms, 1))
    return (f"{name}: {r['registers']} registers, {r['local_bytes']} local "
            f"(spill) bytes a thread, {r['static_smem'] + r['dynamic_smem']}"
            f" B shared memory and {r['threads']} threads a CTA, "
            f"{r['ctas_per_sm']} CTAs per SM (occupancy API); main-path grid "
            f"{ctas} CTAs on {sms} SMs = {waves} wave(s)")


def k1_bound(vol: torch.Tensor, kw: dict) -> tuple:
    """K1's bound on one volume: 12 bytes read and 24 written per pixel;
    10 float32 operations per in-tile edge for the buckets, and 8 float64
    operations per merge test that this volume's labels leave, counted
    scan by scan in the plain version."""
    from video_segment_tpu_torch.ops import tile_felz as tf
    t, h, w, _ = vol.shape
    inb = tf._to_tiles(torch.ones((t, h, w), dtype=torch.bool,
                                  device=vol.device), fill=False)
    nbr, inside = tf._neighbors(vol.device)
    n_edges = sum(int((inb & inb[:, nbr[k]] & inside[k][None]).sum())
                  for k in range(len(tf.DIRS)))
    tests = []
    tf.tile_felzenszwalb_plain(vol, **kw, gate_tests=tests)
    return bound(36 * t * h * w, {"f32": 10 * n_edges, "f64": 8 * sum(tests)})


def reset_launches(*wrappers) -> None:
    for fn in wrappers:
        fn.launches = 0


def run_stream(stream, dev) -> tuple:
    """Drain a SegmentStream on the card: (frames, peak bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    out = list(stream)
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated(dev)


def path_summary(out, stream, peak, sets) -> str:
    rounds = [int(d[:, 1].sum()) for d in stream.solve_diag]
    return (f"{len(out)} frames {out[0].frame_width}x{out[0].frame_height}"
            f"; chunk solves {len(stream.solve_diag)} (merge rounds "
            f"{rounds}; live regions after each level "
            f"{[d[:, 2].tolist() for d in stream.solve_diag]}); peak device "
            f"memory {peak / 2**20:.1f} MiB; regions per level "
            f"{[[len(lv.ids) for lv in sf.hierarchy] for sf in sets]}")


def dense_level0(frames, options, params, device, flows=None) -> np.ndarray:
    """Level-0 label images of the dense stage (one flush chunk), fed the
    per-frame host flow arrays `flows` (None for the first) if given."""
    from video_segment_tpu_torch.core import dense
    h, w = frames[0].shape[:2]
    ds = dense.DenseSegmentation(options, w, h, solver_params=params,
                                 device=device)
    res = []
    for i, fr in enumerate(frames):
        res += ds.process_frame(False, fr, None if flows is None
                                else flows[i])
    res += ds.process_frame(True)
    return rasterize(res)


def dense_card_vs_cpu(frames, options, params=None, flows=None) -> tuple:
    """The dense stage on the card and on the CPU: (boundary F, regions
    per device, the card's level-0 images)."""
    level0 = {name: dense_level0(frames, options, params, name, flows)
              for name in ("cuda", "cpu")}
    fm = boundary_f(level0["cuda"], level0["cpu"])
    return (fm, {k: int(len(np.unique(v))) for k, v in level0.items()},
            level0["cuda"])


def quantized_tables(rng, n, sr, k):
    """Random K3 inputs whose statistics are exact in float32 (colours
    multiples of 1/64, integer sizes), identity labels."""
    s = sr * 128
    shape = (n, sr, 128)
    size = rng.integers(1, 5, shape).astype(np.float32)
    cols = [rng.integers(0, 65, shape).astype(np.float32) / 64.0 * size
            for _ in range(3)]
    fin = np.where(rng.random(shape) < 0.2, rng.integers(0, 256, shape),
                   2048).astype(np.int32)
    blocked = (rng.random(shape) < 0.05).astype(np.int32)
    ptn = rng.integers(0, s, (n, k, sr, 128))
    bkt = rng.integers(0, 300, (n, k, sr, 128))
    edges = np.where(rng.random((n, k, sr, 128)) < 0.3, 2 ** 31 - 1,
                     (bkt << 12) | ptn).astype(np.int32)
    labr = np.broadcast_to(np.arange(sr, dtype=np.int32)[None, :, None],
                           shape)
    labc = np.broadcast_to(np.arange(128, dtype=np.int32)[None, None],
                           shape)
    return dict(labr=labr, labc=labc, size=size, c0=cols[0], c1=cols[1],
                c2=cols[2], fin=fin, blocked=blocked, edges=edges)


def write_avi(path: str, frames, fps: float = 25.0) -> str:
    """BGR uint8 frames -> an MJPG .avi (lossy: compare decoded frames)."""
    import cv2
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), fps, (w, h))
    for fr in frames:
        vw.write(fr)
    vw.release()
    return path


@contextlib.contextmanager
def recorded_stages():
    """Every stage object the port's entry points build inside the block,
    by kind, so that a CLI run can be asked where its stages ran."""
    from video_segment_tpu_torch.core import batch, dense, flow, region
    made = {"dense": [], "region": [], "flow": [], "batch": []}
    modules = {"dense": (dense, "DenseSegmentation"),
               "region": (region, "RegionSegmentation"),
               "flow": (flow, "FlowEngine"),
               "batch": (batch, "BatchDenseSegmentation")}
    saved = {kind: getattr(mod, name) for kind, (mod, name) in modules.items()}

    def recording(cls, kind):
        class Recorded(cls):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                made[kind].append(self)
        return Recorded

    for kind, (mod, name) in modules.items():
        setattr(mod, name, recording(saved[kind], kind))
    try:
        yield made
    finally:
        for kind, (mod, name) in modules.items():
            setattr(mod, name, saved[kind])


def kernel_wrappers() -> tuple:
    """The four kernel wrappers, in the order K1, K2, K4, K3."""
    from video_segment_tpu_torch.ops import (tile_extract, tile_felz,
                                             tile_preseg, tile_table)
    return (tile_felz.tile_felzenszwalb, tile_extract.tile_reduce_min,
            tile_preseg.tile_presegment, tile_table.tile_table_rounds)


def launch_counts() -> tuple:
    """(K1, K2, K4, K3) launch counters."""
    return tuple(fn.launches for fn in kernel_wrappers())


def run_cli(main_fn, argv, want_counts=None) -> dict:
    """One CLI run on the card with the launch counters set to 0 just
    before it and read just after: exit code 0, every stage it built on the
    card, and K1 and K2 launched, or exactly `want_counts` = (K1, K2, K4,
    K3) where given.  Returns its printed text, peak memory, counts, K5's
    launches (`k5`) and stages."""
    from video_segment_tpu_torch.ops import tvl1 as tvl1_ops
    reset_launches(*kernel_wrappers(), tvl1_ops.tvl1_scale)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    text = io.StringIO()
    with recorded_stages() as made, contextlib.redirect_stdout(text):
        rc = main_fn(argv)
    torch.cuda.synchronize()
    counts = launch_counts()
    if rc != 0:
        raise AssertionError(f"{argv}: exit code {rc}\n{text.getvalue()}")
    stages = [st for kind in ("dense", "region", "flow", "batch")
              for st in made[kind]]
    if not made["dense"] and not made["batch"]:
        raise AssertionError(f"{argv}: no dense stage was built")
    for st in stages:
        if st.device.type != "cuda":
            raise AssertionError(f"{argv}: {type(st).__name__} was built on "
                                 f"{st.device}")
    if want_counts is None and (counts[0] == 0 or counts[1] == 0):
        raise AssertionError(f"{argv}: launches K1/K2/K4/K3 {counts}")
    if want_counts is not None and counts != want_counts:
        raise AssertionError(f"{argv}: launches K1/K2/K4/K3 {counts}, want "
                             f"{want_counts}")
    return dict(text=text.getvalue(), counts=counts, made=made,
                peak=torch.cuda.max_memory_allocated(),
                k5=tvl1_ops.tvl1_scale.launches)


def read_pb(path: str) -> tuple:
    """(level-0 id images (T,H,W), frames that carry a hierarchy) of a .pb
    stream, with the stream's own checks: every pixel labelled, and each
    frame's hierarchy_frame_idx pointing at a frame that carries one."""
    from video_segment_tpu_torch import proto
    from video_segment_tpu_torch.dataio import seg_io
    from video_segment_tpu_torch.segment_util import util
    reader = seg_io.SegmentationReader(path)
    if not reader.open_and_read_headers():
        raise AssertionError(f"cannot open {path}")
    imgs, with_hier, ptrs = [], [], []
    for idx, payload in enumerate(reader):
        desc = proto.SegmentationDesc()
        desc.ParseFromString(payload)
        if len(desc.hierarchy):
            with_hier.append(idx)
            if len(desc.hierarchy) < 2:
                raise AssertionError(f"{path}: frame {idx} carries "
                                     f"{len(desc.hierarchy)} levels")
        ptrs.append(desc.hierarchy_frame_idx)
        imgs.append(util.desc_to_id_image(desc))
    reader.close()
    imgs = np.stack(imgs)
    if (imgs < 0).any():
        raise AssertionError(f"{path}: unlabelled pixels")
    if not with_hier or with_hier[0] != 0 or \
            not set(ptrs) <= set(with_hier):
        raise AssertionError(f"{path}: hierarchies at {with_hier}, frames "
                             f"point at {sorted(set(ptrs))}")
    return imgs, with_hier


def seg_tree_summary(run: dict) -> str:
    """seg_tree's run finished (its last marker) over the frames it says;
    the launch counts and peak memory."""
    m = re.search(r"Processed (\d+) frames", run["text"])
    if m is None or "__SEGMENTATION_FINISHED__" not in run["text"]:
        raise AssertionError(f"seg_tree did not finish:\n{run['text']}")
    return (f"{m.group(1)} frames; peak device memory "
            f"{run['peak'] / 2**20:.1f} MiB; launches K1/K2/K4/K3 "
            f"{run['counts']}")


@contextlib.contextmanager
def deterministic():
    """Float atomics make a sum's last bit depend on the launch's schedule;
    bitwise comparisons run both sides with deterministic kernels."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            yield
    finally:
        torch.use_deterministic_algorithms(False)


def file_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def upscale(frames, w: int, h: int) -> list:
    """Frames resized to w x h as bench.py resizes its clip (bicubic)."""
    import cv2
    return [cv2.resize(f, (w, h), interpolation=cv2.INTER_CUBIC)
            for f in frames]


@contextlib.contextmanager
def size_records():
    """The sizes that bound configs 4 and 5, recorded inside the block:
    per chunk solve of every DenseSegmentation, its temporal extent,
    bands, each band's seed count, the size of its edge table (the glued
    global table of a banded solve, which `_MAX_TABLE` bounds) and its
    constraint ids (which `max_constraints` bounds); per chunk set of
    every RegionSegmentation, its over-segmentation regions and the rows
    of the dense tables `agglomerate` holds on the device (the next power
    of two: (rows, bins) float32 colour histograms) and of its edge list.
    Each record also holds the device's peak allocation after the call
    where the call raised it (None where it did not): where the run's
    peak memory was reached.  The seed counts sync the host once a
    solve."""
    from video_segment_tpu_torch.core import agglomeration
    from video_segment_tpu_torch.core import oversegmentation as ov
    from video_segment_tpu_torch.core.dense import DenseSegmentation
    rec = {"solves": [], "sets": []}
    saved = DenseSegmentation._dispatch_solve, agglomeration.agglomerate

    def peak_raised(fn, *args, **kw):
        before = torch.cuda.max_memory_allocated()
        out = fn(*args, **kw)
        after = torch.cuda.max_memory_allocated()
        return out, (after / 2**20 if after > before else None)

    def recording(self, prep):
        p = prep["params"]
        t, hp, w = prep["t_solve"], prep["hp"], self.frame_width
        init = prep["init_label"].reshape(-1)
        roots = init == torch.arange(init.numel(), dtype=init.dtype,
                                     device=init.device)
        seeds = roots.reshape(t, p.bands, hp // p.bands, w).sum(
            dim=(0, 2, 3)).tolist()
        table = (ov._banded_dims(t, hp, w, p)[5] if p.bands > 1 else
                 ov._table_cap(p, t * hp * w, hp, w,
                               prep["constraints"] is not None) + 1)
        res, peak = peak_raised(saved[0], self, prep)
        rec["solves"].append(dict(t_solve=t, bands=p.bands, seeds=seeds,
                                  table=table,
                                  constraints=len(prep["cid_to_gid"]),
                                  peak=peak))
        return res

    def agglomerate(hist, flow_hist, flow_cnt, sizes, edges, num_regions,
                    **kw):
        out, peak = peak_raised(saved[1], hist, flow_hist, flow_cnt, sizes,
                                edges, num_regions, **kw)
        rec["sets"].append(dict(regions=num_regions, rows=hist.shape[0],
                                bins=hist.shape[1], edge_rows=len(edges),
                                peak=peak))
        return out

    DenseSegmentation._dispatch_solve = recording
    agglomeration.agglomerate = agglomerate
    try:
        yield rec
    finally:
        DenseSegmentation._dispatch_solve, agglomeration.agglomerate = saved


def size_summary(rec) -> str:
    from video_segment_tpu_torch.core import oversegmentation as ov
    limit = ov.OversegParams().max_constraints

    def peak(r):
        return ("" if r["peak"] is None else
                f"; the device's peak rose to {r['peak']:.1f} MiB in it")

    return "; ".join(
        [f"solve {i} (t_solve {r['t_solve']}, {r['bands']} bands): seeds per "
         f"band {r['seeds']}, table {r['table']} of {ov._MAX_TABLE} "
         f"({'22' if r['table'] > 1 << 20 else '20'}-bit partners), "
         f"constraint ids {r['constraints']} of {limit}{peak(r)}"
         for i, r in enumerate(rec["solves"])]
        + [f"chunk set {i}: {r['regions']} over-segmentation regions, "
           f"agglomerate's tables {r['rows']} rows ({r['rows']} x "
           f"{r['bins']} float32 = {r['rows'] * r['bins'] * 4 / 2**30:.2f} GiB"
           f" a histogram table), {r['edge_rows']} edge rows{peak(r)}"
           for i, r in enumerate(rec["sets"])])


@contextlib.contextmanager
def set_records(cls=None):
    """Every chunk set that a RegionSegmentation of class `cls` (the
    port's by default; any class with the same `_process_set` and
    `_inherit_ids`) processes inside the block, in order, from host data
    alone: no device sync is added.  Per set: its chunk count, whether it
    was the flush set, whether the previous set's overlap constrained it,
    its over-segmentation gids (sorted) and each one's id at every
    hierarchy level, the overlap assignment (`_prev_assign`) it leaves for
    the next set, and `rows`, the (rows, bins) table height of
    `agglomerate`, from the stage's `region.regions` counter where it has
    a `trace` (the port's).  On a card also the allocator's peak where the
    set raised it (`peak_mib`, None where it did not)."""
    from video_segment_tpu_torch.core import region
    if cls is None:
        cls = region.RegionSegmentation
    rec = []
    saved = cls._process_set, cls._inherit_ids

    def inherit(self, levels_raw, level_ids, all_gids, sizes, r):
        out = saved[1](self, levels_raw, level_ids, all_gids, sizes, r)
        rec.append(dict(
            gids=np.asarray(all_gids).copy(),
            ids=[np.asarray(out[lv])[np.asarray(lab)[:r]]
                 for lv, lab in enumerate(levels_raw)],
            constrained=bool(getattr(self, "_prev_assign", None))))
        return out

    def process(self, chunks, emit_all):
        dev = getattr(self, "device", None)
        on_card = isinstance(dev, torch.device) and dev.type == "cuda"
        before = torch.cuda.max_memory_allocated(dev) if on_card else None
        trace = getattr(self, "trace", None)
        if trace is not None:
            cnt0 = trace.counters.get("region.regions", 0)
        res = saved[0](self, chunks, emit_all)
        r = rec[-1]
        regions = len(r["gids"]) if trace is None else \
            trace.counters.get("region.regions", 0) - cnt0
        r.update(chunks=len(chunks), flush=emit_all,
                 rows=region._next_pow2(regions + 1),
                 bins=self.num_color_bins,
                 prev_assign=[(np.asarray(pg).copy(), np.asarray(pid).copy())
                              for pg, pid in self._prev_assign])
        if on_card:
            after = torch.cuda.max_memory_allocated(dev)
            r["peak_mib"] = after / 2**20 if after > before else None
        return res

    cls._process_set, cls._inherit_ids = process, inherit
    try:
        yield rec
    finally:
        cls._process_set, cls._inherit_ids = saved


def seam_check(sets) -> list:
    """The seam property of consecutive chunk sets (what the JAX package's
    `test_moving_scene_composition_stable_across_seams` asserts, held here
    over every region of the next set): overlap regions that shared a
    level-l id in set k share one id at level l in set k+1, at every level
    that set k assigned and set k+1 has.  `sets` as `set_records` gives
    them.  Raises on a split group; returns per seam the groups checked
    per level and the share of set k+1's level-0 ids that set k also
    had."""
    seams = []
    for k, (a, b) in enumerate(zip(sets, sets[1:])):
        if a["flush"] or not a["prev_assign"] or not b["constrained"]:
            raise AssertionError(f"set {k + 1} follows a set that left no "
                                 f"overlap assignment")
        groups = []
        for lv, (pg, pid) in enumerate(a["prev_assign"][:len(b["ids"])]):
            pos = np.minimum(np.searchsorted(b["gids"], pg),
                             len(b["gids"]) - 1)
            if not np.array_equal(b["gids"][pos], pg):
                raise AssertionError(f"seam {k}: overlap regions missing "
                                     f"from set {k + 1}")
            pairs = np.unique(np.stack([pid, b["ids"][lv][pos]], 1), axis=0)
            n_ids = np.unique(pairs[:, 0], return_counts=True)[1]
            n_groups = len(n_ids)
            if (n_ids > 1).any():
                raise AssertionError(
                    f"seam {k}, level {lv}: {int((n_ids > 1).sum())} of "
                    f"{n_groups} overlap groups split across the sets")
            groups.append(n_groups)
        ids0_a, ids0_b = np.unique(a["ids"][0]), np.unique(b["ids"][0])
        seams.append(dict(levels=len(groups), groups=groups,
                          share0=len(np.intersect1d(ids0_a, ids0_b))
                          / max(len(ids0_b), 1)))
    return seams


def set_summary(sets) -> str:
    """One clause per chunk set of `set_records`: chunks, regions, table
    rows and bytes, the R10 flag and where the peak rose."""
    out = []
    for i, r in enumerate(sets):
        nbytes = r["rows"] * r["bins"] * 4
        msg = (f"set {i} ({r['chunks']} chunks, "
               f"{'flush' if r['flush'] else 'mid-stream'}"
               f"{', constrained' if r['constrained'] else ''}): "
               f"{len(r['gids'])} over-segmentation regions, rcap "
               f"{r['rows']}, a ({r['rows']}, {r['bins']}) float32 table "
               f"{nbytes} B = {nbytes / 2**30:.2f} GiB, rcap * bins >= 2^31 "
               f"(R10: the JAX package stops) {r['rows'] * r['bins'] >= 2**31}"
               f", {len(r['ids'])} levels")
        if r.get("peak_mib") is not None:
            msg += f"; the device's peak rose to {r['peak_mib']:.1f} MiB"
        out.append(msg)
    return "; ".join(out)


def seam_summary(seams) -> str:
    return "; ".join(
        f"seam {k}: {s['levels']} levels held, overlap groups per level "
        f"{s['groups']}, level-0 id overlap {100 * s['share0']:.1f}%"
        for k, s in enumerate(seams))


def k1_case(vol: torch.Tensor, k1_kw: dict) -> dict:
    """K1 against its plain version on `vol` (bit for bit), and its time
    (launches back to back) and bound there."""
    from video_segment_tpu_torch.ops import tile_felz as tf
    got = tf.tile_felzenszwalb(vol, **k1_kw)
    want = tf.tile_felzenszwalb_plain(vol, **k1_kw)
    for a, b in zip((got[0], got[1], *got[2]), (want[0], want[1], *want[2])):
        if not torch.equal(a, b):
            raise AssertionError(f"K1 differs from its plain version at "
                                 f"{tuple(vol.shape[:3])}")
    b_ms, by = k1_bound(vol, k1_kw)
    return dict(shape=list(vol.shape[:3]),
                ms=device_ms(lambda: tf.tile_felzenszwalb(vol, **k1_kw), 50),
                bound_ms=b_ms, bound_by=by)


def k2_band_case(rng, gen, k1_kw: dict, bh: int, bw: int,
                 t_solve: int = 21) -> dict:
    """K2 against its plain version at one band's shape (13, t_solve, bh,
    bw): K1 labels of textured frames, random packed keys (30% empty).
    Returns the kernel's time (launches back to back), the plain
    version's, and the bound."""
    from video_segment_tpu_torch.core import oversegmentation as ov
    from video_segment_tpu_torch.ops import tile_extract as te
    from video_segment_tpu_torch.ops import tile_felz as tf
    dev = torch.device("cuda", 0)
    lab = tf.tile_felzenszwalb(torch.from_numpy(
        textured(rng, (3, bh, bw), 1.5)).to(dev), **k1_kw)[0]
    lab = torch.cat([lab] * -(-t_solve // 3))[:t_solve]
    yx = lab % (bh * bw)
    labr = ((yx // bw) % tf.TILE_H).to(torch.int32).contiguous()
    labc = (yx % bw % tf.TILE_W).to(torch.int32).contiguous()
    keys = torch.randint(0, 2046 << 20, (13, t_solve, bh, bw), generator=gen,
                         dtype=torch.int32, device=dev)
    keys[torch.rand(keys.shape, generator=gen, device=dev) < 0.3] = \
        ov.I32MAX
    if not torch.equal(te.tile_reduce_min(labr, labc, keys),
                       te.tile_reduce_min_plain(labr, labc, keys)):
        raise AssertionError(f"K2 differs from its plain version at the "
                             f"band shape {tuple(keys.shape)}")
    b_ms, by = bound(2 * keys.numel() * 4 + 2 * labr.numel() * 4,
                     {"i32": keys.numel()})
    return dict(shape=list(keys.shape),
                ms=device_ms(lambda: te.tile_reduce_min(labr, labc, keys),
                             30),
                plain_ms=cuda_ms(
                    lambda: te.tile_reduce_min_plain(labr, labc, keys), 3),
                bound_ms=b_ms, bound_by=by)


def kernel_summary(k1: dict, k2: dict) -> str:
    return (f"K1 per padded frame {tuple(k1['shape'])}: {k1['ms']:.4f} ms, "
            f"equal to its plain version; bound {k1['bound_ms'] * 1e3:.1f} "
            f"us ({k1['bound_by']}); K2 per band {tuple(k2['shape'])}: "
            f"{k2['ms']:.4f} ms, plain {k2['plain_ms']:.4f} ms, equal; bound "
            f"{k2['bound_ms'] * 1e3:.1f} us ({k2['bound_by']}), "
            f"{100 * k2['bound_ms'] / k2['ms']:.1f}% of it")


def cli_phases(tmp, frames_p, frames_b, n_solves, n_st):
    """Phases 19-23: the command-line tools on the card, in `tmp`.
    Returns the launch counts (K1, K2, K4, K3 of the supertile run, K5)
    of seg_tree's pipeline run at 272x480."""
    from video_segment_tpu_torch import api, proto
    from video_segment_tpu_torch.dataio import seg_io, video
    from video_segment_tpu_torch.runtime import checkpoint
    from video_segment_tpu_torch.segment_util import util
    from video_segment_tpu_torch.tools import (converter, renderer, seg_tree,
                                               viewer)
    n = len(frames_p)
    base = ["--write_to_file", "--keep_rasterization", "--max_rate", "0",
            "--no-dynamic_rate"]

    def staged(name, frames=None, cache=None, src=None):
        d = os.path.join(tmp, name)
        os.makedirs(d)
        path = os.path.join(d, "clip.avi")
        if src is not None:
            with open(src, "rb") as fi, open(path, "wb") as fo:
                fo.write(fi.read())
        else:
            write_avi(path, frames)
        if cache is not None:
            with open(cache, "rb") as fi, open(path + ".flow", "wb") as fo:
                fo.write(fi.read())
        return path

    def seg(path, *flags, want=None):
        return run_cli(seg_tree.main, ["--input_file", path, *base, *flags],
                       want)

    # -- 19. seg_tree, 272x480, flow on ------------------------------------
    from video_segment_tpu_torch.core import flow as fl
    want = (n, n_solves, 0, 0)
    master = staged("master", frames_p)
    n_short = N_SHORT_FRAMES
    want_short = (n_short, expected_chunk_solves(n_short, 20), 0, 0)
    # K5: one launch sequence a batch of 6 pairs (the flow engine's), the
    # rest in the flush; the first frame has no flow.
    want_k5 = -(-(n_short - 1) // 6) * fl.kernel_launches(H, W,
                                                           fl.TVL1Params())
    short = staged("short", frames_p[:n_short])
    runs = {}
    for mode in ("--use_pipeline", "--no-use_pipeline"):
        path = staged("run" + mode, src=short)
        runs[mode] = seg(path, mode, want=want_short)
        if runs[mode]["k5"] != want_k5:
            raise AssertionError(f"seg_tree {mode}: K5 launches "
                                 f"{runs[mode]['k5']}, want {want_k5}")
        imgs, hier_at = read_pb(path + ".pb")
        if imgs.shape != (n_short, H, W):
            raise AssertionError(f"seg_tree {mode}: .pb holds {imgs.shape}")
        if f"Processed {n_short} frames" not in runs[mode]["text"]:
            raise AssertionError(f"seg_tree {mode}: {runs[mode]['text']}")
        for kind in ("dense", "region", "flow"):
            if len(runs[mode]["made"][kind]) != 1:
                raise AssertionError(f"seg_tree {mode}: {kind} stages "
                                     f"{runs[mode]['made'][kind]}")
        log("cli", f"seg_tree {mode} {W}x{H} flow on: "
            f"{seg_tree_summary(runs[mode])}; hierarchies at frames "
            f"{hier_at}; {len(np.unique(imgs[0]))} level-0 regions in "
            f"frame 0; K5 launches {runs[mode]['k5']}")
    det = {}
    with deterministic():
        for mode in ("--use_pipeline", "--no-use_pipeline"):
            det[mode] = staged("det" + mode, src=short)
            k5 = seg(det[mode], mode, want=want_short)["k5"]
            if k5 != want_k5:
                raise AssertionError(f"seg_tree {mode}, deterministic: K5 "
                                     f"launches {k5}, want {want_k5}")
    if file_bytes(det["--use_pipeline"] + ".pb") != \
            file_bytes(det["--no-use_pipeline"] + ".pb"):
        raise AssertionError("seg_tree: the pipeline's .pb differs from the "
                             "plain loop's")
    log("cli", "seg_tree under deterministic algorithms: --use_pipeline and "
        "--no-use_pipeline wrote the same "
        f"{os.path.getsize(det['--use_pipeline'] + '.pb')} bytes; launch "
        f"counts exact in both ({want_short}, K5 {want_k5}, {n_short} "
        "frames)")
    cli_counts = list(runs["--use_pipeline"]["counts"])
    cli_counts.append(runs["--use_pipeline"]["k5"])

    # -- 20. seg_tree, 480x854, both modes, 11 frames ----------------------
    n_band = 11
    banded = staged("banded", frames_b[:n_band])
    for mode in ("--use_pipeline", "--no-use_pipeline"):
        path = staged("banded" + mode, src=banded)
        run = seg(path, mode, want=(
            n_band, 2 * expected_chunk_solves(n_band, 20), 0, 0))
        imgs, hier_at = read_pb(path + ".pb")
        if imgs.shape != (n_band, BH, BW):
            raise AssertionError(f"seg_tree banded: .pb holds {imgs.shape}")
        del imgs
        ds = run["made"]["dense"][0]
        if (ds._bands, ds._pad_rows) != (2, 10):
            raise AssertionError(f"seg_tree banded: bands {ds._bands}, pad "
                                 f"rows {ds._pad_rows}")
        log("cli", f"seg_tree {mode} {BW}x{BH} flow on, 2 bands, "
            f"{n_band} frames: "
            f"{seg_tree_summary(run)}; hierarchies at frames {hier_at}")

    # -- 21. seg_tree --no-flow against the API ------------------------------
    path = staged("noflow", src=master)
    run = seg(path, "--no-flow", want=want)
    cli_l0, _ = read_pb(path + ".pb")
    reader = video.VideoReader(path)
    decoded = list(reader)
    reader.close()
    stream = api.segment_frames(iter(decoded), W, H, use_flow=False,
                                device="cuda")
    api_l0 = rasterize(list(stream))
    fm = boundary_f(cli_l0, api_l0)
    log("cli", f"seg_tree --no-flow: {seg_tree_summary(run)}; level 0 "
        f"against segment_frames(use_flow=False) over the same decoded "
        f"frames: boundary F {fm:.4f} (regions {len(np.unique(cli_l0))} vs "
        f"{len(np.unique(api_l0))})")
    if fm < 0.9:
        raise AssertionError(f"seg_tree --no-flow vs the API: boundary F "
                             f"{fm:.4f} < 0.9")
    path = staged("supertile", src=master)
    run = seg(path, "--no-flow", "--solver_param", "st_levels=3",
              "--solver_param", "preseg_pair_merge=1",
              want=(n, n_solves, 0, n_st))
    read_pb(path + ".pb")
    cli_counts[3] = run["counts"][3]
    log("cli", f"seg_tree --no-flow --solver_param st_levels=3 "
        f"--solver_param preseg_pair_merge=1: {seg_tree_summary(run)}")

    # -- 22. kill and resume through the CLI, flow from the cache ----------
    ck = ["--no-use_pipeline", "--checkpoint_every", "1"]
    # The cache comes from a run of its own: --save_flow downloads every
    # field as exact float32, which the host consumers are then served in
    # place of the batch's float16 copy, so a saving run's output is not a
    # plain run's.
    saver = staged("saver", src=master)
    seg(saver, "--over_segment", "--save_flow", want=want)
    cache = saver + ".flow"
    with deterministic():
        straight = staged("straight", src=master, cache=cache)
        seg(straight, *ck, "--checkpoint_path",
            os.path.join(tmp, "straight.ckpt"), want=want)
        killed = staged("killed", src=master, cache=cache)
        ckpt = os.path.join(tmp, "killed.ckpt")
        seg(killed, *ck, "--checkpoint_path", ckpt, "--trim_to", "25")
        offset = checkpoint.load_extra(ckpt)["writer_offset"]
        resumed = seg(killed, *ck, "--checkpoint_path", ckpt, "--resume")
    m = re.search(r"resumed from .* at frame (\d+)", resumed["text"])
    if m is None or not 0 < int(m.group(1)) < n:
        raise AssertionError(f"resume: {resumed['text']}")
    if resumed["made"]["dense"][0]._buffer and \
            resumed["made"]["dense"][0]._buffer[0].device.type != "cuda":
        raise AssertionError("resume: buffer restored off the card")
    want_pb = file_bytes(straight + ".pb")
    if file_bytes(killed + ".pb") != want_pb:
        raise AssertionError("seg_tree --resume: the appended .pb differs "
                             "from the straight cached run's")
    log("cli", f"kill and resume through seg_tree, flow from the .flow "
        f"cache: stopped by --trim_to 25, resumed at frame {m.group(1)} "
        f"(writer offset {offset}), appended .pb equals the straight cached "
        f"run's {len(want_pb)} bytes")

    # -- 23. the offline tools ----------------------------------------------
    import cv2
    pb = straight + ".pb"
    ids_dir = os.path.join(tmp, "ids")
    if converter.main([f"--input={pb}", f"--output_dir={ids_dir}",
                       "--mode=bitmap_ids"]) != 0:
        raise AssertionError("converter failed")
    img = cv2.imread(os.path.join(ids_dir, "frame0000.png"))
    ids = (img[..., 0].astype(np.int64) | img[..., 1].astype(np.int64) << 8
           | img[..., 2].astype(np.int64) << 16)
    rd = seg_io.SegmentationReader(pb)
    rd.open_and_read_headers()
    desc = proto.SegmentationDesc()
    desc.ParseFromString(rd.read_frame())
    rd.close()
    if not np.array_equal(ids, util.desc_to_id_image(desc)):
        raise AssertionError("converter: frame 0's id bitmap does not "
                             "round-trip")
    rendered = os.path.join(tmp, "render.mp4")
    sheet = os.path.join(tmp, "sheet.png")
    if renderer.main([f"--input={pb}", f"--output_video={rendered}",
                      "--render_level=0.4"]) != 0 or \
            viewer.main([f"--input={pb}", f"--dump={sheet}"]) != 0:
        raise AssertionError("renderer or viewer failed")
    sizes = {os.path.basename(f): os.path.getsize(f)
             for f in (rendered, sheet)}
    if min(sizes.values()) == 0:
        raise AssertionError(f"offline tools wrote an empty file: {sizes}")
    log("tools", f"converter bitmap_ids round-trips frame 0 "
        f"({len(np.unique(ids))} ids, {len(os.listdir(ids_dir))} PNGs); "
        f"renderer and viewer --dump wrote {sizes} bytes")
    return tuple(cli_counts)


def signature(frames_out) -> list:
    """Everything a run emitted, as comparable bytes."""
    return [(sf.frame_index, sf.region_ids.tobytes(),
             sf.interval_counts.tobytes(), sf.ys.tobytes(),
             sf.lxs.tobytes(), sf.rxs.tobytes(),
             None if sf.hierarchy is None else
             [(lv.ids.tobytes(), np.asarray(lv.sizes).tobytes(),
               None if lv.parent_ids is None
               else np.asarray(lv.parent_ids).tobytes())
              for lv in sf.hierarchy]) for sf in frames_out]


def fused_vs_standalone(clips, phase: str) -> tuple:
    """The fused multi-clip batch (BatchDenseSegmentation, async tails) fed
    from arrays, under deterministic algorithms, each clip against its
    standalone DenseSegmentation (synchronous tail) at the per-clip budget
    the batch gives it (max_solve_voxels // clips, so the same bands):
    RLE and hierarchies equal bit for bit, launches K1 one a frame and K2
    one a band a chunk solve.  Returns (the fused run's launch counts, the
    batch)."""
    from video_segment_tpu_torch import api
    from video_segment_tpu_torch.core import batch, dense
    n, n_clips = len(clips[0]), len(clips)
    h, w = clips[0][0].shape[:2]
    n_solves = expected_chunk_solves(n, 20)
    budget = api.DenseSegmentationOptions().max_solve_voxels // n_clips

    def standalone(clip_frames):
        ds = dense.DenseSegmentation(api.DenseSegmentationOptions(
            max_solve_voxels=budget), w, h, device="cuda")
        res = []
        for fr in clip_frames:
            res += ds.process_frame(False, fr)
        return res + ds.process_frame(True), ds._bands

    with deterministic():
        singles = [standalone(c) for c in clips]
        reset_launches(*kernel_wrappers())
        bd = batch.BatchDenseSegmentation(
            api.DenseSegmentationOptions(async_tail=True), w, h, n_clips,
            device="cuda")
        fused = [[] for _ in clips]
        for step in range(n):
            got = bd.process_frames(False, [c[step] for c in clips])
            for i, sfs in enumerate(got):
                fused[i] += sfs
        for i, sfs in enumerate(bd.process_frames(True)):
            fused[i] += sfs
        torch.cuda.synchronize()
        counts = launch_counts()
    bands = bd.clips[0]._bands
    for i, ds in enumerate(bd.clips):
        if ds.device.type != "cuda":
            raise AssertionError(f"{phase}: a clip ran off the card")
        if len(ds.solve_diag) != n_solves:
            raise AssertionError(f"{phase}: {len(ds.solve_diag)} "
                                 f"solve_diag entries, want {n_solves}")
        if ds._bands != singles[i][1]:
            raise AssertionError(f"{phase}: clip {i} in {ds._bands} bands, "
                                 f"its standalone run in {singles[i][1]}")
        if signature(fused[i]) != signature(singles[i][0]):
            raise AssertionError(f"{phase}: clip {i} differs from its "
                                 "standalone run")
    want = (n_clips * n, n_clips * bands * n_solves, 0, 0)
    if counts != want:
        raise AssertionError(f"{phase}: fused batch launches K1/K2/K4/K3 "
                             f"{counts}, want {want}")
    log(phase, f"{n_clips} clips x {n} frames {w}x{h}, flow off, async "
        f"tails, {bands} band(s) of {(h + bd.clips[0]._pad_rows) // bands} "
        f"rows a clip at the per-clip budget {budget}: each clip's RLE and "
        f"level-0 hierarchy equal its standalone run's bit for bit "
        f"(deterministic algorithms); groups per step {bd.group_sizes}; "
        f"launches K1 {counts[0]} K2 {counts[1]}")
    return counts, bd


def fused_phase(tmp, clips, with_cli) -> tuple:
    """Phase 24: the fused multi-clip batch fed from arrays, each clip
    against its standalone run; then (with cv2 and protobuf) the three
    modes of batch_segment over the same clips as .avi files.  Returns the
    fused run's launch counts."""
    counts, _ = fused_vs_standalone(clips, "fused")
    n = len(clips[0])
    want = (len(clips) * n, len(clips) * expected_chunk_solves(n, 20), 0, 0)
    if with_cli:
        from video_segment_tpu_torch.tools import batch_segment
        vids = [write_avi(os.path.join(tmp, f"clip{i}.avi"), c)
                for i, c in enumerate(clips)]
        for name, mode in (("sequential", []), ("fused", ["--fused"]),
                           ("concurrent 2", ["--concurrent", "2"])):
            run = run_cli(batch_segment.main, [
                *vids, *mode, "--no-flow", "--output_dir",
                os.path.join(tmp, "batch_" + name.replace(" ", ""))], want)
            stats = json.loads(run["text"].strip().splitlines()[-1])
            if stats["frames"] != len(clips) * n:
                raise AssertionError(f"batch_segment {name}: {stats}")
            log("fused", f"batch_segment {name}: {stats['frames']} frames; "
                f"launches K1/K2/K4/K3 {run['counts']}")
    return counts


def knobs_phase(tmp, frames_p, frames_b, with_cli) -> dict:
    """Phase 25: the off-default solver and region knobs on the card, each
    path through the entry points over the first 21 frames with its launch
    counts exact, then the dense knobs card vs CPU, a windowed kill and
    resume over 30 frames, and (with cv2 and protobuf) seg_tree with the
    knob flags over 21 frames.  Returns {path: (K1, K2, K4, K3)
    launches}."""
    from video_segment_tpu_torch import api
    from video_segment_tpu_torch.core import dense, region
    from video_segment_tpu_torch.core import oversegmentation as ov
    from video_segment_tpu_torch.runtime import checkpoint
    dev = torch.device("cuda", 0)
    n = N_SHORT_FRAMES
    n_solves = expected_chunk_solves(n, 20)
    frames_s, frames_bs = frames_p[:n], frames_b[:n]
    variance = ov.OversegParams(descriptor="color_mean_variance",
                                merge_threshold=0.1, split_threshold=0.75)
    gradient = ov.OversegParams(gradient_trait=True)
    gated = ov.OversegParams(gradient_trait=True, st_levels=3,
                             preseg_pair_merge=True)
    two_stage = api.DenseSegmentationOptions(two_stage_oversegment=True)
    windowed = api.RegionSegmentationOptions(use_flow=False,
                                             appearance_window_size=10)
    want = (n, n_solves, 0, 0)
    counts = {}
    paths = (("variance", frames_s, None, variance, None, want),
             ("gradient", frames_s, None, gradient, None, want),
             ("gradient+supertile gate", frames_s, None, gated, None, want),
             ("two-stage", frames_s, two_stage, None, None, want),
             ("gradient banded", frames_bs, None, gradient, None,
              (n, 2 * n_solves, 0, 0)),
             ("windowed", frames_s, None, None, windowed, want))
    for name, frames, dopts, params, ropts, want_c in paths:
        h, w = frames[0].shape[:2]
        reset_launches(*kernel_wrappers())
        stream = api.SegmentStream(
            iter(frames),
            dense.DenseSegmentation(dopts or api.DenseSegmentationOptions(),
                                    w, h, solver_params=params,
                                    device="cuda"),
            region.RegionSegmentation(
                ropts or api.RegionSegmentationOptions(use_flow=False), w, h,
                device="cuda"))
        if name == "windowed":
            seen = []
            orig = stream.region._accumulate_windows

            def recording(chunk, *a, orig=orig, seen=seen):
                orig(chunk, *a)
                seen.append((len(chunk.win_ids),
                             float(chunk.win_cnt.sum())))
            stream.region._accumulate_windows = recording
        out, peak = run_stream(stream, dev)
        counts[name] = launch_counts()
        sets = check_stream(out, stream, n)
        if counts[name] != want_c:
            raise AssertionError(f"{name} path launches K1/K2/K4/K3 "
                                 f"{counts[name]}, want {want_c}")
        if name == "gradient banded" and (stream.dense._bands,
                                          stream.dense._pad_rows) != (2, 10):
            raise AssertionError("gradient banded: not 2 bands, 10 pad rows")
        extra = ""
        if name == "windowed":
            if not seen or min(c for _, c in seen) <= 0:
                raise AssertionError(f"windowed tables empty: {seen}")
            extra = (f"; windows per chunk {[k for k, _ in seen]}, samples "
                     f"{[int(c) for _, c in seen]}")
        log("knobs", f"{name}: {path_summary(out, stream, peak, sets)}"
            f"; launches K1/K2/K4/K3 {counts[name]}{extra}")

    # Dense knobs, card vs CPU (the same port on the same frames).
    for name, options, params in (
            ("variance", api.DenseSegmentationOptions(), variance),
            ("gradient", api.DenseSegmentationOptions(), gradient),
            ("two-stage", two_stage, None)):
        fm, n_reg, _ = dense_card_vs_cpu(frames_p[:5], options, params)
        log("knobs", f"{name}: 5 frames, one flush chunk, card vs CPU: "
            f"boundary F {fm:.4f} (regions {n_reg})")
        if fm < 0.9:
            raise AssertionError(f"{name}: card vs CPU boundary F {fm:.4f} "
                                 "< 0.9")

    # Windowed kill and resume over 30 frames (cut at 25: the first chunk
    # closed, window 2 open), bitwise.
    def stages():
        return (dense.DenseSegmentation(api.DenseSegmentationOptions(), W, H,
                                        device="cuda"),
                region.RegionSegmentation(windowed, W, H, device="cuda"))

    def feed(ds, rs, chunk, start, flush):
        res = []
        for i, fr in enumerate(chunk, start=start):
            rs.add_frame(i, fr)
            res += rs.process_frames(False, ds.process_frame(False, fr))
        if flush:
            res += rs.process_frames(True, ds.process_frame(True))
        return res

    cut, frames_k = 25, frames_p[:30]
    with deterministic():
        straight = feed(*stages(), frames_k, 0, True)
        ds1, rs1 = stages()
        first = feed(ds1, rs1, frames_k[:cut], 0, False)
        path = os.path.join(tmp, "windowed.ckpt")
        checkpoint.save(path, ds1, rs1, frames_consumed=cut)
        if cut // 10 not in rs1._window_anchor or not rs1._frame_means:
            raise AssertionError("windowed checkpoint: no window state")
        del ds1, rs1
        ds2, rs2 = stages()
        checkpoint.restore(path, ds2, rs2)
        resumed = first + feed(ds2, rs2, frames_k[cut:], cut, True)
    if signature(resumed) != signature(straight):
        raise AssertionError("windowed checkpoint: the resumed run differs")
    log("knobs", f"windowed kill and resume, {len(frames_k)} frames: "
        f"killed after frame {cut} "
        f"(window {cut // 10} open, checkpoint "
        f"{os.path.getsize(path) / 2**20:.1f} MiB), resumed run equals the "
        "straight run bit for bit")

    if with_cli:
        from video_segment_tpu_torch import proto
        from video_segment_tpu_torch.dataio import seg_io
        from video_segment_tpu_torch.tools import seg_tree
        clip = write_avi(os.path.join(tmp, "knobs.avi"), frames_s)
        run = run_cli(seg_tree.main, [
            "--input_file", clip, "--no-flow", "--write_to_file",
            "--max_rate", "0", "--no-dynamic_rate", "--solver_param",
            "gradient_trait=1", "--region_param", "appearance_window_size=10",
            "--region_param", "save_descriptors=1"], want)
        counts["seg_tree"] = run["counts"]
        read_pb(clip + ".pb")
        reader = seg_io.SegmentationReader(clip + ".pb")
        reader.open_and_read_headers()
        n_feat = []
        for payload in reader:
            desc = proto.SegmentationDesc()
            desc.ParseFromString(payload)
            if len(desc.hierarchy):
                if [f.id for f in desc.features] != \
                        [r.id for r in desc.region]:
                    raise AssertionError("save_descriptors: a hierarchy "
                                         "frame's features do not match its "
                                         "regions")
                n_feat.append(len(desc.features))
        reader.close()
        if not n_feat:
            raise AssertionError("save_descriptors: no hierarchy frame")
        log("knobs", f"seg_tree --no-flow --solver_param gradient_trait=1 "
            f"--region_param appearance_window_size=10 --region_param "
            f"save_descriptors=1: {seg_tree_summary(run)}; RegionFeatures "
            f"per hierarchy frame {n_feat}, one per region")
    return counts


def v1_phase(tmp, frames_p, with_cli) -> dict:
    """Phase 27: the v1 pixel solver (OversegParams(edge_table=False)) on
    the card: the felz path (31 frames, flow off, K1 once a frame and no
    other kernel), the flood path (K4 once a chunk solve, no other
    kernel), the flow path over 21 frames, the felz v1 dense stage card vs
    CPU over 5 frames (boundary F), and (with cv2 and protobuf) seg_tree
    --no-flow --solver_param edge_table=0 over 21 frames.  Returns {path:
    (K1, K2, K4, K3) launches}.

    The flood path runs with `compact_divisor=1` (a compact table of one
    slot a voxel).  At the default half-size table the flood at the
    force-merge weight leaves more roots after level 0 than the table
    holds on this clip, the overflow's voxels keep their phase-A roots,
    and the next chunk's overlap planes then carry more regions than the
    solver's constraint cap (a ValueError, in the JAX package too); one
    chunk solve at the default table shows the overflow first."""
    from video_segment_tpu_torch import api
    from video_segment_tpu_torch.core import dense, flow, region
    from video_segment_tpu_torch.core import oversegmentation as ov
    dev = torch.device("cuda", 0)
    v1 = ov.OversegParams(edge_table=False)
    n, n_short = len(frames_p), N_SHORT_FRAMES
    solves = expected_chunk_solves(n, 20)
    flood = api.DenseSegmentationOptions(preseg_mode="flood")

    # One flood chunk at the default compact table: the overflow.
    ds = dense.DenseSegmentation(flood, W, H, solver_params=v1,
                                 device="cuda")
    for fr in frames_p[:21]:
        ds._ingest(fr, None)
    prep = ds._prepare_chunk(False)
    res = ds._dispatch_solve(prep)
    labels = int(torch.unique(res.label).numel())
    log("v1", f"flood, one 21-frame chunk at compact_divisor 2: phase A "
        f"leaves {int(res.diag[0, 2])} roots for a "
        f"{int(res.diag[1, 0]) - 1}-slot table; {labels} distinct labels, "
        f"{int((res.size > 0).sum())} live table regions")
    del ds, prep, res

    counts = {}
    paths = (("felz", frames_p, api.DenseSegmentationOptions(), False,
              (n, 0, 0, 0)),
             ("flood", frames_p, flood, False, (0, 0, solves, 0)),
             ("flow", frames_p[:n_short], api.DenseSegmentationOptions(),
              True, (n_short, 0, 0, 0)))
    for name, frames, dopts, use_flow, want in paths:
        nf = len(frames)
        reset_launches(*kernel_wrappers())
        params = v1._replace(compact_divisor=1) if name == "flood" else v1
        stream = api.SegmentStream(
            iter(frames),
            dense.DenseSegmentation(dopts, W, H, solver_params=params,
                                    device="cuda"),
            region.RegionSegmentation(
                api.RegionSegmentationOptions(use_flow=use_flow), W, H,
                device="cuda"),
            flow.FlowEngine(W, H, device="cuda") if use_flow else None)
        out, peak = run_stream(stream, dev)
        counts[name] = launch_counts()
        sets = check_stream(out, stream, nf)
        if counts[name] != want:
            raise AssertionError(f"v1 {name} path launches K1/K2/K4/K3 "
                                 f"{counts[name]}, want {want}")
        if any(d[:, 0].max() < 2 for d in stream.solve_diag):
            raise AssertionError(f"v1 {name}: solve diag not filled")
        log("v1", f"{name}: {path_summary(out, stream, peak, sets)}"
            f"; launches K1/K2/K4/K3 {counts[name]}")

    fm, n_reg, _ = dense_card_vs_cpu(frames_p[:5],
                                     api.DenseSegmentationOptions(), v1)
    log("v1", f"felz: 5 frames, one flush chunk (t_solve 5), card vs CPU: "
        f"boundary F {fm:.4f} (regions {n_reg})")
    if fm < 0.9:
        raise AssertionError(f"v1: card vs CPU boundary F {fm:.4f} < 0.9")

    if with_cli:
        from video_segment_tpu_torch.tools import seg_tree
        clip = write_avi(os.path.join(tmp, "v1.avi"), frames_p[:n_short])
        run = run_cli(seg_tree.main, [
            "--input_file", clip, "--no-flow", "--write_to_file",
            "--max_rate", "0", "--no-dynamic_rate", "--solver_param",
            "edge_table=0"], (n_short, 0, 0, 0))
        counts["seg_tree"] = run["counts"]
        read_pb(clip + ".pb")
        log("v1", f"seg_tree --no-flow --solver_param edge_table=0: "
            f"{seg_tree_summary(run)}")
    return counts


def mesh_phase(frames_p) -> dict:
    """Phase 28: the device mesh on the card.  make_mesh() over the
    machine's cards; a (1,4) mesh of cuda:0 whose DenseSegmentation stream
    over 21 frames equals solver_bands=4 id image for id image and
    SegFrame for SegFrame (both under deterministic algorithms, K1 21 and
    K2 8 launches on the mesh run); sharded_oversegment
    on a (2,2) cuda:0 mesh against the single-device banded solve;
    sharded_presmooth (bilateral, halo 4) on that mesh against the filter
    image by image; fused_oversegment over 2 clips against each clip's
    solve (the solves under deterministic algorithms); dryrun_multichip(4);
    `mixed_mesh_check`.  Returns the (K1, K2, K4, K3) launches of the mesh
    run."""
    from video_segment_tpu_torch import api
    from video_segment_tpu_torch.core import dense
    from video_segment_tpu_torch.core import oversegmentation as ov
    from video_segment_tpu_torch.ops import filters
    from video_segment_tpu_torch.parallel import entry
    from video_segment_tpu_torch.parallel import mesh as pmesh
    dev = torch.device("cuda", 0)
    n_cards = torch.cuda.device_count()
    log("mesh", f"make_mesh() over this machine's cards: "
        f"{pmesh.make_mesh()!r}")
    if n_cards == 1:
        log("mesh", "one card on this machine: every mesh entry is cuda:0, "
            "so transfers between cards were not exercised")
    frames = frames_p[:N_SHORT_FRAMES]
    n = len(frames)
    same = pmesh.Mesh([[dev] * 4])

    def stream(name):
        if name == "mesh":
            ds = dense.DenseSegmentation(api.DenseSegmentationOptions(), W,
                                         H, mesh=same)
        else:
            ds = dense.DenseSegmentation(api.DenseSegmentationOptions(
                solver_bands=4), W, H, device="cuda")
        reset_launches(*kernel_wrappers())
        out = []
        for fr in frames:
            out += ds.process_frame(False, fr)
        out += ds.process_frame(True)
        torch.cuda.synchronize()
        return out, launch_counts()

    with deterministic():
        out_m, launches_m = stream("mesh")
        out_b, launches_b = stream("bands4")
    want = (n, 4 * expected_chunk_solves(n, 20), 0, 0)
    if launches_m != want:
        raise AssertionError(f"mesh stream launches K1/K2/K4/K3 "
                             f"{launches_m}, want {want}")
    ids_m, ids_b = rasterize(out_m), rasterize(out_b)
    if (ids_m < 0).any() or not np.array_equal(ids_m, ids_b) or \
            signature(out_m) != signature(out_b):
        raise AssertionError("the (1,4) mesh stream differs from "
                             "solver_bands=4")
    log("mesh", f"(1,4) mesh of cuda:0, {n} frames {W}x{H}, flow off, "
        f"deterministic algorithms: id images and SegFrames equal "
        f"solver_bands=4's ({len(np.unique(ids_m))} ids); launches "
        f"K1/K2/K4/K3 mesh {launches_m} bands4 {launches_b}")

    # sharded_oversegment, sharded_presmooth and fused_oversegment on a
    # (2,2) mesh of cuda:0, on crops of two clip windows.
    m22 = pmesh.Mesh([[dev] * 2] * 2)
    clips = torch.tensor(np.stack([np.stack(frames[:4]),
                                   np.stack(frames[8:12])]),
                         device=dev)[:, :, :128, :256]
    vols = clips.to(torch.float32) * (1.0 / 255.0)
    # A table of one slot a voxel: every seed is live (no sink overflow).
    params = ov.OversegParams(min_region_size=20, table_divisor=1)
    with deterministic():
        reset_launches(*kernel_wrappers())
        labels = pmesh.sharded_oversegment(m22, params)(vols)
        k2_sh = launch_counts()[1]
        single = [ov.oversegment(v, params=params._replace(bands=2)).label
                  for v in vols]
        fused = pmesh.fused_oversegment(params)(vols)
        alone = [ov.oversegment(v, params=params).label for v in vols]
    for i in range(2):
        if not torch.equal(labels[i], single[i]):
            raise AssertionError(f"sharded_oversegment clip {i} differs "
                                 "from the single-device banded solve")
        if not torch.equal(fused[i], alone[i]):
            raise AssertionError(f"fused_oversegment clip {i} differs")
    if k2_sh != 4:
        raise AssertionError(f"sharded_oversegment: K2 {k2_sh}, want 4")
    log("mesh", f"sharded_oversegment on a (2,2) mesh of cuda:0, 2 clips "
        f"{tuple(vols.shape[1:4])}: labels equal the single-device "
        f"2-band solve ({int(torch.unique(labels).numel())} labels, K2 "
        f"{k2_sh})")

    big = torch.tensor(np.stack([np.stack(frames[:2]), np.stack(frames[2:4])]),
                       device=dev).to(torch.float32) * (1.0 / 255.0)
    sm = pmesh.sharded_presmooth(m22, "bilateral", halo=4)(big)
    ref = torch.stack([torch.stack([filters.presmooth(img, "bilateral")
                                    for img in clip]) for clip in big])
    err = float((sm - ref).abs().max())
    if err != 0.0:
        raise AssertionError(f"sharded_presmooth differs from the filter "
                             f"by {err}")
    log("mesh", f"sharded_presmooth (bilateral, halo 4) on the (2,2) mesh, "
        f"{tuple(big.shape)}: equal to the filter image by image bit for "
        "bit")

    log("mesh", f"fused_oversegment over 2 clips {tuple(vols.shape[1:4])}: "
        "each equal to its single-clip solve")

    entry.dryrun_multichip(4)
    log("mesh", "dryrun_multichip(4) passed")
    mixed_mesh_check(frames)
    return launches_m


def long_stream_checks(name: str, sets, n_solves: int) -> list:
    """The chunk sets of a 140-frame stream (20-frame chunks, the default
    sets of 6 with 2 kept as overlap): a full mid-stream set of chunks 0-5,
    then the flush set of chunks 4-7 under the first set's constraints;
    the seam property at every level and level-0 ids shared across the
    seam.  Returns `seam_check`'s seams."""
    got = [(r["chunks"], r["flush"], r["constrained"]) for r in sets]
    if n_solves != 8 or got != [(6, False, False), (4, True, True)]:
        raise AssertionError(f"{name}: {n_solves} chunk solves, sets "
                             f"(chunks, flush, constrained) {got}")
    seams = seam_check(sets)
    if any(s["share0"] <= 0 for s in seams):
        raise AssertionError(f"{name}: a set shares no level-0 id with the "
                             f"set before it")
    return seams


def peak_site(sets, peak: int) -> str:
    """Where the run's peak allocation was reached: in the chunk set whose
    processing raised the peak to it (the allocator's counter read before
    and after each set), or elsewhere."""
    for i, r in enumerate(sets):
        if r.get("peak_mib") is not None and \
                abs(r["peak_mib"] - peak / 2**20) < 1e-6:
            return f"chunk set {i}'s processing (agglomerate)"
    return "outside the chunk sets' processing (the dense stage)"


def config4_phase(tmp, k1_kw: dict) -> dict:
    """Phase 29: bench config 4's steady state on the card (see the module
    docstring), one pass that also takes the size and set records.
    Returns its launch counts and the kernels' cases at this geometry."""
    from video_segment_tpu_torch import api
    from video_segment_tpu_torch.core import dense
    from video_segment_tpu_torch.dataio import emit, seg_io
    dev = torch.device("cuda", 0)
    frames = upscale(synthetic_clip(N_LONG_FRAMES, seed=0), C4_W, C4_H)
    n = len(frames)
    pb = os.path.join(tmp, "config4.pb")
    writer = seg_io.SegmentationWriter(pb)
    if not writer.open_file(header_flags=[0, 1]):
        raise AssertionError(f"cannot write {pb}")
    reset_launches(*kernel_wrappers())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    order, hier = [], []
    with size_records() as sizes, set_records() as sets:
        stream = api.segment_frames(
            iter(frames), C4_W, C4_H, use_flow=False,
            dense_options=api.DenseSegmentationOptions(async_tail=True),
            device="cuda")
        for sf in stream:       # written as api.segment_video writes
            if sf.hierarchy is not None:
                if order:
                    writer.write_chunk()
                hier.append([len(lv.ids) for lv in sf.hierarchy])
            writer.add_to_chunk(emit.segframe_to_bytes(sf),
                                pts=sf.frame_index * 100)
            order.append(sf.frame_index)
        writer.write_term_and_close()
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    ds = stream.dense
    n_solves = expected_chunk_solves(n, 20)
    if (ds._bands, ds._pad_rows) != (3, 16):
        raise AssertionError(f"config 4: (bands, pad rows) "
                             f"{(ds._bands, ds._pad_rows)}, want (3, 16)")
    if counts != (n, 3 * n_solves, 0, 0):
        raise AssertionError(f"config 4: launches K1/K2/K4/K3 {counts}, want "
                             f"{(n, 3 * n_solves, 0, 0)}")
    if order != list(range(n)):
        raise AssertionError(f"config 4: frames emitted as {order}")
    seams = long_stream_checks("config 4", sets, len(stream.solve_diag))
    imgs, hier_at = read_pb(pb)
    if imgs.shape != (n, C4_H, C4_W) or len(hier_at) != len(sets):
        raise AssertionError(f"config 4: the .pb holds {imgs.shape}, "
                             f"hierarchies at {hier_at}")
    del imgs
    log("config4", f"{n} frames {C4_W}x{C4_H} (the {W}x{H} clip upscaled), "
        f"flow off, segment_frames with the async tail: peak device memory "
        f"{peak / 2**20:.1f} MiB, reached in {peak_site(sets, peak)}; "
        f"{ds._bands} bands of {(C4_H + ds._pad_rows) // ds._bands} rows, "
        f"{ds._pad_rows} pad rows; {n_solves} chunk solves; hierarchy "
        f"regions per level of each chunk set {hier}; .pb read back: {n} "
        f"frames in order, hierarchies at {hier_at}; launches K1/K2/K4/K3 "
        f"{counts}")
    log("config4", "chunk sets (host counts, no sync added): "
        + set_summary(sets))
    log("config4", "seam property held: " + seam_summary(seams))
    log("config4", "sizes: " + size_summary(sizes))
    del sets

    forced = dense.DenseSegmentation(api.DenseSegmentationOptions(
        solver_bands=3), C4_W, C4_H, device="cpu")
    if (forced._bands, forced._pad_rows) != (3, 16):
        raise AssertionError("config 4 card vs CPU: not 3 bands, 16 pad rows")
    fm, n_reg, _ = dense_card_vs_cpu(frames[:5], api.DenseSegmentationOptions(
        solver_bands=3))
    log("config4", f"card vs CPU: 5 frames, one flush chunk (t_solve 5) in 3 "
        f"forced bands, 16 pad rows: boundary F {fm:.4f} (regions {n_reg})")
    if fm < 0.9:
        raise AssertionError(f"config 4: card vs CPU boundary F {fm:.4f} "
                             "< 0.9")

    hp = C4_H + ds._pad_rows
    k1 = k1_case(ds.preprocess(frames[0])[None].contiguous(), k1_kw)
    k2 = k2_band_case(np.random.default_rng(29),
                      torch.Generator(device=dev).manual_seed(29), k1_kw,
                      hp // ds._bands, C4_W)
    log("config4", kernel_summary(k1, k2))
    return dict(counts=counts, k1=k1, k2=k2)


def steady_phase() -> dict:
    """Phase 31: the region stage's streaming steady state at 272x480 on
    the card (see the module docstring).  Returns the launch counts."""
    from video_segment_tpu_torch import api
    dev = torch.device("cuda", 0)
    frames = synthetic_clip(N_LONG_FRAMES, seed=3)
    reset_launches(*kernel_wrappers())
    with set_records() as sets:
        stream = api.segment_frames(iter(frames), W, H, use_flow=False,
                                    device="cuda")
        ds, rs = stream.dense, stream.region
        bufs = [0, 0, 0]   # dense frames, region features, region chunks
        feed = ds.process_frame

        def watched(*args):
            res = feed(*args)
            bufs[:] = [max(b, x) for b, x in zip(bufs, (
                len(ds._buffer), len(rs._features), len(rs._chunks)))]
            return res

        ds.process_frame = watched
        out, peak = run_stream(stream, dev)
    counts = launch_counts()
    hier = check_stream(out, stream, N_LONG_FRAMES)
    n_solves = len(stream.solve_diag)
    want = (N_LONG_FRAMES, n_solves, 0, 0)
    if counts != want:
        raise AssertionError(f"steady state: launches K1/K2/K4/K3 {counts}, "
                             f"want {want}")
    seams = long_stream_checks("steady state", sets, n_solves)
    if bufs[0] > ds.options.chunk_size + 1:
        raise AssertionError(f"steady state: the dense stage buffered "
                             f"{bufs[0]} frames")
    log("steady", path_summary(out, stream, peak, hier)
        + f"; peak reached in {peak_site(sets, peak)}; largest buffers: "
        f"dense {bufs[0]} frames (chunk_size + 1 = "
        f"{ds.options.chunk_size + 1}), region features {bufs[1]} frames, "
        f"region chunks {bufs[2]}; launches K1/K2/K4/K3 {counts}")
    log("steady", "chunk sets: " + set_summary(sets))
    log("steady", "seam property held: " + seam_summary(seams))
    return dict(counts=counts)


def bilateral_bound(h: int, w: int, radius: int = 4) -> tuple:
    """K6's bound on one (h, w) frame: 12 B read and 12 B written a pixel;
    a tap's 11 emulated multiply-adds (2 for the colour distance, 9 in
    the exp) and, from the second tap on, 3 for the value sums, each a
    float64 multiply and add; 16 float32 operations a tap and 7 a pixel
    (the clamp and the three divisions, the three products of the second
    tap).  Returns (ms, what bounds it)."""
    from video_segment_tpu_torch.ops import bilateral as bl
    taps, px = bl.taps(radius), h * w
    return bound(24 * px, {"f64": px * 2 * (11 * taps + 3 * (taps - 1)),
                           "f32": px * (16 * taps + 7)})


def bilateral_phase(frames=None) -> dict:
    """Phase 32: K6 against the eager body (see the module docstring).
    Draws an 8-frame clip when not given one.  Returns K6's numbers."""
    from video_segment_tpu_torch.ops import bilateral as bl
    from video_segment_tpu_torch.ops import filters
    dev = torch.device("cuda", 0)
    if frames is None:
        frames = synthetic_clip(8)

    def image(fr):
        return torch.as_tensor(fr, device=dev).to(torch.float32) * (1 / 255)

    cases = {f"{H}x{W}": [image(fr) for fr in frames[:8]],
             f"{BH}x{BW}": [image(synthetic_clip(1, h=BH, w=BW)[0])]}
    out = {}
    for name, imgs in cases.items():
        n0 = bl.bilateral.launches
        got = [filters.bilateral_filter(img) for img in imgs]
        launches = bl.bilateral.launches - n0
        want = [filters.bilateral_filter_plain(img) for img in imgs]
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        if launches != len(imgs) or not all(
                torch.equal(a.view(torch.int32), b.view(torch.int32))
                for a, b in zip(got, want)):
            raise AssertionError(f"K6 at {name}: {launches} launches for "
                                 f"{len(imgs)} frames, max |d| {err:.3g} "
                                 f"against the eager body")
        img = imgs[-1]
        ms = device_ms(lambda: filters.bilateral_filter(img), 200)
        plain_ms = cuda_ms(lambda: filters.bilateral_filter_plain(img), 5)
        bound_ms, by = bilateral_bound(*img.shape[:2])
        out[name] = dict(frames=len(imgs), max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by)
        log("k6", f"{name}: {len(imgs)} frame(s) equal the eager body bit "
            f"for bit, one launch a frame; kernel {ms * 1e3:.2f} us a frame "
            f"(launches back to back), eager body {plain_ms:.3f} ms; bound "
            f"{bound_ms * 1e3:.2f} us ({by}), {100 * bound_ms / ms:.1f}% of "
            f"it")
    log("build", resource_line("bilateral", -(-W // bl.TILE_W)
                               * -(-H // bl.TILE_H)))
    main = out[f"{H}x{W}"]
    return dict(max_abs_err=max(v["max_abs_err"] for v in out.values()),
                ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                banded_frame=out[f"{BH}x{BW}"])


def tvl1_bound(calls) -> tuple:
    """K5's bound on the scales `calls` (each `tvl1_scale`'s arguments):
    60 B a pixel an iteration (u1, u2, p11, p12, p21, p22, i1wx, i1wy and
    rho_c read, the six state planes written) and 36 B a pixel a warp
    (u1, u2, i0, i1, i1x, i1y read, three invariants written) at the HBM
    rate; about 20 float32 operations a pixel an iteration.  Returns (ms,
    what bounds it, pixel-iterations, launches)."""
    px_it = px_warp = launches = 0
    for c in calls:
        p = c[-1]
        warps, its = max(p.warps, 0), max(p.iterations, 0)
        px = c[0].numel()
        px_it += px * warps * its
        px_warp += px * warps
        launches += warps * (1 + its)
    ms, by = bound(60 * px_it + 36 * px_warp, {"f32": 20 * px_it})
    return ms, by, px_it, launches


def tvl1_phase(frames=None, bg_masks=None) -> dict:
    """Phase 12: TV-L1 on the card (see the module docstring).  Makes a
    7-frame clip when not given one.  Returns K5's numbers."""
    from video_segment_tpu_torch.core import flow as fl
    from video_segment_tpu_torch.ops import tvl1 as tvl1_ops
    dev = torch.device("cuda", 0)
    if frames is None:
        frames, objects = synthetic_clip(7, truth=True)
        bg_masks = objects == 0
    grays = torch.from_numpy(np.stack([fl.bgr_to_gray(f)
                                       for f in frames[:7]])).to(dev)
    cur, prev = grays[1], grays[0]
    flow_card = fl.tvl1_flow(cur, prev).cpu().numpy()   # frame 1, backward
    t0 = time.monotonic()
    flow_cpu = fl.tvl1_flow(cur.cpu(), prev.cpu()).numpy()
    cpu_s = time.monotonic() - t0
    tvl1_ms = cuda_ms(lambda: fl.tvl1_flow(cur, prev), 3)
    diff = np.abs(flow_card - flow_cpu)
    n_trunc = int((flow_card.astype(np.int32)
                   != flow_cpu.astype(np.int32)).sum())
    bg = bg_masks[0] & bg_masks[1]
    med_u = float(np.median(flow_card[bg, 0]))
    med_v = float(np.median(flow_card[bg, 1]))
    log("flow", f"TV-L1 {W}x{H} pair: {tvl1_ms:.2f} ms alone (CUDA "
        f"events); CPU {cpu_s:.2f} s; card vs CPU max |d| {diff.max():.3g} "
        f"px, mean {diff.mean():.3g} px, trunc differs at {n_trunc} pixels;"
        f" background ({int(bg.sum())} px) median flow ({med_u:.3f}, "
        f"{med_v:.3f}), built as (+2, 0)")
    if abs(med_u - 2.0) > 0.3 or abs(med_v) > 0.3:
        raise AssertionError(f"background flow ({med_u:.3f}, {med_v:.3f}) "
                             "is not the clip's pan (+2, 0)")

    # K5: the kernel path against the eager body, a batch of six pairs as
    # the seg_tree flow engine runs it (backward: frame k+1 to frame k).
    a, b = grays[1:7].contiguous(), grays[:6].contiguous()
    params = fl.TVL1Params()
    calls = []   # each scale's kernel arguments, to time the kernels alone
    real = fl._tvl1_scale_kernel

    def recording(i0, i1, u1, u2, p):
        calls.append((i0, i1, *fl._grad(i1), u1, u2, p))
        return tvl1_ops.tvl1_scale(*calls[-1])

    fl._tvl1_scale_kernel = recording
    try:
        n0 = tvl1_ops.tvl1_scale.launches
        got = fl.tvl1_flow_batch(a, b, params)
        launches = tvl1_ops.tvl1_scale.launches - n0
    finally:
        fl._tvl1_scale_kernel = real
    want = fl.tvl1_flow_plain(a, b, params)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    bitwise = torch.equal(got.view(torch.int32), want.view(torch.int32))
    if not bitwise:
        raise AssertionError(f"K5: the kernel path differs from the eager "
                             f"body (max |d| {err:.3g} px)")
    peaks = {}
    for name, fn in (("kernels", fl.tvl1_flow_batch),
                     ("eager", fl.tvl1_flow_plain)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        fn(a, b, params)
        torch.cuda.synchronize()
        peaks[name] = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20
    batch_ms = cuda_ms(lambda: fl.tvl1_flow_batch(a, b, params), 20)
    batch_dev_ms = device_ms(lambda: fl.tvl1_flow_batch(a, b, params), 20)
    k5_ms = device_ms(lambda: [tvl1_ops.tvl1_scale(*c) for c in calls], 20)
    plain_ms = cuda_ms(lambda: fl.tvl1_flow_plain(a, b, params), 3)
    bound_ms, by, px_it, _ = tvl1_bound(calls)
    # Two limits bind in turn: the finest scale moves the bytes, the coarse
    # scales (a few thousand pixels a plane) wait on one launch after
    # another.  The launch floor is the card's time per back-to-back
    # launch of an empty kernel.
    fine_ms = device_ms(lambda: tvl1_ops.tvl1_scale(*calls[-1]), 20)
    fine_bound_ms, fine_by, _, _ = tvl1_bound(calls[-1:])
    coarse_ms = device_ms(
        lambda: [tvl1_ops.tvl1_scale(*c) for c in calls[:-1]], 20)
    coarse_launches = tvl1_bound(calls[:-1])[3]
    empty_ms = device_ms(lambda: [torch.cuda._sleep(0) for _ in range(500)],
                         20) / 500
    floor_ms = coarse_launches * empty_ms
    # The iteration kernel's grid at the finest scale: 32x8 tiles, 6 pairs.
    log("build", resource_line("tvl1", -(-W // 32) * -(-H // tvl1_ops.TILE_H)
                               * 6))
    log("flow", f"K5 TV-L1 kernels, a batch of 6 pairs {W}x{H} "
        f"({len(calls)} scales, {launches} launches, {px_it / 1e6:.2f} M "
        f"pixel-iterations): fields equal the eager body's bit for bit; "
        f"kernels alone {k5_ms:.4f} ms (queued back to back), the whole "
        f"kernel path {batch_dev_ms:.4f} ms on the card and {batch_ms:.4f} "
        f"ms as the host issues it, the eager body {plain_ms:.2f} ms; bound "
        f"{bound_ms:.4f} ms ({by}), {100 * bound_ms / k5_ms:.1f}% of it; "
        f"TV-L1's peak above its inputs {peaks['kernels']:.1f} MiB with the"
        f" kernels, {peaks['eager']:.1f} MiB eager")
    log("flow", f"K5 by limit: the finest scale {fine_ms:.4f} ms against "
        f"its bound {fine_bound_ms:.4f} ms ({fine_by} at the HBM rate), "
        f"{100 * fine_bound_ms / fine_ms:.1f}% of it; the {len(calls) - 1} "
        f"coarse scales {coarse_ms:.4f} ms for {coarse_launches} launches "
        f"against a launch floor of {coarse_launches} x "
        f"{empty_ms * 1e3:.2f} us (an empty kernel back to back) = "
        f"{floor_ms:.4f} ms, {100 * floor_ms / coarse_ms:.1f}% of it")
    return dict(launches=launches, max_abs_err=err, ms=k5_ms,
                batch_ms=batch_dev_ms, host_ms=batch_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, peak_mib=peaks,
                fine_ms=fine_ms, fine_bound_ms=fine_bound_ms,
                coarse_ms=coarse_ms, coarse_launches=coarse_launches,
                launch_floor_ms=floor_ms)


def config5_phase(tmp, k1_kw: dict, n_frames: int) -> dict:
    """Phase 30: bench config 5 on the card (see the module docstring),
    over `n_frames` frames a clip.  Returns its launch counts and the
    kernels' cases at this geometry."""
    from video_segment_tpu_torch.tools import batch_segment, renderer
    dev = torch.device("cuda", 0)
    clips = [upscale(synthetic_clip(n_frames, seed=seed), C5_W, C5_H)
             for seed in (0, 1)]
    _, bd = fused_vs_standalone([c[:N_SHORT_FRAMES] for c in clips],
                                "config5")
    bands, pad = bd.clips[0]._bands, bd.clips[0]._pad_rows
    del bd

    vids = [write_avi(os.path.join(tmp, f"config5_clip{i}.avi"), c)
            for i, c in enumerate(clips)]
    out_dir = os.path.join(tmp, "config5")
    n_solves = expected_chunk_solves(n_frames, 20)
    want = (2 * n_frames, 2 * bands * n_solves, 0, 0)
    run = run_cli(batch_segment.main, [*vids, "--fused", "--no-flow",
                                       "--output_dir", out_dir], want)
    pbs = [os.path.join(out_dir, f"{i:03d}_{os.path.basename(v)}.pb")
           for i, v in enumerate(vids)]
    mp4s = [pb + "_render.mp4" for pb in pbs]
    for pb, mp4 in zip(pbs, mp4s):
        with contextlib.redirect_stdout(io.StringIO()):
            rc = renderer.main(["--input", pb, "--render_level", "0.1",
                                "--output_video", mp4])
        if rc not in (0, None):
            raise AssertionError(f"renderer failed on {pb}: {rc}")
    batches = run["made"]["batch"]
    if len(batches) != 1 or [c._bands for c in batches[0].clips] != \
            [bands] * 2:
        raise AssertionError(f"config 5: batch_segment's clips are not in "
                             f"{bands} bands")
    regions = []
    for pb, mp4 in zip(pbs, mp4s):
        imgs, _ = read_pb(pb)
        if imgs.shape != (n_frames, C5_H, C5_W):
            raise AssertionError(f"config 5: {pb} holds {imgs.shape}")
        regions.append(len(np.unique(imgs)))
        if not os.path.exists(mp4) or os.path.getsize(mp4) == 0:
            raise AssertionError(f"config 5: {mp4} is empty")
    log("config5", f"2 clips x {n_frames} frames {C5_W}x{C5_H} (the {W}x{H} "
        f"clip upscaled, seeds 0 and 1), batch_segment --fused --no-flow, "
        f"then the renderer at render level 0.1 on each .pb (videos "
        f"{[os.path.getsize(m) for m in mp4s]} B): peak device memory "
        f"{run['peak'] / 2**20:.1f} MiB; {bands} bands a clip, {pad} pad "
        f"rows; launches K1/K2/K4/K3 {run['counts']}; each .pb read back with "
        f"{n_frames} frames and a hierarchy, level-0 regions per clip "
        f"{regions}")

    k1 = k1_case(batches[0].clips[0].preprocess(clips[0][0])[None]
                 .contiguous(), k1_kw)
    k2 = k2_band_case(np.random.default_rng(30),
                      torch.Generator(device=dev).manual_seed(30), k1_kw,
                      (C5_H + pad) // bands, C5_W)
    log("config5", kernel_summary(k1, k2))
    return dict(counts=run["counts"], k1=k1, k2=k2)


def band_leaves(out) -> list:
    """The tensors of one band's `_band_phase` output, in a fixed order."""
    state, memb, tab, orig = out
    return [x for x in state if x is not None] + [memb, tab, orig]


def mixed_mesh_check(frames, options=None) -> None:
    """Phase 28, second part: a (1,2) mesh of cuda:0 and the CPU, where
    every transfer of the mesh code is real (on a mesh of one device each
    `.to()` is a no-op).  The DenseSegmentation stream over `frames` and
    `sharded_chunk_solver` on its constrained chunk raise no device
    mismatch and return every result on cuda:0; each band's outputs equal
    a single-device `_band_phase` on that band's device (band 1 on the
    CPU, the plain K2); the glued labels reach boundary F >= 0.9 against
    a mesh of cuda:0 alone (F3: band 1's float sums ran on the CPU); and
    `halo_exchange_rows` and `sharded_presmooth` equal the single-device
    versions.  The comparisons run under deterministic algorithms.
    `options` are the stream's DenseSegmentationOptions (the defaults
    where None); its second chunk solve must be constrained."""
    from video_segment_tpu_torch import api
    from video_segment_tpu_torch.core import dense
    from video_segment_tpu_torch.core import oversegmentation as ov
    from video_segment_tpu_torch.ops import filters
    from video_segment_tpu_torch.parallel import mesh as pmesh
    dev, cpu = torch.device("cuda", 0), torch.device("cpu")
    h, w = frames[0].shape[:2]
    options = options or api.DenseSegmentationOptions()
    mixed = pmesh.Mesh([[dev, cpu]])
    same = pmesh.Mesh([[dev, dev]])

    def on_card(x, what):
        for v in (x if isinstance(x, (tuple, list)) else [x]):
            if isinstance(v, torch.Tensor) and v.device != dev:
                raise AssertionError(f"mixed mesh: {what} on {v.device}")

    def stream(mesh):
        ds = dense.DenseSegmentation(options, w, h, mesh=mesh)
        preps, solve = [], ds._dispatch_solve

        def recording(prep):
            res = solve(prep)
            on_card(res, "a chunk solve's result")
            preps.append(prep)
            return res

        ds._dispatch_solve = recording
        out = []
        for fr in frames:
            out += ds.process_frame(False, fr)
        out += ds.process_frame(True)
        return out, preps

    with deterministic():
        out_x, preps = stream(mixed)
        out_s, _ = stream(same)
    fm_stream = boundary_f(rasterize(out_x), rasterize(out_s))

    # The constrained chunk (the second solve) through the solver and its
    # band phase alone.
    prep = preps[1]
    p, heads = prep["params"], prep["head_planes"]
    has_c, use_cells = (prep["constraints"] is not None,
                        prep["tile_stats"] is not None)
    if not has_c:
        raise AssertionError("mixed mesh: the second chunk solve is not "
                             "constrained")
    inputs = dense._materialize_solve_inputs(prep, w)
    vol, _, init, constr, frozen, fin, cells = inputs
    t, hp = vol.shape[:2]
    nv = t * hp * w

    def band_phase(devices, home):
        flat = [x.reshape(nv).to(home) for x in (init, constr, frozen, fin)]
        cf = tuple(c.reshape(nv).to(home) for c in cells) if use_cells \
            else None
        return ov._band_phase(vol.to(home), None, *flat, p, has_c, cf, heads,
                              devices=devices)

    with deterministic():
        outs_x = band_phase([dev, cpu], dev)
        outs_card = band_phase([dev], dev)
        outs_cpu = band_phase([cpu], cpu)
        res_x = pmesh.sharded_chunk_solver(mixed, p, False, has_c, heads,
                                           use_cells)(*inputs)
        res_s = pmesh.sharded_chunk_solver(same, p, False, has_c, heads,
                                           use_cells)(*inputs)
    if len(outs_x) != 2:
        raise AssertionError(f"mixed mesh: {len(outs_x)} bands, want 2")
    for b, (got, want) in enumerate(zip(outs_x, (outs_card[0],
                                                 outs_cpu[1]))):
        on_card(band_leaves(got), f"band {b}'s gathered outputs")
        for a, c in zip(band_leaves(got), band_leaves(want)):
            if not torch.equal(a.cpu(), c.cpu()):
                raise AssertionError(f"mixed mesh: band {b}'s outputs differ "
                                     f"from its single-device band phase")
    on_card(res_x, "sharded_chunk_solver's result")
    fm_solve = boundary_f(res_x.label.reshape(t, hp, w).cpu().numpy(),
                          res_s.label.reshape(t, hp, w).cpu().numpy())
    if min(fm_stream, fm_solve) < 0.9:
        raise AssertionError(f"mixed mesh vs the cuda:0 mesh: boundary F "
                             f"stream {fm_stream:.4f}, chunk solve "
                             f"{fm_solve:.4f} < 0.9")
    log("mesh", f"(1,2) mesh of cuda:0 and cpu, {len(frames)} frames "
        f"{w}x{h}, deterministic algorithms: no device mismatch, every "
        f"result on cuda:0; the constrained chunk's band 0 equals the "
        f"band phase on cuda:0 and band 1 the band phase on the CPU (plain "
        f"K2) exactly; boundary F against the (1,2) mesh of cuda:0 "
        f"{fm_stream:.4f} (stream, {len(np.unique(rasterize(out_x)))} vs "
        f"{len(np.unique(rasterize(out_s)))} ids), {fm_solve:.4f} (chunk "
        f"solve, {int(torch.unique(res_x.label).numel())} vs "
        f"{int(torch.unique(res_s.label).numel())} labels)")

    x = torch.tensor(np.stack(frames[:2]), device=dev).to(torch.float32) \
        * (1.0 / 255.0)
    halves = [x[:, :h // 2], x[:, h // 2:].to(cpu)]
    for border in ("edge", "reflect"):
        got = pmesh.halo_exchange_rows(halves, 4, border)
        want = pmesh.halo_exchange_rows([s.cpu() for s in halves], 4, border)
        if [g.device for g in got] != [dev, cpu] or not all(
                torch.equal(g.cpu(), c) for g, c in zip(got, want)):
            raise AssertionError(f"mixed mesh: halo_exchange_rows ({border})"
                                 f" differs from the single-device exchange")
    sm = pmesh.sharded_presmooth(mixed, "bilateral", halo=4)(x[None])[0]
    on_card(sm, "sharded_presmooth's result")
    ref = {d: torch.stack([filters.presmooth(img.to(d), "bilateral")
                           for img in x]) for d in (dev, cpu)}
    if not (torch.equal(sm[:, :h // 2], ref[dev][:, :h // 2])
            and torch.equal(sm[:, h // 2:].cpu(), ref[cpu][:, h // 2:])):
        raise AssertionError("mixed mesh: sharded_presmooth differs from the "
                             "filter on each shard's device")
    log("mesh", f"mixed mesh: halo_exchange_rows (edge, reflect) equals the "
        f"single-device exchange; sharded_presmooth (bilateral, halo 4) "
        f"equals the filter on each shard's device bit for bit (rows of the "
        f"CPU shard differ from the card's filter by at most "
        f"{float((sm - ref[dev]).abs().max()):.3g})")


def main() -> int:
    # -- 1. environment ---------------------------------------------------
    if not torch.cuda.is_available():
        log("env", "FAIL: torch.cuda.is_available() is False; this smoke "
            "run needs an NVIDIA card")
        return 1
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log("env", f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {kind!r} count "
        f"{torch.cuda.device_count()} nvidia-smi {smi!r}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from concurrent.futures import ThreadPoolExecutor

    from video_segment_tpu_torch import _build
    from video_segment_tpu_torch.ops import tile_extract as te
    from video_segment_tpu_torch.ops import tile_felz as tf
    from video_segment_tpu_torch.ops import tile_preseg as tp
    from video_segment_tpu_torch.ops import tile_table as tt

    # -- 2. build -----------------------------------------------------------
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(_build.load, KERNELS))
    tiles = -(-H // tf.TILE_H) * -(-W // tf.TILE_W)
    log("build", resource_line("tile_felz", tiles))        # one frame
    log("build", resource_line("tile_extract", 21 * tiles))  # one chunk
    log("build", resource_line("tile_preseg",               # one chunk
                               -(-21 * tiles // tp.TILES_PER_CTA)))
    from video_segment_tpu_torch.core import region
    if not region.native.available():
        raise RuntimeError("native host helpers (g++) failed to build")
    log("build", "the six kernels and the native host helpers built")

    # -- 3. K1 vs plain -----------------------------------------------------
    from video_segment_tpu_torch.core import oversegmentation as ov
    p = ov.OversegParams()
    k1_kw = dict(schedule=p.preseg_schedule,
                 rounds_per_level=p.preseg_rounds_per_level,
                 merge_threshold=p.merge_threshold, metric=p.metric,
                 fin_margin=p.preseg_fin_margin, fin_eager=p.preseg_fin_eager,
                 fin_gated=p.preseg_fin_gated, pair_merge=p.preseg_pair_merge)
    from video_segment_tpu_torch.core import dense
    frames, objects = synthetic_clip(N_FRAMES, truth=True)
    bg_masks = objects == 0     # the pixels no shape covers
    rng = np.random.default_rng(7)
    k1_err = 0.0
    labels8 = None
    clip2 = torch.stack([dense._preprocess_u8(
        torch.as_tensor(fr, device=dev), "bilateral") for fr in frames[:2]])
    inputs = (("textured", torch.from_numpy(textured(rng, (8, H, W), 1.5))),
              ("textured", torch.from_numpy(textured(rng, (2, 24, 300),
                                                     2.0))),
              ("clip", clip2),
              ("flat", torch.full((2, 20, 300, 3), 0.4)))
    for name, vol in inputs:
        vol = vol.to(dev).contiguous()
        got = tf.tile_felzenszwalb(vol, **k1_kw)
        want = tf.tile_felzenszwalb_plain(vol, **k1_kw)
        torch.cuda.synchronize()
        for a, b in zip((got[0], got[1], *got[2]), (want[0], want[1],
                                                    *want[2])):
            k1_err = max(k1_err, float((a.double() - b.double()).abs().max()))
            if not torch.equal(a, b):
                raise AssertionError(f"K1 differs from its plain version on "
                                     f"the {name} {tuple(vol.shape[:3])} "
                                     f"input")
        if labels8 is None:
            labels8 = got[0]
        log("k1", f"{name} {tuple(vol.shape[:3])}: labels, fin, sizes and "
            f"colour sums equal bit for bit; "
            f"{int(torch.unique(got[0]).numel())} regions")
    frame1 = torch.from_numpy(textured(rng, (1, H, W), 1.5)).to(dev)
    k1_frames = {"textured": frame1, "clip": clip2[1:].contiguous(),
                 "flat": torch.full((1, H, W, 3), 0.4, device=dev)}
    k1_times = {name: device_ms(lambda: tf.tile_felzenszwalb(fr, **k1_kw),
                                200)
                for name, fr in k1_frames.items()}
    k1_ms = k1_times["textured"]
    k1_host_ms = cuda_ms(lambda: tf.tile_felzenszwalb(frame1, **k1_kw), 200)
    k1_plain_ms = cuda_ms(lambda: tf.tile_felzenszwalb_plain(frame1, **k1_kw),
                          5)
    k1_bound_ms, k1_by = k1_bound(frame1, k1_kw)
    log("k1", f"one {H}x{W} frame: kernel {k1_ms:.4f} ms textured, "
        f"{k1_times['clip']:.4f} ms clip, {k1_times['flat']:.4f} ms flat "
        f"(launches back to back); {k1_host_ms:.4f} ms a call as the host "
        f"issues them; plain {k1_plain_ms:.4f} ms; bound "
        f"{k1_bound_ms * 1e3:.3f} us ({k1_by})")

    # -- 4. K2 vs plain -----------------------------------------------------
    t_solve = 21
    lab21 = torch.cat([labels8] * 3)[:t_solve]
    yx = lab21 % (H * W)
    labr = ((yx // W) % tf.TILE_H).to(torch.int32).contiguous()
    labc = (yx % W % tf.TILE_W).to(torch.int32).contiguous()
    gen = torch.Generator(device=dev).manual_seed(11)
    keys = torch.randint(0, 2046 << 20, (13, t_solve, H, W), generator=gen,
                         dtype=torch.int32, device=dev)
    keys[torch.rand(keys.shape, generator=gen, device=dev) < 0.3] = \
        ov.I32MAX
    red_k = te.tile_reduce_min(labr, labc, keys)
    red_p = te.tile_reduce_min_plain(labr, labc, keys)
    torch.cuda.synchronize()
    if not torch.equal(red_k, red_p):
        raise AssertionError("K2 differs from its plain version")
    k2_err = float((red_k.long() - red_p.long()).abs().max())
    k2_ms = device_ms(lambda: te.tile_reduce_min(labr, labc, keys), 50)
    k2_plain_ms = cuda_ms(lambda: te.tile_reduce_min_plain(labr, labc, keys),
                          5)
    # The library call: one scatter_reduce_("amin") into a table of
    # (direction, tile, cell) segments and one gather, indices precomputed.
    nty, ntx = -(-H // tf.TILE_H), -(-W // tf.TILE_W)
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    tiles = ((torch.arange(t_solve, device=dev)[:, None, None] * nty
              + ys // tf.TILE_H) * ntx + xs // tf.TILE_W)
    seg = (tiles * tf.NPIX + labr.long() * tf.TILE_W
           + labc.long()).reshape(1, -1).expand(keys.shape[0], -1)
    own = (tiles * tf.NPIX + (ys % tf.TILE_H) * tf.TILE_W
           + xs % tf.TILE_W).reshape(-1)
    keys2 = keys.reshape(keys.shape[0], -1)
    n_seg = t_solve * nty * ntx * tf.NPIX

    def k2_library():
        table = torch.full((keys.shape[0], n_seg), ov.I32MAX,
                           dtype=torch.int32, device=dev)
        table.scatter_reduce_(1, seg, keys2, "amin")
        return table[:, own]

    if not torch.equal(k2_library().reshape(keys.shape), red_k):
        raise AssertionError("K2's library call differs from the kernel")
    k2_lib_ms = device_ms(k2_library, 20)
    k2_bound_ms, k2_by = bound(
        2 * keys.numel() * 4 + 2 * labr.numel() * 4, {"i32": keys.numel()})
    log("k2", f"(13,{t_solve},{H},{W}) equal; kernel {k2_ms:.4f} ms, plain "
        f"{k2_plain_ms:.4f} ms, library call (scatter_reduce_ amin + "
        f"gather) {k2_lib_ms:.4f} ms; bound {k2_bound_ms * 1e3:.1f} us "
        f"({k2_by})")
    del keys, red_k, red_p, seg, own, keys2, tiles
    # K2 at one band of the banded 480x854 path: (13,21,432,480).
    k2_band = k2_band_case(rng, gen, k1_kw, (BH + 10) // 2, BW, t_solve)
    log("k2", f"band shape {tuple(k2_band['shape'])} equal; kernel "
        f"{k2_band['ms']:.4f} ms, plain {k2_band['plain_ms']:.4f} ms; bound "
        f"{k2_band['bound_ms'] * 1e3:.1f} us ({k2_band['bound_by']}), "
        f"{100 * k2_band['bound_ms'] / k2_band['ms']:.1f}% of it")
    # Colours in (0, 2^-20) of the presmoothed clip: K1's float64 colour
    # sums are exact only outside that interval.
    n_tiny = n_zero = 0
    for fr in frames:
        sm = dense._preprocess_u8(torch.as_tensor(fr, device=dev),
                                  "bilateral")
        n_tiny += int(((sm > 0) & (sm < 2.0 ** -20)).sum())
        n_zero += int((sm == 0).sum())
    log("k1", f"presmoothed {N_FRAMES}-frame clip: {n_tiny} colour values in "
        f"(0, 2^-20), {n_zero} exact zeros, of "
        f"{N_FRAMES * H * W * 3}")

    # -- 32. K6 vs plain ----------------------------------------------------
    k6 = bilateral_phase(frames)

    # -- 5. main path -------------------------------------------------------
    from video_segment_tpu_torch import api
    from video_segment_tpu_torch.ops import bilateral as bl
    reset_launches(tf.tile_felzenszwalb, te.tile_reduce_min, bl.bilateral)
    stream = api.segment_frames(iter(frames), W, H, use_flow=False,
                                device="cuda")
    out, peak = run_stream(stream, dev)
    k1_launches = tf.tile_felzenszwalb.launches
    k2_launches = te.tile_reduce_min.launches
    k6_launches = bl.bilateral.launches

    n_solves = expected_chunk_solves(N_FRAMES, 20)
    sets = check_stream(out, stream, N_FRAMES)
    if (k1_launches != N_FRAMES or k2_launches != n_solves
            or k6_launches != N_FRAMES
            or stream.counters["ingest.bilateral_kernel"] != N_FRAMES):
        raise AssertionError(f"launches K1 {k1_launches} (want {N_FRAMES}),"
                             f" K2 {k2_launches} (want {n_solves}), K6 "
                             f"{k6_launches} and ingest.bilateral_kernel "
                             f"{stream.counters['ingest.bilateral_kernel']}"
                             f" (want {N_FRAMES})")
    log("main", path_summary(out, stream, peak, sets)
        + f"; launches K1 {k1_launches} K2 {k2_launches} K6 {k6_launches}")

    # -- 6. card vs CPU -----------------------------------------------------
    fm, n_reg, _ = dense_card_vs_cpu(frames[:8],
                                     api.DenseSegmentationOptions())
    log("cpu", f"8 frames, one flush chunk (t_solve 21): boundary F "
        f"{fm:.4f} (regions {n_reg})")
    if fm < 0.9:
        raise AssertionError(f"card vs CPU boundary F {fm:.4f} < 0.9")

    # -- 7. K4 vs plain -----------------------------------------------------
    from video_segment_tpu_torch.core import dense, region
    opts = api.DenseSegmentationOptions()
    vol21 = torch.stack([
        dense._preprocess_u8(torch.as_tensor(fr, device=dev),
                             opts.presmoothing) for fr in frames[:t_solve]])
    thr = p.preseg_threshold
    n_tiles = t_solve * -(-H // tf.TILE_H) * -(-W // tf.TILE_W)
    k4_iters = torch.full((n_tiles,), -1, dtype=torch.int32, device=dev)
    raw_k = tp.flood_kernel(vol21, thr, "l2", 48, tile_iters=k4_iters)
    raw_p = tp.flood_plain(vol21, thr, "l2", 48)
    k4_k = tp.tile_presegment(vol21, thr, "l2")
    k4_p = tp.tile_presegment_plain(vol21, thr, "l2")
    torch.cuda.synchronize()
    if not (torch.equal(raw_k, raw_p) and torch.equal(k4_k, k4_p)):
        raise AssertionError("K4 differs from its plain version")
    k4_err = float((k4_k.long() - k4_p.long()).abs().max())
    k4_ms = device_ms(lambda: tp.flood_kernel(vol21, thr, "l2", 48), 50)
    k4_plain_ms = cuda_ms(lambda: tp.flood_plain(vol21, thr, "l2", 48), 5)
    # Bound: 12 bytes read and 4 written a voxel; per in-tile N4 edge 10
    # float32 operations for its distance, and in each Jacobi iteration a
    # tile ran (to its fixed point, at most 48) one integer min at each end
    # of its admissible edges.
    k4_edges = 0
    k4_adm_tile = torch.zeros(n_tiles, dtype=torch.int64, device=dev)
    ts = torch.arange(t_solve, device=dev).view(-1, 1, 1)
    for dim, size in ((1, tf.TILE_H), (2, tf.TILE_W)):
        a = vol21.narrow(dim, 0, vol21.shape[dim] - 1)
        b = vol21.narrow(dim, 1, vol21.shape[dim] - 1)
        d = tf._dist32(a, b, "l2")
        ys = torch.arange(d.shape[1], device=dev).view(1, -1, 1)
        xs = torch.arange(d.shape[2], device=dev).view(1, 1, -1)
        pos = ys if dim == 1 else xs
        inner = (pos % size != size - 1).expand(d.shape)
        tile = ((ts * -(-H // tf.TILE_H) + ys // tf.TILE_H)
                * -(-W // tf.TILE_W) + xs // tf.TILE_W).expand(d.shape)
        k4_edges += int(inner.sum())
        adm = (d <= thr) & inner
        k4_adm_tile += torch.bincount(tile[adm], minlength=n_tiles)
    k4_steps = int((k4_adm_tile * k4_iters.long()).sum())
    k4_bound_ms, k4_by = bound(16 * vol21.numel() // 3,
                               {"f32": 10 * k4_edges, "i32": 2 * k4_steps})
    n_flood = int(torch.unique(k4_k).numel())
    log("k4", f"(21,{H},{W}) raw roots and collapsed labels equal; "
        f"{n_flood} regions ({n_flood / k4_k.numel():.3f} per pixel); "
        f"iterations a tile ran before its fixed point: max "
        f"{int(k4_iters.max())}, mean {float(k4_iters.float().mean()):.2f}, "
        f"{int((k4_iters == 48).sum())} of {n_tiles} tiles stopped by the "
        f"48-iteration budget; raw flood kernel {k4_ms:.4f} ms, plain "
        f"{k4_plain_ms:.4f} ms (before the pointer jump); bound "
        f"{k4_bound_ms * 1e3:.1f} us ({k4_by}), "
        f"{100 * k4_bound_ms / k4_ms:.1f}% of it")

    # -- 8. K3 vs plain -----------------------------------------------------
    def k3_pair(kw):
        got = tt.tile_table_rounds(**kw)
        want = tt.tile_table_rounds_plain(**kw)
        torch.cuda.synchronize()
        err = max(float((a.long() - b.long()).abs().max())
                  for a, b in zip(got, want))
        if err:
            raise AssertionError(f"K3 differs from its plain version "
                                 f"(max abs label err {err})")
        moved = int(((got[0] * 128 + got[1]) != (kw["labr"] * 128
                                                  + kw["labc"])).sum())
        return err, moved

    def k3_bound(kw):
        # 8 input planes and K edge planes read once, 2 planes written; per
        # round and slot, K edge tests of about 20 float32 operations.
        slots = kw["labr"].numel()
        return bound(4 * slots * (8 + kw["edges"].shape[1] + 2),
                     {"f32": kw["rounds"] * slots * kw["edges"].shape[1]
                      * 20})

    rng = np.random.default_rng(13)
    for theta, mthr, blocked in ((64, 0.08, True), (2047, 0.05, False)):
        q = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in quantized_tables(rng, 64, 32, 12).items()}
        if not blocked:
            q["blocked"].zero_()
        q_kw = dict(q, theta=theta, rounds=5, merge_threshold=mthr,
                    force_merge_weight=0.001, metric="l2")
        _, moved = k3_pair(q_kw)
        q_ms = device_ms(lambda: tt.tile_table_rounds(**q_kw), 20)
        q_bound, q_by = k3_bound(q_kw)
        log("k3", f"quantized (64,12,32,128), theta {theta}: equal; "
            f"{moved} slots moved; kernel {q_ms:.4f} ms; bound "
            f"{q_bound * 1e3:.1f} us ({q_by}), "
            f"{100 * q_bound / q_ms:.1f}% of it")
    pm_kw = dict(k1_kw, pair_merge=True)
    lab_f, fin_f, st_f = tf.tile_felzenszwalb(vol21, **pm_kw)
    n_seeds = int((lab_f.reshape(-1) == torch.arange(
        lab_f.numel(), device=dev)).sum())
    st_params = ov.OversegParams(
        preseg_pair_merge=True, st_levels=3, table_slots=min(
            -(-(n_seeds + 1024) // 16384) * 16384, lab_f.numel()))
    k3_kw = ov.supertile_level_inputs(vol21, lab_f, fin_f, st_f, st_params)
    k3_err, moved = k3_pair(k3_kw)
    k3_ms = device_ms(lambda: tt.tile_table_rounds(**k3_kw), 20)
    k3_plain_ms = cuda_ms(lambda: tt.tile_table_rounds_plain(**k3_kw), 3)
    n_sup, k_e = k3_kw["edges"].shape[:2]
    placed = int((k3_kw["size"] > 0).sum())
    k3_bound_ms, k3_by = k3_bound(k3_kw)
    log("build", resource_line("tile_table", n_sup))
    log("k3", f"real chunk, level 0: {n_seeds} pair-merge seeds ({placed} "
        f"placed), {n_sup} supertiles x {k3_kw['labr'].shape[1] * 128} "
        f"slots, K={k_e}: "
        f"equal; {moved} slots moved; kernel {k3_ms:.4f} ms, plain "
        f"{k3_plain_ms:.4f} ms; bound {k3_bound_ms * 1e3:.1f} us ({k3_by}), "
        f"{100 * k3_bound_ms / k3_ms:.1f}% of it")
    del vol21, raw_k, raw_p, k4_k, k4_p, k3_kw, lab_f, fin_f, st_f

    # -- 9. flood path ------------------------------------------------------
    frames_p = frames[:N_PATH_FRAMES]
    n_solves_p = expected_chunk_solves(N_PATH_FRAMES, 20)
    reset_launches(tf.tile_felzenszwalb, te.tile_reduce_min,
                   tp.tile_presegment, tt.tile_table_rounds)
    stream = api.segment_frames(
        iter(frames_p), W, H, use_flow=False, device="cuda",
        dense_options=api.DenseSegmentationOptions(preseg_mode="flood"))
    out, peak = run_stream(stream, dev)
    counts = (tf.tile_felzenszwalb.launches, te.tile_reduce_min.launches,
              tp.tile_presegment.launches, tt.tile_table_rounds.launches)
    sets = check_stream(out, stream, N_PATH_FRAMES)
    if counts != (0, n_solves_p, n_solves_p, 0):
        raise AssertionError(f"flood path launches K1/K2/K4/K3 {counts}, "
                             f"want (0, {n_solves_p}, {n_solves_p}, 0)")
    k4_launches = counts[2]
    log("flood", path_summary(out, stream, peak, sets)
        + f"; launches K4 {counts[2]} K2 {counts[1]}")

    # -- 10. supertile path -------------------------------------------------
    st_solver = ov.OversegParams(preseg_pair_merge=True, st_levels=3)
    reset_launches(tf.tile_felzenszwalb, te.tile_reduce_min,
                   tp.tile_presegment, tt.tile_table_rounds)
    stream = api.SegmentStream(
        iter(frames_p),
        dense.DenseSegmentation(api.DenseSegmentationOptions(), W, H,
                                solver_params=st_solver, device="cuda"),
        region.RegionSegmentation(api.RegionSegmentationOptions(
            use_flow=False), W, H, device="cuda"))
    out, peak = run_stream(stream, dev)
    counts = (tf.tile_felzenszwalb.launches, te.tile_reduce_min.launches,
              tp.tile_presegment.launches, tt.tile_table_rounds.launches)
    sets = check_stream(out, stream, N_PATH_FRAMES)
    want = (N_PATH_FRAMES, n_solves_p, 0, 3 * n_solves_p)
    if counts != want:
        raise AssertionError(f"supertile path launches K1/K2/K4/K3 "
                             f"{counts}, want {want}")
    k3_launches = counts[3]
    log("supertile", path_summary(out, stream, peak, sets)
        + f"; launches K1 {counts[0]} K2 {counts[1]} K3 {counts[3]}")

    # -- 11. new paths, card vs CPU -----------------------------------------
    for name, options, params in (
            ("flood", api.DenseSegmentationOptions(preseg_mode="flood"),
             None),
            ("supertile", api.DenseSegmentationOptions(), st_solver)):
        fm, n_reg, card = dense_card_vs_cpu(frames[:8], options, params)
        log("cpu", f"{name}: 8 frames, one flush chunk: boundary F "
            f"{fm:.4f} (regions {n_reg})")
        if fm < 0.9:
            raise AssertionError(f"{name}: card vs CPU boundary F "
                                 f"{fm:.4f} < 0.9")
    # How far the K3 path departs from the masked rounds at full size
    # (seeds beyond st_slots, recompaction inside the gated levels).
    masked = dense_level0(frames[:8], api.DenseSegmentationOptions(),
                          st_solver._replace(st_kernel=False), "cuda")
    log("cpu", f"supertile on the card, K3 path vs masked rounds: boundary "
        f"F {boundary_f(card, masked):.4f} (regions "
        f"{len(np.unique(card))} vs {len(np.unique(masked))})")

    # -- 12. TV-L1 on the card ----------------------------------------------
    from video_segment_tpu_torch.core import flow as fl
    from video_segment_tpu_torch.ops import tvl1 as tvl1_ops
    k5 = tvl1_phase(frames, bg_masks)

    # -- 13. flow path ------------------------------------------------------
    # The API stream computes each frame's backward flow alone: one K5
    # launch sequence a pair, the first frame none.
    reset_launches(tf.tile_felzenszwalb, te.tile_reduce_min,
                   tp.tile_presegment, tt.tile_table_rounds,
                   tvl1_ops.tvl1_scale)
    stream = api.segment_frames(iter(frames_p), W, H, use_flow=True,
                                device="cuda")
    out, peak = run_stream(stream, dev)
    counts = (tf.tile_felzenszwalb.launches, te.tile_reduce_min.launches,
              tp.tile_presegment.launches, tt.tile_table_rounds.launches)
    k5_flow = tvl1_ops.tvl1_scale.launches
    sets = check_stream(out, stream, N_PATH_FRAMES)
    want = (N_PATH_FRAMES, n_solves_p, 0, 0)
    if counts != want:
        raise AssertionError(f"flow path launches K1/K2/K4/K3 {counts}, "
                             f"want {want}")
    want_k5 = (N_PATH_FRAMES - 1) * fl.kernel_launches(H, W, fl.TVL1Params())
    if k5_flow != want_k5:
        raise AssertionError(f"flow path launches K5 {k5_flow}, want "
                             f"{want_k5}")
    if "flow" not in stream.stage_seconds:
        raise AssertionError("the flow path ran no flow engine")
    log("flowpath", path_summary(out, stream, peak, sets)
        + f"; launches K1 {counts[0]} K2 {counts[1]} K5 {k5_flow}")

    # -- 14. flow dense stage, card vs CPU ----------------------------------
    gray8 = torch.from_numpy(np.stack([fl.bgr_to_gray(f)
                                       for f in frames[:8]])).to(dev)
    flows8 = [None] + list(fl.tvl1_flow_batch(gray8[1:], gray8[:-1])
                           .cpu().numpy())
    fm, n_reg, _ = dense_card_vs_cpu(frames[:8],
                                     api.DenseSegmentationOptions(),
                                     flows=flows8)
    log("cpu", f"flow: 8 frames with the same host flow arrays, one flush "
        f"chunk: boundary F {fm:.4f} (regions {n_reg})")
    if fm < 0.9:
        raise AssertionError(f"flow: card vs CPU boundary F {fm:.4f} < 0.9")

    # -- 15. banded path (bench config 3's geometry) ------------------------
    frames_b = synthetic_clip(N_PATH_FRAMES, seed=1, h=BH, w=BW)
    reset_launches(tf.tile_felzenszwalb, te.tile_reduce_min,
                   tp.tile_presegment, tt.tile_table_rounds,
                   tvl1_ops.tvl1_scale)
    stream = api.segment_frames(iter(frames_b), BW, BH, use_flow=True,
                                device="cuda")
    geometry = (stream.dense._bands, stream.dense._pad_rows)
    if geometry != (2, 10):
        raise AssertionError(f"banded path: (bands, pad rows) {geometry}, "
                             "want (2, 10)")
    out, peak = run_stream(stream, dev)
    counts = (tf.tile_felzenszwalb.launches, te.tile_reduce_min.launches,
              tp.tile_presegment.launches, tt.tile_table_rounds.launches)
    sets = check_stream(out, stream, N_PATH_FRAMES)
    if any((sf.frame_height, sf.frame_width) != (BH, BW) for sf in out):
        raise AssertionError("banded path: output frames are not 480x854")
    want = (N_PATH_FRAMES, 2 * n_solves_p, 0, 0)
    if counts != want:
        raise AssertionError(f"banded path launches K1/K2/K4/K3 {counts}, "
                             f"want {want}")
    k5_banded = tvl1_ops.tvl1_scale.launches
    want_k5 = (N_PATH_FRAMES - 1) * fl.kernel_launches(BH, BW,
                                                       fl.TVL1Params())
    if k5_banded != want_k5:
        raise AssertionError(f"banded path launches K5 {k5_banded}, want "
                             f"{want_k5}")
    banded_launches = counts
    log("banded", path_summary(out, stream, peak, sets)
        + f"; 2 bands of {(BH + 10) // 2} rows, 10 pad rows; launches K1 "
        f"{counts[0]} (one per padded frame) K2 {counts[1]} (one per band "
        f"per chunk solve) K5 {k5_banded}")

    # -- 16. banded dense stage, card vs CPU --------------------------------
    fm, n_reg, _ = dense_card_vs_cpu(frames_b[:5],
                                     api.DenseSegmentationOptions())
    log("cpu", f"banded: 5 frames {BW}x{BH}, one flush chunk (t_solve 5, 2 "
        f"bands): boundary F {fm:.4f} (regions {n_reg})")
    if fm < 0.9:
        raise AssertionError(f"banded: card vs CPU boundary F {fm:.4f} < 0.9")

    # -- 17. one chunk, 2 bands vs 1 band -----------------------------------
    level0, solve_s, peaks = {}, {}, {}
    for name, options in (
            ("2 bands", api.DenseSegmentationOptions()),
            ("1 band", api.DenseSegmentationOptions(
                max_solve_voxels=21 * BW * BH))):
        ds = dense.DenseSegmentation(options, BW, BH, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        res = []
        for fr in frames_b[:20]:
            res += ds.process_frame(False, fr)
        res += ds.process_frame(True)
        torch.cuda.synchronize()
        level0[name] = rasterize(res)
        solve_s[name] = ds.stage_seconds["chunk_solve"]
        peaks[name] = torch.cuda.max_memory_allocated(dev) / 2 ** 20
        if (ds._bands, ds._pad_rows) != ((2, 10) if name == "2 bands"
                                         else (1, 0)):
            raise AssertionError(f"{name}: bands {ds._bands}, pad rows "
                                 f"{ds._pad_rows}")
    fm = boundary_f(level0["2 bands"], level0["1 band"])
    log("bands", f"one {BW}x{BH} chunk of 20 frames (t_solve 21, flow off), "
        f"2 bands vs 1 band: boundary F {fm:.4f}; regions "
        f"{ {k: int(len(np.unique(v))) for k, v in level0.items()} }; "
        f"chunk_solve seconds { {k: round(v, 3) for k, v in solve_s.items()} }"
        f"; peak device memory MiB "
        f"{ {k: round(v, 1) for k, v in peaks.items()} }")
    if fm < 0.9:
        raise AssertionError(f"2 bands vs 1 band boundary F {fm:.4f} < 0.9")
    del level0

    # -- 18. checkpoint kill-and-resume on the card -------------------------
    from video_segment_tpu_torch.runtime import checkpoint

    def stages():
        return (dense.DenseSegmentation(api.DenseSegmentationOptions(), W, H,
                                        device="cuda"),
                region.RegionSegmentation(api.RegionSegmentationOptions(
                    use_flow=False), W, H, device="cuda"))

    def feed(ds, rs, chunk, start, flush):
        res = []
        for i, fr in enumerate(chunk, start=start):
            rs.add_frame(i, fr)
            res += rs.process_frames(False, ds.process_frame(False, fr))
        if flush:
            res += rs.process_frames(True, ds.process_frame(True))
        return res

    cut = 25
    with deterministic():
        straight = feed(*stages(), frames_p, 0, True)
        ds1, rs1 = stages()
        first = feed(ds1, rs1, frames_p[:cut], 0, False)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "ckpt.pkl")
            checkpoint.save(path, ds1, rs1, frames_consumed=cut)
            ckpt_mib = os.path.getsize(path) / 2 ** 20
            del ds1, rs1
            ds2, rs2 = stages()
            if checkpoint.restore(path, ds2, rs2) != cut:
                raise AssertionError("checkpoint: frames_consumed lost")
        if ds2._buffer[0].device.type != "cuda":
            raise AssertionError("checkpoint restored off the card")
        resumed = first + feed(ds2, rs2, frames_p[cut:], cut, True)
    if len(straight) != N_PATH_FRAMES or \
            signature(resumed) != signature(straight):
        raise AssertionError("checkpoint: the resumed run differs from the "
                             "straight run")
    log("ckpt", f"{N_PATH_FRAMES} frames {W}x{H}, killed after frame {cut} "
        f"(checkpoint {ckpt_mib:.1f} MiB), restored into fresh stages on "
        "the card: RLE and hierarchies equal the straight run's bit for "
        "bit")

    # -- 19-23. the command-line tools on the card -------------------------
    n_st = 3 * n_solves_p     # K3 launches: 3 gated levels a chunk solve
    cli_counts = None
    missing = None
    try:
        import cv2  # noqa: F401  (the CLIs decode with it)
        import google.protobuf  # noqa: F401  (and write .pb with it)
    except ImportError as err:
        missing = err.name
        log("cli", f"module {missing!r} is missing on this machine: phases "
            "19-23 (seg_tree, kill and resume through the CLI, the offline "
            "tools), batch_segment's runs, the seg_tree runs of 25 and 27 "
            "and 29-30 (bench configs 4 and 5) are left out; the fused "
            "batch still runs from arrays")
    frames_c = synthetic_clip(N_SHORT_FRAMES, seed=2)   # the second clip
    with tempfile.TemporaryDirectory() as tmp:
        if missing is None:
            cli_counts = cli_phases(tmp, frames_p, frames_b, n_solves_p,
                                    n_st)

        fused_counts = fused_phase(tmp, [frames_p[:N_SHORT_FRAMES],
                                         frames_c[:N_SHORT_FRAMES]],
                                   with_cli=missing is None)

        # -- 25. the off-default knobs ---------------------------------------
        knob_counts = knobs_phase(tmp, frames_p, frames_b,
                                  with_cli=missing is None)

        # -- 27. the v1 pixel solver -----------------------------------------
        v1_counts = v1_phase(tmp, frames_p, with_cli=missing is None)

    # -- 28. the device mesh -------------------------------------------------
    mesh_counts = mesh_phase(frames_p)

    # -- 29-30. bench configs 4 and 5 ----------------------------------------
    config4 = config5 = None
    if missing is None:
        with tempfile.TemporaryDirectory() as tmp:
            config4 = config4_phase(tmp, k1_kw)
            config5 = config5_phase(tmp, k1_kw, N_SHORT_FRAMES)

    # -- 31. the streaming steady state at 272x480 ---------------------------
    steady_counts = steady_phase()["counts"]

    # -- 26. the port stands alone -----------------------------------------
    jax_mods = sorted(m for m in sys.modules
                      if m == "jax" or m.startswith(("jax.", "jaxlib")))
    if jax_mods:
        raise AssertionError(f"the port imported JAX: {jax_mods[:5]}")
    pkg_mods = sorted(m for m in sys.modules if m == "video_segment_tpu"
                      or m.startswith("video_segment_tpu."))
    if pkg_mods:
        raise AssertionError(f"the port imported the JAX package: "
                             f"{pkg_mods[:5]}")
    log("alone", "no module of video_segment_tpu (the JAX package) and no "
        "jax was imported during the run")

    kernels = [
        dict(name="tile_felzenszwalb", route="cuda",
             source="video_segment_tpu_torch/csrc/tile_felz.cu",
             replaces="video_segment_tpu/ops/tile_felz.py:474",
             launches=k1_launches, max_abs_err=k1_err, ms=k1_ms,
             plain_ms=k1_plain_ms, bound_ms=k1_bound_ms, bound_by=k1_by,
             library_ms=None, launches_banded=banded_launches[0],
             launches_seg_tree=cli_counts and cli_counts[0],
             launches_fused=fused_counts[0],
             launches_knobs={k: v[0] for k, v in knob_counts.items()},
             launches_v1=v1_counts["felz"][0],
             launches_v1_flood=v1_counts["flood"][0],
             launches_mesh=mesh_counts[0],
             launches_long=steady_counts[0],
             launches_config4_long=config4 and config4["counts"][0],
             launches_config5=config5 and config5["counts"][0],
             config4_frame=config4 and config4["k1"],
             config5_frame=config5 and config5["k1"]),
        dict(name="tile_reduce_min", route="cuda",
             source="video_segment_tpu_torch/csrc/tile_extract.cu",
             replaces="video_segment_tpu/ops/tile_extract.py:102",
             launches=k2_launches, max_abs_err=k2_err, ms=k2_ms,
             plain_ms=k2_plain_ms, bound_ms=k2_bound_ms, bound_by=k2_by,
             library_ms=k2_lib_ms, launches_banded=banded_launches[1],
             launches_seg_tree=cli_counts and cli_counts[1],
             launches_fused=fused_counts[1],
             launches_knobs={k: v[1] for k, v in knob_counts.items()},
             launches_v1=v1_counts["felz"][1],
             launches_v1_flood=v1_counts["flood"][1],
             launches_mesh=mesh_counts[1],
             band_ms=k2_band["ms"], band_plain_ms=k2_band["plain_ms"],
             band_bound_ms=k2_band["bound_ms"],
             launches_long=steady_counts[1],
             launches_config4_long=config4 and config4["counts"][1],
             launches_config5=config5 and config5["counts"][1],
             config4_band=config4 and config4["k2"],
             config5_band=config5 and config5["k2"]),
        dict(name="tile_presegment", route="cuda",
             source="video_segment_tpu_torch/csrc/tile_preseg.cu",
             replaces="video_segment_tpu/ops/tile_preseg.py:98",
             launches=k4_launches, max_abs_err=k4_err, ms=k4_ms,
             plain_ms=k4_plain_ms, bound_ms=k4_bound_ms, bound_by=k4_by,
             library_ms=None,
             launches_knobs={k: v[2] for k, v in knob_counts.items()},
             launches_v1=v1_counts["felz"][2],
             launches_v1_flood=v1_counts["flood"][2],
             launches_long=steady_counts[2],
             launches_config4_long=config4 and config4["counts"][2],
             launches_config5=config5 and config5["counts"][2]),
        dict(name="tile_table_rounds", route="cuda",
             source="video_segment_tpu_torch/csrc/tile_table.cu",
             replaces="video_segment_tpu/ops/tile_table.py:358",
             launches=k3_launches, max_abs_err=k3_err, ms=k3_ms,
             plain_ms=k3_plain_ms, bound_ms=k3_bound_ms, bound_by=k3_by,
             library_ms=None,
             launches_seg_tree_supertile=cli_counts and cli_counts[3],
             launches_knobs={k: v[3] for k, v in knob_counts.items()},
             launches_v1=v1_counts["felz"][3],
             launches_v1_flood=v1_counts["flood"][3],
             launches_long=steady_counts[3],
             launches_config4_long=config4 and config4["counts"][3],
             launches_config5=config5 and config5["counts"][3]),
        dict(name="tvl1_scale", route="cuda",
             source="video_segment_tpu_torch/csrc/tvl1.cu",
             replaces="eager torch ops (core/flow.py:_tvl1_scale)",
             launches=k5["launches"], max_abs_err=k5["max_abs_err"],
             ms=k5["ms"], batch_ms=k5["batch_ms"], host_ms=k5["host_ms"],
             plain_ms=k5["plain_ms"], bound_ms=k5["bound_ms"],
             bound_by=k5["bound_by"], peak_mib=k5["peak_mib"],
             fine_ms=k5["fine_ms"], fine_bound_ms=k5["fine_bound_ms"],
             coarse_ms=k5["coarse_ms"],
             coarse_launches=k5["coarse_launches"],
             launch_floor_ms=k5["launch_floor_ms"],
             library_ms=None, launches_flow=k5_flow,
             launches_banded=k5_banded,
             launches_seg_tree=cli_counts and cli_counts[4]),
        dict(name="bilateral", route="cuda",
             source="video_segment_tpu_torch/csrc/bilateral.cu",
             replaces="eager torch ops (ops/filters.py:"
                      "bilateral_filter_plain)",
             launches=k6_launches, **k6, library_ms=None),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
