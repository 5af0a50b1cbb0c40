"""Entry points: a single-device solve step and the multi-device dry run.

The port's counterpart of the JAX package's `__graft_entry__.py`:

    python -m video_segment_tpu_torch.parallel.entry [--device cpu] [N]

runs `entry()`'s step once and `dryrun_multichip(N)` (N defaults to 8).
"""

from __future__ import annotations

import argparse
import warnings

import numpy as np
import torch

from video_segment_tpu_torch import device as devmod
from video_segment_tpu_torch.core import oversegmentation as ov
from video_segment_tpu_torch.parallel import mesh as pmesh


def entry(device: str | torch.device = "cuda"):
    """(fn, example_args): one over-segmentation solve of a small video
    chunk (4x64x64, flow on), the same step and parameters as the JAX
    package's entry."""
    dev = devmod.resolve(device)
    params = ov.OversegParams(min_region_size=16,
                              schedule=(8, 128, 2047),
                              max_rounds_per_level=6, max_final_rounds=8,
                              min_size_rounds=8)
    t, h, w = 4, 64, 64
    fn = pmesh._free_solve_one(params, True)
    rng = np.random.default_rng(0)
    vol = torch.tensor(rng.random((t, h, w, 3), dtype=np.float32),
                       device=dev)
    flow = torch.zeros((t - 1, h, w, 2), dtype=torch.float32, device=dev)
    return fn, (vol, flow)


def _check_equal(what: str, a, b) -> None:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or not np.array_equal(a, b):
        raise AssertionError(f"dryrun_multichip: {what} differs from the "
                             f"single-device result")


def dryrun_multichip(n_devices: int,
                     device: str | torch.device = "cuda") -> dict:
    """Run the segmentation step over an n-entry mesh and hold each stage
    to its single-device result; raises on any mismatch.

    The mesh takes the machine's first `n_devices` cards in turn (on one
    card every entry is `cuda:0`; with `device="cpu"` every entry is the
    CPU).  The stages are the JAX dry run's:
    1. `sharded_presmooth` (gaussian, halo 1) against `presmooth` image by
       image;
    2. `sharded_oversegment` (clips on "data", bands on "space") against
       the single-device banded `oversegment`, label for label;
    3. the constrained streaming `DenseSegmentation` (chunk_size 4, two
       chunk solves or more) on the mesh against `solver_bands=space`, id
       image for id image;
    4. `agglomerate` with its region tables handed in from the mesh's
       devices against the single-device hierarchy.  The port has no
       single-process sharded tensor: the tables are split by rows over
       the mesh's devices and gathered on the first device, where the
       agglomeration runs.
    On a card both sides of each comparison run under
    `torch.use_deterministic_algorithms`: float atomics would make the
    last bit of a sum depend on the launch's schedule.  Returns a summary
    dict."""
    dev = devmod.resolve(device)
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    if dev.type == "cuda":
        torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return _dryrun(n_devices, dev)
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def _dryrun(n_devices: int, device: torch.device) -> dict:
    from video_segment_tpu_torch.core import agglomeration, dense
    from video_segment_tpu_torch.core.options import (
        DenseSegmentationOptions)
    from video_segment_tpu_torch.core.region import rasterize_ids
    from video_segment_tpu_torch.ops import filters

    mesh = pmesh.make_mesh(n_devices, device=device, repeat=True)
    data, space = mesh.devices.shape
    home = mesh.first

    b, t, h, w = data, 3, 32, 32
    params = ov.OversegParams(min_region_size=8, schedule=(16, 2047),
                              max_rounds_per_level=4, max_final_rounds=6,
                              min_size_rounds=6)
    rng = np.random.default_rng(0)
    vol = torch.tensor(rng.random((b, t, h, w, 3), dtype=np.float32),
                       device=home)

    # Stage 1: the row-sharded front-end (halo rows from the neighbours).
    smoothed = pmesh.sharded_presmooth(mesh, "gaussian", halo=1)(vol)
    single = torch.stack([torch.stack([filters.presmooth(img, "gaussian")
                                       for img in clip]) for clip in vol])
    _check_equal("sharded_presmooth", smoothed.cpu(), single.cpu())

    # Stage 2: the banded solver over the mesh, clips on "data".
    labels = pmesh.sharded_oversegment(mesh, params)(smoothed)
    if tuple(labels.shape) != (b, t, h, w):
        raise AssertionError(f"dryrun_multichip: labels {labels.shape}")
    for i in range(b):
        ref = ov.oversegment(smoothed[i], params=params._replace(
            bands=space)).label
        _check_equal(f"sharded_oversegment clip {i}", labels[i].cpu(),
                     ref.cpu())

    # Stage 3: the constrained streaming dense stage, every chunk solve
    # through sharded_chunk_solver.
    tc, hc, wc = 8, 32, 32
    clip = np.clip(rng.normal(0.4, 0.25, (tc, hc, wc, 3)), 0, 1)
    clip = (clip * 255).astype(np.uint8)

    def run_stream(use_mesh):
        opts = DenseSegmentationOptions(
            chunk_size=4, enforce_spatial_connectedness=False,
            solver_bands=0 if use_mesh else space)
        ds = (dense.DenseSegmentation(opts, wc, hc, mesh=mesh) if use_mesh
              else dense.DenseSegmentation(opts, wc, hc, device=home))
        frames = []
        for fr in clip:
            frames += ds.process_frame(False, fr)
        frames += ds.process_frame(True)
        if ds._chunk_id < 2:
            raise AssertionError("dryrun_multichip: the constrained path "
                                 "did not run")
        return [rasterize_ids(f.region_ids, f.interval_counts,
                              np.stack([f.ys, f.lxs, f.rxs], 1),
                              hc, wc) for f in frames]

    ids_single, ids_mesh = run_stream(False), run_stream(True)
    if len(ids_single) != tc or len(ids_mesh) != tc:
        raise AssertionError("dryrun_multichip: frames lost in the stream")
    for k, (a, c) in enumerate(zip(ids_single, ids_mesh)):
        _check_equal(f"mesh stream frame {k}", c, a)

    # Stage 4: the region-stage agglomeration fed tables from the mesh.
    r, rcap, nb = 24, 32, 16
    hist = np.zeros((rcap, nb), np.float32)
    hist[np.arange(r), rng.integers(0, nb, r)] = 100.0
    hist[:r] += rng.random((r, nb)).astype(np.float32)
    sizes = np.zeros(rcap, np.float32)
    sizes[:r] = rng.integers(50, 500, r).astype(np.float32)
    edges = np.stack([np.arange(r - 1), np.arange(1, r)], axis=1)
    fh = np.zeros((0, rcap, 4), np.float32)
    fc = np.zeros((0, rcap), np.float32)
    plain = agglomeration.agglomerate(hist, fh, fc, sizes, edges, r,
                                      use_flow=False, device=home)
    hist_g, sizes_g = gather_rows(mesh, hist), gather_rows(mesh, sizes)
    meshed = agglomeration.agglomerate(hist_g, fh, fc, sizes_g, edges, r,
                                       use_flow=False, device=home)
    if not len(plain) == len(meshed) > 0:
        raise AssertionError("dryrun_multichip: hierarchy depth differs")
    for k, (a, c) in enumerate(zip(plain, meshed)):
        _check_equal(f"agglomeration level {k}", c, a)

    summary = dict(mesh=mesh.shape, labels=tuple(labels.shape),
                   stream_frames=tc, levels=len(plain))
    print(f"dryrun_multichip OK on {n_devices} entries "
          f"({', '.join(str(d) for d in mesh.devices.flat)}): mesh "
          f"{mesh.shape}, labels {tuple(labels.shape)}, sharded solve == "
          f"single-device banded; constrained streaming stage (2+ chunks) "
          f"on the mesh == solver_bands={space}; agglomeration fed from "
          f"the mesh == single-device ({len(plain)} levels)", flush=True)
    return summary


def gather_rows(mesh: pmesh.Mesh, table) -> torch.Tensor:
    """A region table split by rows over every mesh entry (in row-major
    mesh order), each shard on its device, gathered back on the first
    device."""
    x = torch.as_tensor(np.asarray(table))
    devs = list(mesh.devices.flat)
    shards = [s.to(d) for s, d in zip(torch.tensor_split(x, len(devs)),
                                      devs)]
    return torch.cat([s.to(mesh.first) for s in shards])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    fn, ex = entry(args.device)
    print("entry OK:", tuple(fn(*ex).shape))
    dryrun_multichip(args.n_devices, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
