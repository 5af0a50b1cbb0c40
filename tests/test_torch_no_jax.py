"""The port runs with the JAX package, jax, cv2 and protobuf unimportable.

A subprocess blocks the five (`sys.modules[name] = None` makes their
import raise), imports the port and its kernel modules, runs a tiny
`segment_frames(..., device="cpu")` end to end with flow off and with its
default flow on (the port's TV-L1 engine), and runs the dense stage with
the flood pre-segmentation (K4), with K3 supertile levels, with the v1
pixel solver (flood presegs, and one seed a voxel) and banded
(`solver_bands=2`), checkpoints and restores the banded stage, runs the
off-default knobs (the variance descriptor with the gradient trait of
`ops/pixel_distance`, the two-stage solve, windowed appearance with
`save_descriptors`) through both stages, runs the device mesh's entry
step and multi-device dry run (`parallel/entry`, `parallel/mesh`) on CPU
entries, and drives
the host modules the CLIs use (`runtime/pipeline`, `runtime/conversion`;
`segment_util/render` needs protobuf through `util`, and
`segment_util/metrics` needs cv2: both are left out, and nothing that
`segment_frames` imports may pull them in).

A second subprocess blocks only the JAX package, jax and jaxlib (the CLIs
decode with cv2 and write with protobuf), imports every command-line tool
and the fused batch stage, and runs `seg_tree.main` with `--no-flow
--over_segment --device cpu` on a tiny clip it writes itself.
"""

import os
import subprocess
import sys
import textwrap

import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import sys
    BLOCKED = ("video_segment_tpu", "jax", "jaxlib", "cv2",
               "google.protobuf")
    for name in BLOCKED:
        sys.modules[name] = None
    import numpy as np
    import torch
    torch.set_num_threads(2)
    from video_segment_tpu_torch.api import segment_frames
    from video_segment_tpu_torch.core import dense, flow
    from video_segment_tpu_torch.core.options import (
        DenseSegmentationOptions, RegionSegmentationOptions)
    from video_segment_tpu_torch.core import oversegmentation as ov
    from video_segment_tpu_torch.ops import (tile_extract, tile_felz,
                                             tile_preseg, tile_table)

    rng = np.random.default_rng(0)
    frames = []
    for f in range(7):
        img = np.full((16, 128, 3), 60, np.uint8)
        img[4:12, 10 + 4 * f:40 + 4 * f] = (200, 90, 40)
        img[:, 90:] = (30, 160, 220)
        frames.append((img + rng.integers(0, 6, img.shape)).astype(np.uint8))
    for use_flow in (False, True):
        stream = segment_frames(
            iter(frames), 128, 16, use_flow=use_flow, device="cpu",
            dense_options=DenseSegmentationOptions(chunk_size=3,
                                                   frac_min_region_size=0.1),
            region_options=RegionSegmentationOptions(
                chunk_set_size=2, chunk_set_overlap=1, min_region_num=2,
                max_region_num=40, use_flow=use_flow))
        out = list(stream)
        assert [sf.frame_index for sf in out] == list(range(7)), out
        assert any(sf.hierarchy for sf in out)
        for sf in out:
            assert sf.interval_counts.sum() > 0
        assert (isinstance(stream.flow, flow.FlowEngine)
                and "flow" in stream.stage_seconds) == use_flow
    for opts, params in (
            (DenseSegmentationOptions(chunk_size=3, preseg_mode="flood"),
             None),
            (DenseSegmentationOptions(chunk_size=3),
             ov.OversegParams(preseg_pair_merge=True, st_levels=2, st_h=8,
                              st_w=128)),
            # The v1 pixel solver: flood presegs, and one seed a voxel.
            (DenseSegmentationOptions(chunk_size=3, preseg_mode="flood"),
             ov.OversegParams(edge_table=False)),
            (DenseSegmentationOptions(chunk_size=3, tile_presegment=False),
             ov.OversegParams(edge_table=False))):
        ds = dense.DenseSegmentation(opts, 128, 16, solver_params=params,
                                     device="cpu")
        res = []
        for fr in frames:
            res += ds.process_frame(False, fr)
        res += ds.process_frame(True)
        assert [sf.frame_index for sf in res] == list(range(7))
    # Banded stage, checkpointed after chunk one and resumed in a fresh one.
    import os, tempfile
    from video_segment_tpu_torch.runtime import (checkpoint, conversion,
                                                 pipeline)
    bopts = DenseSegmentationOptions(chunk_size=3, solver_bands=2)
    ds = dense.DenseSegmentation(bopts, 128, 16, device="cpu")
    assert (ds._bands, ds._pad_rows) == (2, 0)
    straight = []
    for fr in frames:
        straight += ds.process_frame(False, fr)
    straight += ds.process_frame(True)
    ds = dense.DenseSegmentation(bopts, 128, 16, device="cpu")
    res = []
    for fr in frames[:4]:
        res += ds.process_frame(False, fr)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt.pkl")
        checkpoint.save(path, ds, frames_consumed=4)
        ds = dense.DenseSegmentation(bopts, 128, 16, device="cpu")
        assert checkpoint.restore(path, ds) == 4
    for fr in frames[4:]:
        res += ds.process_frame(False, fr)
    res += ds.process_frame(True)
    assert [sf.frame_index for sf in res] == list(range(7))
    for a, b in zip(res, straight):
        assert np.array_equal(a.region_ids, b.region_ids)
        assert np.array_equal(a.lxs, b.lxs) and np.array_equal(a.rxs, b.rxs)
    # The off-default knobs: the variance descriptor, the gradient trait
    # (ops/pixel_distance), the two-stage solve, windowed appearance.
    from video_segment_tpu_torch.core import region
    from video_segment_tpu_torch.ops import pixel_distance
    g = pixel_distance.gradient_features(torch.rand(2, 8, 16, 3))
    assert g.shape == (2, 8, 16, 2)
    for opts, params in (
            (DenseSegmentationOptions(chunk_size=3),
             ov.OversegParams(descriptor="color_mean_variance",
                              merge_threshold=0.1, split_threshold=0.75,
                              gradient_trait=True)),
            (DenseSegmentationOptions(chunk_size=3,
                                      two_stage_oversegment=True), None)):
        ds = dense.DenseSegmentation(opts, 128, 16, solver_params=params,
                                     device="cpu")
        rs = region.RegionSegmentation(RegionSegmentationOptions(
            chunk_set_size=2, chunk_set_overlap=1, min_region_num=2,
            max_region_num=40, use_flow=False, appearance_window_size=3,
            save_descriptors=True), 128, 16, device="cpu")
        res = []
        for i, fr in enumerate(frames):
            rs.add_frame(i, fr)
            res += rs.process_frames(False, ds.process_frame(False, fr))
        res += rs.process_frames(True, ds.process_frame(True))
        assert [sf.frame_index for sf in res] == list(range(7))
        assert any(sf.hierarchy for sf in res)
    # The device mesh on a (1,4) mesh of CPU entries: the entry step and
    # the multi-device dry run (presmooth, banded solve, mesh stream,
    # agglomeration, each against its single-device result).
    from video_segment_tpu_torch.parallel import entry as pentry
    from video_segment_tpu_torch.parallel import mesh as pmesh
    fn, ex = pentry.entry(device="cpu")
    assert tuple(fn(*ex).shape) == (4, 64, 64)
    assert pentry.dryrun_multichip(4, device="cpu")["mesh"] == \
        pmesh.make_mesh(4, device="cpu").shape == {"data": 1, "space": 4}
    root = pipeline.Unit("src")
    root.add_child(conversion.flip_bgr_unit()).add_child(
        conversion.luminance_unit())
    lum = [x for _, x in pipeline.UnitTree(root).run(iter(frames))]
    assert len(lum) == 7 and lum[0].shape == (16, 128)
    assert not any(m.endswith(("segment_util.render", "segment_util.metrics"))
                   for m in sys.modules)
    loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                    and any(m == b or m.startswith(b + ".")
                            for b in BLOCKED))
    assert not loaded, loaded
    print("ok", len(out))
""")


def test_port_runs_without_jax_cv2_protobuf():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok 7")


CLI_SCRIPT = textwrap.dedent("""
    import os, sys, tempfile
    BLOCKED = ("video_segment_tpu", "jax", "jaxlib")
    for name in BLOCKED:
        sys.modules[name] = None
    import cv2
    import numpy as np
    import torch
    torch.set_num_threads(2)
    from video_segment_tpu_torch.core import batch
    from video_segment_tpu_torch.tools import (batch_segment, converter,
                                               renderer, seg_tree,
                                               video_example, viewer)

    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tiny.avi")
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10.0,
                             (32, 24))
        base = (rng.random((24, 32, 3)) * 80 + 40).astype(np.uint8)
        for f in range(6):
            img = base.copy()
            img[6:18, 4 + 2 * f:16 + 2 * f] = (220, 180, 90)
            vw.write(img)
        vw.release()
        rc = seg_tree.main(["--input_file", path, "--no-flow",
                            "--over_segment", "--chunk_size", "4",
                            "--max_rate", "0", "--no-dynamic_rate",
                            "--device", "cpu"])
        assert rc == 0, rc
        assert os.listdir(tmp) == ["tiny.avi"]
    loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                    and any(m == b or m.startswith(b + ".")
                            for b in BLOCKED))
    assert not loaded, loaded
    print("cli ok")
""")


def test_cli_modules_run_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", CLI_SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "Processed 6 frames" in proc.stdout
    assert proc.stdout.strip().endswith("cli ok")
