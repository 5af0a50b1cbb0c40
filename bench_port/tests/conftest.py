import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# A small flow-on `seg_tree` configuration on the CPU: 64x128, 4-frame
# chunks (so that 24 frames make two chunk sets and a seam), flow on, over
# rigid-texture clips whose drawn motion the flow check reads.
FLOW_CONFIG = {
    "name": "flow_small", "width": 128, "height": 64, "use_flow": True,
    "dense_options": {"chunk_size": 4},
    "region_options": {"chunk_set_size": 6, "chunk_set_overlap": 2,
                       "constraint_chunks": 1, "use_flow": True},
}
FLOW_TRAFFIC = {
    "entry": "seg_tree_cli", "clip_frames": 24, "warmup_frames": 9,
    "shapes": 12, "sizes": "fixed", "texture": 20.0, "noise": 3.0,
    "texture_motion": "rigid", "checks": ["flow_epe"],
}


@pytest.fixture(scope="session")
def seg_tree_runs(tmp_path_factory):
    """One 24-frame clip through the `seg_tree_cli` entry on the CPU, as
    the benchmark runs it (polygons only, `.flow` saved), and through
    `seg_tree` with `--keep_rasterization` besides: (truth, stripped .pb,
    kept .pb, .flow)."""
    import torch

    from bench_port import harness
    from bench_port.entries import seg_tree_cli
    from video_segment_tpu_torch.tools import seg_tree
    torch.set_num_threads(4)
    work = str(tmp_path_factory.mktemp("seg_tree"))
    frames, truth = harness.make_clip(FLOW_TRAFFIC, FLOW_CONFIG, 2 ** 33 + 9)
    entry = seg_tree_cli.Entry(FLOW_CONFIG, "cpu", work)
    clip = entry.prepare(frames)
    stripped = os.path.join(work, "stripped.pb")
    out = entry.run_clip(clip, stripped)
    assert out["frames"] == len(frames)
    kept = os.path.join(work, "kept.pb")
    assert seg_tree.main(["--input_file", entry._link(clip), "--output_file",
                          kept, "--write_to_file", "--keep_rasterization",
                          "--device", "cpu", *entry.flags]) == 0
    return truth, stripped, kept, out["files"]["flow"]
