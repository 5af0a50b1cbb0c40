"""The port's fused multi-clip dense stage against standalone runs and
against the JAX BatchDenseSegmentation.

The cases of tests/test_batch_dense.py (two clips over free and constrained
chunks; uneven lengths; banded through the scaled voxel budget) on
`video_segment_tpu_torch.core.batch`, each held to every clip's standalone
streaming run in the port and to the JAX class on the same clips, plus
per-clip flow arrays and three clips of which two share a chunk class.
Seeded 32x24 clips, chunk_size 5, `preseg_mode="felz"` pinned on both sides
(the packages resolve "auto" differently off a TPU).  Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from video_segment_tpu.core import batch as jbatch
from video_segment_tpu.core.options import DenseSegmentationOptions
from video_segment_tpu_torch.core import batch as tbatch
from video_segment_tpu_torch.core import dense as tdense
from video_segment_tpu_torch.core.options import options_from_jax

torch.set_num_threads(2)

W, H = 32, 24


def clip(n_frames, seed, h=H, w=W):
    rng = np.random.default_rng(seed)
    base = rng.integers(30, 60, 3)
    frames = []
    for f in range(n_frames):
        img = np.full((h, w, 3), base, np.uint8)
        x0 = 2 + f + seed
        img[8:16, x0:x0 + 8] = 200 + seed * 5
        frames.append(img)
    return frames


def flows_of(n_frames, seed, h=H, w=W):
    """Per-frame backward flow arrays (None for the first frame)."""
    rng = np.random.default_rng(100 + seed)
    return [None] + [rng.normal(0, 1.0, (h, w, 2)).astype(np.float32)
                     for _ in range(n_frames - 1)]


def jopts(**kw):
    return DenseSegmentationOptions(chunk_size=5, presmoothing="gaussian",
                                    frac_min_region_size=0.05,
                                    async_tail=False, preseg_mode="felz",
                                    **kw)


def run_single(frames, flows=None, **kw):
    ds = tdense.DenseSegmentation(options_from_jax(jopts(**kw)), W, H,
                                  device="cpu")
    out = []
    for i, fr in enumerate(frames):
        out += ds.process_frame(False, fr, None if flows is None
                                else flows[i])
    return out + ds.process_frame(True), ds


def run_batch(bd, clips, flows=None):
    """Lockstep over the longest clip; a shorter clip is flushed through
    its own stage exactly when its stream ends."""
    n = len(clips)
    outs = [[] for _ in range(n)]
    ended = [False] * n
    for step in range(max(len(c) for c in clips)):
        frames = [c[step] if step < len(c) else None for c in clips]
        fl = (None if flows is None else
              [f[step] if step < len(f) else None for f in flows])
        got = bd.process_frames(False, frames, fl)
        for i in range(n):
            outs[i] += got[i]
            if step >= len(clips[i]) and not ended[i]:
                outs[i] += bd.clips[i].process_frame(True)
                ended[i] = True
    got = bd.process_frames(True)
    for i in range(n):
        outs[i] += got[i]
    return outs


def assert_frames_equal(a, b):
    assert len(a) == len(b)
    for sa, sb in zip(a, b):
        assert sa.frame_index == sb.frame_index
        for f in ("region_ids", "interval_counts", "ys", "lxs", "rxs"):
            np.testing.assert_array_equal(getattr(sa, f), getattr(sb, f),
                                          err_msg=f"frame {sa.frame_index} "
                                                  f"{f}")
        assert (sa.hierarchy is None) == (sb.hierarchy is None)
        if sa.hierarchy is not None:
            for f in ("ids", "sizes", "neighbor_pairs"):
                np.testing.assert_array_equal(
                    getattr(sa.hierarchy[0], f), getattr(sb.hierarchy[0], f))


CASES = {
    # name: (clip lengths and seeds, fused budget, standalone budget)
    "even": ([(12, 0), (12, 3)], None, None),
    "uneven": ([(12, 1), (8, 4)], None, None),
    "banded": ([(12, 0), (12, 3)], 9_000, 4_500),
}


def budget(voxels):
    return {} if voxels is None else {"max_solve_voxels": voxels}


@pytest.mark.parametrize("case", list(CASES))
def test_batch_matches_per_clip(case):
    """Each clip's fused output equals its standalone streaming run (at
    the same band decomposition), with one solve_diag entry per chunk
    solve."""
    spec, fused, single = CASES[case]
    clips = [clip(n, s) for n, s in spec]
    bd = tbatch.BatchDenseSegmentation(
        options_from_jax(jopts(**budget(fused))), W, H, len(clips),
        device="cpu")
    outs = run_batch(bd, clips)
    for i, frames in enumerate(clips):
        want, ds = run_single(frames, **budget(single))
        assert_frames_equal(outs[i], want)
        assert len(bd.clips[i].solve_diag) == len(ds.solve_diag) > 1
        assert ds._bands == bd.clips[i]._bands
    if case == "banded":
        assert bd.clips[0]._bands > 1    # the scaled budget forced bands
    assert all(sum(g) <= len(clips) for g in bd.group_sizes)
    if case == "even":
        assert bd.group_sizes == [[2]] * len(bd.group_sizes)


@pytest.mark.parametrize("case", list(CASES))
def test_batch_matches_jax_batch(case):
    spec, fused, _ = CASES[case]
    clips = [clip(n, s) for n, s in spec]
    opts = jopts(**budget(fused))
    jbd = jbatch.BatchDenseSegmentation(opts, W, H, len(clips))
    want = run_batch(jbd, clips)
    bd = tbatch.BatchDenseSegmentation(options_from_jax(opts), W, H,
                                       len(clips), device="cpu")
    got = run_batch(bd, clips)
    assert jbd.clips[0]._bands == bd.clips[0]._bands
    for i in range(len(clips)):
        assert_frames_equal(got[i], want[i])


def test_batch_with_per_clip_flows():
    """Flow arrays per clip reach each clip's solver and connectedness."""
    clips = [clip(12, 0), clip(12, 3)]
    flows = [flows_of(12, 0), flows_of(12, 3)]
    bd = tbatch.BatchDenseSegmentation(options_from_jax(jopts()), W, H, 2,
                                       device="cpu")
    outs = run_batch(bd, clips, flows)
    jbd = jbatch.BatchDenseSegmentation(jopts(), W, H, 2)
    jouts = run_batch(jbd, clips, flows)
    for i in range(2):
        want, _ = run_single(clips[i], flows[i])
        assert_frames_equal(outs[i], want)
        assert_frames_equal(outs[i], jouts[i])


def test_batch_three_clips_two_share_a_signature():
    """Clips 0 and 2 stream in step (one chunk class a step); clip 1 gets
    its frames one step late, so its chunks come ready alone."""
    clips = [clip(12, 0), clip(11, 2), clip(12, 5)]
    bd = tbatch.BatchDenseSegmentation(options_from_jax(jopts()), W, H, 3,
                                       device="cpu")
    outs = [[], [], []]
    for step in range(12):
        frames = [clips[0][step],
                  clips[1][step - 1] if step >= 1 else None,
                  clips[2][step]]
        got = bd.process_frames(False, frames)
        for i in range(3):
            outs[i] += got[i]
    got = bd.process_frames(True)
    for i in range(3):
        outs[i] += got[i]
        assert_frames_equal(outs[i], run_single(clips[i])[0])
    assert [2] in bd.group_sizes and [1] in bd.group_sizes
    # The flush step: clips 0 and 2 hold the same tail, clip 1 one less
    # frame of the same canonical extent.
    assert sorted(bd.group_sizes[-1]) in ([1, 2], [3])


def test_batch_rejects_bad_configurations():
    opts = options_from_jax(jopts())
    with pytest.raises(ValueError, match="n_clips"):
        tbatch.BatchDenseSegmentation(opts, W, H, 0, device="cpu")
    # 16 bands at most: 40 clips of 6 x 24 x 32 voxels over a 64-voxel
    # budget leave a batched band far over twice the budget.
    with pytest.raises(ValueError, match="footprint"):
        tbatch.BatchDenseSegmentation(
            options_from_jax(jopts(max_solve_voxels=64)), W, H, 40,
            device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            tbatch.BatchDenseSegmentation(opts, W, H, 2)
