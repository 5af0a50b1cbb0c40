"""The checks of the flow-on `seg_tree` cell that read what the entry
`seg_tree_spans` returns, and the metrics that read its spans, on the CPU
at 64x128: `flow_ref` (the program's `.flow` against the plain TV-L1
beside it) reads 0 on the reference's own field, far under the cell's
limit on the program's, and far over it on the planted `.flow` faults and
the one-scale control; `frame_state` reads 0 on the program's `.pb` and
fails the planted `.pb` faults; `min_region` counts the tiny level-0
regions, under a twentieth of the configuration's minimum."""

import json
import os

import numpy as np
import pytest
import torch

from bench_port import compare, control, harness
from bench_port.checks import (_tvl1_ref, flow_epe, flow_ref, frame_state,
                               min_region)
from bench_port.entries import seg_tree_spans
from bench_port.tests.conftest import FLOW_CONFIG, ROOT

TRAFFIC = {
    "entry": "seg_tree_spans", "clip_frames": 13, "warmup_frames": 13,
    "shapes": 12, "sizes": "fixed", "texture": 20.0, "noise": 3.0,
    "texture_motion": "rigid",
    "checks": ["flow_epe", "flow_ref", "frame_state", "min_region"],
}
SEED = 2 ** 33 + 21
METRICS = {"flow_ms_per_frame": "flow", "encode_ms_per_frame": "encode",
           "vectorize_ms_per_frame": "encode.vectorize"}


def _limits():
    with open(os.path.join(ROOT, "bench_port", "limits",
                           "flow_272x480.segtree40.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One clip through the entry as stated, and with the one-scale TV-L1
    control: (frames, truth, work dir, sound clip, control clip)."""
    torch.set_num_threads(4)
    work = str(tmp_path_factory.mktemp("flow_ref"))
    frames, truth = harness.make_clip(TRAFFIC, FLOW_CONFIG, SEED)
    entry = seg_tree_spans.Entry(FLOW_CONFIG, "cpu", work)
    clip = entry.prepare(frames)
    sound = entry.run_clip(clip, os.path.join(work, "sound.pb"))
    from video_segment_tpu_torch.core.flow import TVL1Params
    with control.program_option("video_segment_tpu_torch.core.flow",
                                "FlowEngine", params=TVL1Params(nscales=1)):
        low = entry.run_clip(clip, os.path.join(work, "low.pb"))
    return frames, truth, work, sound, low


def _numbers(files):
    return flow_ref.numbers(files, None, FLOW_CONFIG, TRAFFIC)


def test_entry_returns_spans_counters_and_its_input(runs):
    frames, _, _, sound, _ = runs
    assert sound["frames"] == len(frames)
    for name in ("flow", "encode", "encode.vectorize", "ingest_preseg",
                 "region"):
        assert sound["stage_seconds"][name] > 0, name
    counters = sound["counters"]
    assert counters["flow.pairs"] == len(frames) - 1
    assert counters["encode.rings"] > 0 and "encode.ring_fallbacks" in \
        counters
    assert os.path.exists(sound["files"]["clip"])
    assert np.array_equal(np.load(sound["files"]["frames"]), np.stack(frames))
    assert os.path.exists(sound["files"]["pb"])


def test_new_metrics_read_the_spans(runs):
    from importlib import import_module
    _, _, _, sound, _ = runs
    rec = {"stage_seconds": sound["stage_seconds"],
           "stage_frames": sound["frames"]}
    for metric, span in METRICS.items():
        mod = import_module(f"bench_port.metrics.{metric}")
        assert mod.read(rec) == pytest.approx(
            1e3 * sound["stage_seconds"][span] / sound["frames"])
        # A program without the span (the parent's long140 records).
        assert mod.read({"stage_seconds": {"region": 1.0},
                         "stage_frames": 10}) is None


def test_reference_field_reads_zero(runs, tmp_path):
    frames, _, _, sound, _ = runs
    fields = [_tvl1_ref.flow_bgr(a, b) for a, b in zip(frames, frames[1:])]
    path = str(tmp_path / "ref.flow")
    h, w = frames[0].shape[:2]
    with open(path, "wb") as f:
        f.write(np.asarray([w, h, flow_epe.BACKWARD], "<i4").tobytes())
        for x in fields:
            f.write(np.asarray(x, "<f4").tobytes())
    out = _numbers([{"flow": path, "frames": sound["files"]["frames"]}])
    assert out == {"flow_ref_err": 0.0}


def test_sound_flow_passes_and_the_control_fails(runs):
    _, _, _, sound, low = runs
    limit = _limits()["flow_ref_err"]
    good = _numbers([sound["files"]])["flow_ref_err"]
    bad = _numbers([low["files"]])["flow_ref_err"]
    # About 3e-6 px here: the same float32 arithmetic in another order.
    assert good < limit / 10
    assert bad > 3 * limit and bad > 1000 * good


@pytest.fixture(scope="module")
def faults(runs):
    """The traffic's checks over the planted copies of the sound `.flow`."""
    _, truth, work, sound, _ = runs
    return control._flow_faults(sound["files"], truth, FLOW_CONFIG, TRAFFIC,
                                work)


@pytest.mark.parametrize("fault", sorted(control.FLOW_FAULTS))
def test_planted_flow_faults_fail(faults, fault):
    assert faults[fault]["flow_ref_err"] > 100 * _limits()["flow_ref_err"]


def test_cut_short_fails_flow_epe_alone(faults):
    """The fields a cut file still holds are sound; `flow_epe` counts the
    missing ones."""
    cut = faults["flow_cut_short"]
    assert cut["flow_ref_err"] < _limits()["flow_ref_err"]
    assert cut["flow_fields_wrong"] > 0


def test_the_two_compared_clips_share_one_reference(runs, monkeypatch):
    _, _, _, sound, _ = runs
    calls = []
    real = _tvl1_ref.flow_bgr

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    flow_ref._last.clear()
    monkeypatch.setattr(_tvl1_ref, "flow_bgr", counting)
    a = _numbers([sound["files"], sound["files"]])
    assert len(calls) == TRAFFIC["clip_frames"] - 1
    assert a == _numbers([sound["files"]])


def test_entry_refuses_a_program_without_run(monkeypatch, tmp_path):
    from video_segment_tpu_torch.tools import seg_tree
    monkeypatch.delattr(seg_tree, "run")
    with pytest.raises(RuntimeError, match="run"):
        seg_tree_spans.Entry(FLOW_CONFIG, "cpu", str(tmp_path))


def _labels(clip, n):
    sets, _ = compare.program_sets(clip["files"]["pb"], n,
                                   FLOW_CONFIG["width"],
                                   FLOW_CONFIG["height"])
    return np.concatenate([lab for lab, _ in sets])


def test_frame_state_passes_the_program_and_fails_planted_faults(runs):
    _, truth, _, sound, _ = runs
    got = frame_state.numbers([sound["files"], sound["files"]], truth,
                              FLOW_CONFIG, TRAFFIC)
    assert got == {"frames_unmoved": 0, "frames_collapsed": 0}
    lab = _labels(sound, len(truth["objects"]))
    frozen = np.repeat(lab[:1], len(lab), 0)
    assert frame_state.frame_numbers(frozen, truth) == {
        "frames_unmoved": len(lab) - 1, "frames_collapsed": 0}
    merged = lab.copy()
    merged[len(lab) // 2] = merged[len(lab) // 2].flat[0]
    assert frame_state.frame_numbers(merged, truth) == {
        "frames_unmoved": 0, "frames_collapsed": 1}


def test_frames_unmoved_counts_only_where_the_scene_moved():
    objects = np.zeros((3, 4, 4), np.int64)
    objects[:, :, :2] = 1
    labels = np.where(objects == 1, 7, 8)
    still = {"objects": objects}
    assert frame_state.frame_numbers(labels, still)["frames_unmoved"] == 0
    flow = np.zeros((3, 4, 4, 2), np.float32)
    flow[2, 0, 0, 0] = 1.0
    moved = {"objects": objects, "flow": flow}
    assert frame_state.frame_numbers(labels, moved)["frames_unmoved"] == 1


def test_min_region_counts_tiny_regions(runs):
    """The program passes at this size (a minimum of 3 voxels, so no
    region is tiny); the cell's 272x480 minimum is 261 voxels, and a
    region is tiny under 13."""
    _, truth, _, sound, _ = runs
    assert min_region.min_voxels(FLOW_CONFIG) == 3
    got = min_region.numbers([sound["files"]], truth, FLOW_CONFIG, TRAFFIC)
    assert got == {"tiny_regions_per_frame": 0.0}
    with open(os.path.join(ROOT, "bench_port", "configs",
                           "flow_272x480.json")) as f:
        assert min_region.min_voxels(json.load(f)) == 261
    lab = np.zeros((2, 10, 10), np.int64)
    lab[0, 0, 0] = 5
    lab[1, :3, :3] = 6
    lab[1, 5, 5] = 7
    assert min_region.tiny_per_frame(lab, 261) == 3 / 2
    assert min_region.tiny_per_frame(lab, 180) == 2 / 2
