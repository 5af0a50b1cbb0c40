"""The check that decides `correct`: a run of the rest of the harness on
the CPU at a small size (64x128, 4-frame chunks, so that 41 frames make
four chunk sets and three seams) is correct as it stands, and comes out
not correct with the timed path broken underneath (a frame's answer
altered, half of the frames left out, a stream whose state never
advances) and with the control (the minimum region size off) in the
program's place."""

import time

import numpy as np
import pytest
import torch

from bench_port import control, harness

CELL = "c2_272x480.long140"


def small_cell(config_name="c2_272x480"):
    manifest, cell, config, traffic, limits = harness.load_cell(CELL)
    config = dict(config, width=128, height=64,
                  dense_options=dict(config["dense_options"], chunk_size=4))
    # The generator's default texture: at this size it gives the frame
    # about the cell's density of regions.
    traffic = dict(traffic, clip_frames=41, warmup_frames=9, texture=20.0,
                   noise=3.0)
    return manifest, cell, config, traffic, limits


def _merge_all(sf):
    sf.region_ids = sf.region_ids[:1].copy()
    sf.interval_counts = np.array([int(sf.interval_counts.sum())])
    if sf.moments is not None:
        sf.moments = sf.moments[:1].copy()
    return sf


def _faulty(stream, fault):
    first = None
    for sf in stream:
        if fault == "altered" and sf.frame_index == 20:
            sf = _merge_all(sf)
        elif fault == "half_left_out" and sf.frame_index % 2:
            continue
        elif fault == "unchanged_state":
            if first is None:
                first = sf
            else:
                for k in ("region_ids", "interval_counts", "ys", "lxs",
                          "rxs", "moments"):
                    v = getattr(first, k)
                    setattr(sf, k, None if v is None else v.copy())
        yield sf


class _Stream:
    def __init__(self, stream, fault):
        self.stream = stream
        self._it = _faulty(stream, fault)

    def __iter__(self):
        return self._it

    @property
    def stage_seconds(self):
        return self.stream.stage_seconds

    @property
    def counters(self):
        return self.stream.counters


def _run(monkeypatch, fault=None, seed=2 ** 33 + 3):
    torch.set_num_threads(2)
    if fault is not None:
        from video_segment_tpu_torch import api
        real = api.segment_frames
        monkeypatch.setattr(api, "segment_frames",
                            lambda *a, **k: _Stream(real(*a, **k), fault))
    result, lines = harness.run(CELL, seed, 0.0, False, "cpu",
                                time.monotonic(), small_cell())
    assert list(result)[-1] == "checks" and len(lines) == 3
    return result


# The check's numbers of two runs of the small cell, read before the
# polygon rasterizer, the named checks and the drawn motion were added.
BEFORE = {2 ** 33 + 3: 0.106201171875, 17: 0.0496826171875}


def _as_before(checks, seed):
    assert {k: c["value"] for k, c in checks.items()} == {
        "frames_wrong": 0, "hierarchy_faults": 0, "leak": BEFORE[seed]}


def test_sound_run_is_correct(monkeypatch):
    result = _run(monkeypatch)
    assert result["correct"], result["checks"]
    assert result["checks"]["hierarchy_faults"]["value"] == 0
    _as_before(result["checks"], 2 ** 33 + 3)


def test_check_numbers_as_before(monkeypatch):
    _as_before(_run(monkeypatch, seed=17)["checks"], 17)


def test_clip_sums():
    clips = [{"stage_seconds": {"region": 1.5}, "counters": {"n": 2}},
             {"stage_seconds": {"region": 0.25, "flow": 1.0},
              "counters": {"n": 3, "m": 1}}, {}]
    assert harness.clip_sums(clips, "stage_seconds") == {"region": 1.75,
                                                         "flow": 1.0}
    assert harness.clip_sums(clips, "counters") == {"n": 5, "m": 1}


def test_api_stream_returns_counters(tmp_path):
    from bench_port import generator
    from bench_port.entries import api_stream
    torch.set_num_threads(2)
    _, _, config, _, _ = small_cell()
    frames = generator.synthetic_clip(9, seed=2, h=64, w=128)
    entry = api_stream.Entry(config, "cpu", str(tmp_path))
    out = entry.run_clip(entry.prepare(frames), str(tmp_path / "c.pb"))
    assert out["frames"] == 9 and out["stage_seconds"]["region"] > 0
    assert out["counters"]["region.sets"] >= 1


@pytest.mark.parametrize("fault", ["altered", "half_left_out",
                                   "unchanged_state"])
def test_broken_path_is_not_correct(monkeypatch, fault):
    result = _run(monkeypatch, fault)
    assert not result["correct"], result["checks"]


def test_control_is_not_correct():
    torch.set_num_threads(2)
    r = control.readings(CELL, 5, "cpu", small_cell())
    assert r["sound_passes"] and not r["passes"], r
    assert not any(f["passes"] for f in r["faults"].values()), r


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_fails_at_cell_size(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's size")
    r = control.readings(CELL, seed, "cuda")
    assert r["sound_passes"] and not r["passes"], r
