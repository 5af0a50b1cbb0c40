"""The flow check (`checks/flow_epe.py`) on the port's CPU TV-L1 from a
`seg_tree --save_flow` run, on planted faults in its `.flow` file, and
through the harness, which runs the checks a traffic names; the
`seg_tree_cli` entry's flags and its PNG fallback."""

import os
import time

import numpy as np
import pytest
import torch

from bench_port import control, harness
from bench_port.checks import flow_epe
from bench_port.entries import seg_tree_cli
from bench_port.tests.conftest import FLOW_CONFIG, FLOW_TRAFFIC


def _numbers(truth, path):
    return flow_epe.numbers([{"flow": path}], truth, FLOW_CONFIG,
                            FLOW_TRAFFIC)


def test_port_flow_reads_low(seg_tree_runs):
    truth, _, _, flow = seg_tree_runs
    out = _numbers(truth, flow)
    assert out["flow_fields_wrong"] == 0
    # 0.22-0.24 px here; the drawn motion is 1.9 px on average.
    assert out["flow_epe"] < 0.4


@pytest.mark.parametrize("fault", sorted(control.FLOW_FAULTS))
def test_planted_flow_faults_read_high(seg_tree_runs, tmp_path, fault):
    truth, _, _, flow = seg_tree_runs
    sound = _numbers(truth, flow)["flow_epe"]
    out = control._flow_faults({"flow": flow}, truth, FLOW_CONFIG,
                               FLOW_TRAFFIC, str(tmp_path))
    assert out[fault]["flow_fields_wrong"] == 0
    assert out[fault]["flow_epe"] > 3 * sound, (fault, out[fault], sound)


def test_malformed_flow_files_count_wrong(seg_tree_runs, tmp_path):
    truth, _, _, flow = seg_tree_runs
    w, h, ftype, fields, _ = flow_epe.read_flow(flow)
    assert (w, h, ftype, len(fields)) == (128, 64, flow_epe.BACKWARD, 23)
    out = control._flow_faults({"flow": flow}, truth, FLOW_CONFIG,
                               FLOW_TRAFFIC, str(tmp_path))
    assert out["flow_cut_short"]["flow_fields_wrong"] == 23 - 11

    def write(name, head, body, tail=b""):
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(np.asarray(head, "<i4").tobytes()
                    + np.asarray(body, "<f4").tobytes() + tail)
        return _numbers(truth, path)["flow_fields_wrong"]

    nan = fields.copy()
    nan[4, 3, 3, 0] = np.nan
    assert write("nan", [w, h, ftype], nan) == 1
    assert write("forward", [w, h, 0], fields) == 23
    assert write("size", [w, h - 1, ftype], fields) == 23
    assert write("extra", [w, h, ftype], fields, b"\0" * 8) == 1
    assert write("head", [w], []) == 23
    assert _numbers(truth, str(tmp_path / "absent"))["flow_fields_wrong"] \
        == 23


def test_harness_runs_the_named_checks():
    """A run of the small flow cell keeps each clip's `.flow` until the
    check and reports the check's numbers beside their limits."""
    torch.set_num_threads(4)
    manifest, cell, _, _, limits = harness.load_cell("c2_272x480.long140")
    limits = dict(limits, flow_fields_wrong=0, flow_epe=0.4)
    result, lines = harness.run("c2_272x480.long140", 2 ** 33 + 13, 0.0,
                                False, "cpu", time.monotonic(),
                                (manifest, cell, FLOW_CONFIG, FLOW_TRAFFIC,
                                 limits))
    checks = result["checks"]
    assert list(checks)[-2:] == ["flow_fields_wrong", "flow_epe"]
    assert checks["flow_fields_wrong"]["value"] == 0
    assert 0 < checks["flow_epe"]["value"] < 0.4
    assert checks["flow_epe"]["limit"] == 0.4
    assert lines[-1].startswith("check flow_epe: ")


def test_flags_state_the_configuration():
    conf = harness.load_cell("c2_272x480.long140")[2]
    assert seg_tree_cli.flags(conf) == [
        "--no-flow", "--chunk_size", "20", "--region_param",
        "use_flow=false"]
    assert seg_tree_cli.flags(FLOW_CONFIG) == ["--flow", "--chunk_size", "4"]
    for bad in ({"dense_options": {"frac_min_region_size": 0.02}},
                {"dense_options": {"async_tail": False}},
                {"region_options": {"no_such_option": 1}},
                {"flow_params": {"nscales": 1}}):
        with pytest.raises(ValueError):
            seg_tree_cli.flags(dict(FLOW_CONFIG, **bad))


def test_png_sequence_where_ffv1_does_not_read_back(tmp_path, monkeypatch):
    import cv2

    from bench_port import generator
    from video_segment_tpu_torch.dataio import video
    frames = generator.synthetic_clip(5, seed=3, h=64, w=96)
    # A lossy codec in FFV1's place: the frames do not read back.
    monkeypatch.setattr(cv2, "VideoWriter_fourcc",
                        lambda *c: cv2.VideoWriter.fourcc(*"MJPG"))
    entry = seg_tree_cli.Entry(FLOW_CONFIG, "cpu", str(tmp_path))
    clip = entry.prepare(frames)
    assert clip["path"].endswith("%05d.png") and len(clip["files"]) == 5
    src = entry._link(clip)
    assert os.path.dirname(src) != os.path.dirname(clip["path"])
    back = list(video.VideoReader(src))
    assert len(back) == 5 and all(np.array_equal(a, b)
                                  for a, b in zip(frames, back))
