"""The port's spans and counters (`runtime/trace.py`): what a
`segment_frames` stream records, that the counters equal what the region
stage builds, that streams keep their own traces, that under a Kineto
profiler every span is a user range on the profiler's clock (and no range
is opened without one), and what `seg_tree.run` hands back: the flow
engine's, the encoder's and the stages' spans and counters in one
trace."""

import contextlib
import itertools
import sys
import threading
import time

import numpy as np
import pytest
import torch

from video_segment_tpu_torch import api
from video_segment_tpu_torch.core import region as tregion
from video_segment_tpu_torch.core.options import (DenseSegmentationOptions,
                                                  RegionSegmentationOptions)
from video_segment_tpu_torch.runtime.trace import Trace

torch.set_num_threads(2)

H, W = 24, 256
REGION_SPANS = ("region.features", "region.accumulate", "region.tables",
                "region.upload", "region.levels", "region.hierarchy",
                "region.emit")
TAIL_SPANS = ("host_tail.compact", "host_tail.connect", "host_tail.ids",
              "host_tail.rle")
STAGES = ("ingest_preseg", "chunk_solve", "host_tail", "region")
COUNTERS = ("region.sets", "region.regions", "region.table_bytes")


def clip(n, seed=3):
    """A moving disc and bar over a gradient, plus noise: BGR uint8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    base = np.stack([40 + 60 * xx / W, 90 + 40 * yy / H,
                     160 - 50 * xx / W], -1)
    frames = []
    for f in range(n):
        img = base.copy()
        img[(xx - 40 - 9 * f) ** 2 + 4 * (yy - H / 2) ** 2 < 120] = \
            (200, 60, 50)
        img[4:12, 150 + 3 * f:190 + 3 * f] = (30, 180, 90)
        img += rng.normal(0, 4, img.shape)
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return frames


def _stream(frames):
    return api.segment_frames(
        iter(frames), W, H, use_flow=False,
        dense_options=DenseSegmentationOptions(
            chunk_size=4, presmoothing="none", frac_min_region_size=0.05,
            preseg_mode="felz"),
        region_options=RegionSegmentationOptions(
            chunk_set_size=2, chunk_set_overlap=1, min_region_num=3,
            max_region_num=60, use_flow=False),
        device="cpu")


@pytest.fixture(scope="module")
def solo():
    """One 14-frame stream, its set tables recorded as `_set_tables`
    built them."""
    tables = []
    orig = tregion.RegionSegmentation._set_tables

    def recording(self, chunks):
        tb = orig(self, chunks)
        tables.append(tb)
        return tb

    tregion.RegionSegmentation._set_tables = recording
    try:
        stream = _stream(clip(n=14))
        out = list(stream)
    finally:
        tregion.RegionSegmentation._set_tables = orig
    return stream, out, tables


def test_stream_records_every_span_and_counter(solo):
    stream, out, _ = solo
    assert len(out) == 14
    secs = stream.stage_seconds
    for name in STAGES + REGION_SPANS + TAIL_SPANS:
        assert secs.get(name, 0.0) > 0.0, name
    for name in COUNTERS:
        assert stream.counters.get(name, 0) > 0, name
    for parent, subs in (("region", REGION_SPANS), ("host_tail", TAIL_SPANS)):
        assert all(secs[s] <= secs[parent] for s in subs)
        assert sum(secs[s] for s in subs) <= secs[parent]
    # The stages' own views keep their keys.
    assert set(stream.dense.stage_seconds) == {"ingest_preseg",
                                               "chunk_solve", "host_tail"}
    assert stream.region.stage_seconds == {"region": secs["region"]}


def test_counters_equal_the_set_tables(solo):
    stream, _, tables = solo
    opts = stream.region.options
    bins = opts.luminance_bins * opts.color_bins * opts.color_bins
    assert stream.counters["region.sets"] == len(tables) > 1
    assert stream.counters["region.regions"] == sum(tb["r"] for tb in tables)
    nbytes = 0
    for tb in tables:
        # (next_pow2(r + 1), bins) float32 histograms, plus the other
        # statistics tables as they are built.
        rows = tregion._next_pow2(tb["r"] + 1)
        assert tb["hist"].shape == (rows, bins)
        assert tb["hist"].dtype == np.float32
        nbytes += rows * bins * 4
        for k in ("fh", "fc", "sizes", "whist", "wcnt"):
            assert tb[k].dtype == np.float32
            nbytes += tb[k].nbytes
    assert stream.counters["region.table_bytes"] == nbytes


def test_streams_keep_separate_traces(solo):
    """Two streams advanced in turn in one process: each trace counts
    its own stream alone."""
    a, b = _stream(clip(n=14)), _stream(clip(n=9, seed=5))
    assert a.trace is not b.trace
    ia, ib = iter(a), iter(b)
    done = [False, False]
    while not all(done):
        for k, it in enumerate((ia, ib)):
            if not done[k]:
                done[k] = next(it, None) is None
    assert a.counters == solo[0].counters
    assert b.counters["region.sets"] < a.counters["region.sets"]
    assert a.region.trace is a.dense.trace is a.trace


def _profiled(frames):
    """A stream under a Kineto profiler that records user ranges and no
    aten op: (stream, user annotations, time_ns before, time_ns after)."""
    from torch._C._profiler import (ProfilerConfig, ProfilerState,
                                    RecordScope, _ExperimentalConfig)
    from torch.autograd import (ProfilerActivity, _disable_profiler,
                                _enable_profiler, _prepare_profiler)
    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False,
                         False, _ExperimentalConfig())
    acts = {ProfilerActivity.CPU}
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts, {RecordScope.USER_SCOPE})
    try:
        t0 = time.time_ns()
        stream = _stream(frames)
        list(stream)
        t1 = time.time_ns()
    finally:
        events = _disable_profiler().events()
    ann = [e for e in events if e.is_user_annotation()]
    return stream, ann, t0, t1


def test_spans_are_profiler_ranges_on_its_clock(monkeypatch):
    """Every span is a user range of its name on its thread, inside the
    run and inside its parent's range.  Instance by instance, the span's
    seconds lie inside its range's, and the range's inside the seconds of
    two clock reads taken around the span's call.  Each side is a
    duration on one clock, so a thread that the host preempts between a
    clock read and the profiler's stamp moves neither bound."""
    calls = []
    real = Trace.span

    @contextlib.contextmanager
    def recording(self, name, start=None):
        before = time.monotonic()
        with real(self, name, start) as rec:
            yield rec
        calls.append((name, before, rec.start, rec.end, time.monotonic()))

    monkeypatch.setattr(Trace, "span", recording)
    stream, ann, t0, t1 = _profiled(clip(n=9))
    secs = stream.stage_seconds
    names = {e.name() for e in ann}
    assert set(STAGES + REGION_SPANS + TAIL_SPANS) <= names
    assert names <= set(secs)
    ranges = [(e.name(), e.start_thread_id(), e.start_ns(),
               e.start_ns() + e.duration_ns()) for e in ann]
    for name, tid, s, e in ranges:
        assert t0 <= s <= e <= t1, name
        if "." in name:
            parent = name.split(".")[0]
            assert any(n == parent and t == tid and ps <= s and e <= pe
                       for n, t, ps, pe in ranges), name
    for name in names:
        mine = sorted((s, e) for n, _, s, e in ranges if n == name)
        theirs = sorted(c[1:] for c in calls if c[0] == name)
        assert len(mine) == len(theirs), name
        for (s, e), (before, start, end, after) in zip(mine, theirs):
            assert end - start <= (e - s) * 1e-9 <= after - before, name
        assert secs[name] == pytest.approx(
            sum(end - start for _, start, end, _ in theirs)), name


def test_no_range_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    stream = _stream(clip(n=6))
    assert len(list(stream)) == 6
    assert stream.stage_seconds["region.levels"] > 0.0


def test_trace_is_safe_across_threads():
    """Many threads add to one trace at once, with the interpreter
    switching threads as often as it can: no update is lost."""
    trace = Trace()
    n_threads, n_each = 16, 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for _ in range(n_each):
            with trace.span("s"):
                trace.count("c")
            trace.count("bytes", 3)

    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert trace.counters == {"c": n_threads * n_each,
                              "bytes": 3 * n_threads * n_each}
    assert trace.seconds["s"] > 0.0


def test_span_from_an_earlier_start(monkeypatch):
    trace = Trace()
    # A stepped clock: 21 ms pass between the start and the block's end.
    monkeypatch.setattr(trace, "now", itertools.count(100.0, 0.021).__next__)
    start = trace.now()
    with trace.span("late", start=start) as rec:
        pass
    assert rec.start == start and rec.end >= start + 0.02
    assert trace.seconds["late"] == pytest.approx(rec.end - start)
    assert "spans" in trace.summary(4) and "late 5." in trace.summary(4)


def test_seg_tree_run_spans_flow_and_encoder(tmp_path, monkeypatch):
    """`seg_tree.run` with flow on and `--write_to_file` over 13 frames:
    one `flow` span a micro-batch of 6 pairs (frame 0 has no flow), one
    `encode` span a frame with its `encode.vectorize` inside it on the
    same thread, and counters that match the frames and pairs."""
    import cv2

    from video_segment_tpu_torch.tools import seg_tree
    frames = clip(n=13)
    for i, f in enumerate(frames):
        cv2.imwrite(str(tmp_path / f"{i:05d}.png"), f)
    spans = []
    real = Trace.span

    @contextlib.contextmanager
    def recording(self, name, start=None):
        with real(self, name, start) as rec:
            yield rec
        spans.append((name, threading.get_ident(), rec.start, rec.end))

    monkeypatch.setattr(Trace, "span", recording)
    rc, trace = seg_tree.run([
        "--input_file", str(tmp_path / "%05d.png"), "--output_file",
        str(tmp_path / "out.pb"), "--write_to_file", "--chunk_size", "4",
        "--device", "cpu"])
    assert rc == 0
    secs, counters = trace.seconds, trace.counters
    by = {}
    for name, tid, start, end in spans:
        assert start <= end, name
        by.setdefault(name, []).append((tid, start, end))
    assert len(by["flow"]) == 2
    assert counters["flow.pairs"] == 12
    assert len(by["encode"]) == len(by["encode.vectorize"]) == 13
    for tid, s, e in by["encode.vectorize"]:
        assert any(t == tid and ps <= s and e <= pe
                   for t, ps, pe in by["encode"])
    assert 0 < secs["encode.vectorize"] <= secs["encode"]
    assert secs["flow"] > 0
    assert counters["encode.rings"] >= 13
    for name in STAGES + ("region.levels",) + COUNTERS:
        assert name in secs or name in counters, name
