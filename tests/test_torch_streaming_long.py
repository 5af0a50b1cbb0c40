"""The port's long-stream behaviour against the JAX package's.

Counterpart of `tests/test_streaming_long.py` on the same seeded frames
(a bright block sliding over a grey field): over a 60-frame stream the
dense buffer stays within `chunk_size + 1` frames, the region stage's
per-frame features within four chunks and its buffered chunks within the
chunk set, every frame is emitted once and in order; over 17 frames the
chunk ids of the hierarchy frames count up from 0 and each one's
`hierarchy_frame_idx` points at itself.  That is the bounded memory a
long stream (bench config 4's streaming clip) relies on.  Each test also
holds the port's emitted frames (RLE, region ids, chunk fields) and
hierarchies to the JAX package's, exactly: `preseg_mode="felz"` is pinned
(the JAX package picks flood off a TPU) and the port's Lab conversion is
replaced by cv2's, as in `tests/test_torch_region.py`.
"""

import numpy as np
import torch

from video_segment_tpu.core import dense as jdense
from video_segment_tpu.core import region as jregion
from video_segment_tpu.core.options import (DenseSegmentationOptions,
                                            RegionSegmentationOptions)
from video_segment_tpu_torch.core import dense as tdense
from video_segment_tpu_torch.core import region as tregion
from video_segment_tpu_torch.core.options import options_from_jax

from test_torch_dense import assert_frames_equal
from test_torch_region import _cv2_lab

torch.set_num_threads(2)

H, W = 20, 28


def _frame(f, h=H, w=W):
    img = np.full((h, w, 3), 60, np.uint8)
    img[5:15, (2 + f) % (w - 8):(2 + f) % (w - 8) + 8] = 210
    return img


def _dense_options(chunk_size):
    return DenseSegmentationOptions(chunk_size=chunk_size,
                                    presmoothing="gaussian",
                                    frac_min_region_size=0.1,
                                    preseg_mode="felz")


def _stream(ds, rs, n):
    """Feed n frames through the dense and region stages; returns the
    emitted frames and the largest dense buffer, feature buffer and chunk
    buffer seen."""
    emitted, peaks = [], [0, 0, 0]
    for f in range(n):
        rs.add_frame(f, _frame(f))
        emitted += rs.process_frames(False, ds.process_frame(False, _frame(f)))
        peaks = [max(p, x) for p, x in zip(
            peaks, (len(ds._buffer), len(rs._features), len(rs._chunks)))]
    emitted += rs.process_frames(True, ds.process_frame(True))
    return emitted, peaks


def _assert_hierarchies_equal(got, want):
    for a, b in zip(got, want):
        assert (a.hierarchy is None) == (b.hierarchy is None)
        if a.hierarchy is None:
            continue
        assert len(a.hierarchy) == len(b.hierarchy)
        for la, lb in zip(a.hierarchy, b.hierarchy):
            np.testing.assert_array_equal(la.ids, lb.ids)
            np.testing.assert_array_equal(np.asarray(la.sizes),
                                          np.asarray(lb.sizes))
            assert (la.parent_ids is None) == (lb.parent_ids is None)
            if la.parent_ids is not None:
                np.testing.assert_array_equal(la.parent_ids, lb.parent_ids)


def test_long_stream_bounded_buffers_match_jax(monkeypatch):
    _cv2_lab(monkeypatch)
    d = _dense_options(6)
    r = RegionSegmentationOptions(chunk_set_size=3, chunk_set_overlap=1,
                                  min_region_num=2, max_region_num=40,
                                  use_flow=False)
    n = 60
    ds = tdense.DenseSegmentation(options_from_jax(d), W, H, device="cpu")
    got, peaks = _stream(ds, tregion.RegionSegmentation(
        options_from_jax(r), W, H, device="cpu"), n)
    want, jpeaks = _stream(jdense.DenseSegmentation(d, W, H),
                           jregion.RegionSegmentation(r, W, H), n)

    assert [sf.frame_index for sf in got] == list(range(n))
    max_dense_buf, max_feat_buf, max_chunks = peaks
    assert max_dense_buf <= d.chunk_size + 1
    assert max_feat_buf <= 4 * d.chunk_size
    assert max_chunks <= 3
    assert peaks == jpeaks
    assert ds._max_region_id > 0
    assert sum(sf.hierarchy is not None for sf in got) >= 3
    assert_frames_equal(got, want)
    _assert_hierarchies_equal(got, want)


def test_chunk_ids_monotone_match_jax():
    d = _dense_options(5)

    def run(ds):
        out = []
        for f in range(17):
            out += ds.process_frame(False, _frame(f))
        return out + ds.process_frame(True)

    got = run(tdense.DenseSegmentation(options_from_jax(d), W, H,
                                       device="cpu"))
    want = run(jdense.DenseSegmentation(d, W, H))
    hier_frames = [sf for sf in got if sf.hierarchy is not None]
    assert [sf.chunk_id for sf in hier_frames] == list(
        range(len(hier_frames)))
    assert len(hier_frames) >= 3
    for sf in hier_frames:
        assert sf.hierarchy_frame_idx == sf.frame_index
    assert_frames_equal(got, want)
    _assert_hierarchies_equal(got, want)
