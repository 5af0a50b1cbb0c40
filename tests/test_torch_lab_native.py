"""The region stage's native BGR->Lab pass against its NumPy body.

- `native.bgr_to_lab_u8` equals `region._bgr_to_lab_numpy` byte for byte
  on all 2^24 BGR colours, on non-contiguous views and on a 1x1 frame,
  and its channel sums are the NumPy body's.
- The float32 frame mean from the native sums is NumPy's mean of the Lab.
- `RegionSegmentation.add_frame` takes the native pass where the library
  builds (counter `region.lab_native`, one per frame), the NumPy body
  where it does not, and a conversion put in place of
  `region.bgr_to_lab_u8` wherever one is (the parity tests put cv2's
  there).
- A short clip gives the same SegFrames on both paths, with windowed
  appearance too (whose gains read the frame means).
"""

import numpy as np
import pytest
import torch

from video_segment_tpu_torch import api as tapi
from video_segment_tpu_torch import native as tnative
from video_segment_tpu_torch.core import region as tregion
from video_segment_tpu_torch.core.options import (DenseSegmentationOptions,
                                                  RegionSegmentationOptions)

torch.set_num_threads(2)

H, W = 24, 96


def _native(frame):
    return tnative.bgr_to_lab_u8(frame, tregion._GAMMA_TAB,
                                 tregion._CBRT_TAB, tregion._XYZ_COEFFS)


def _frames(n=10, h=H, w=W, seed=4):
    """Drifting gradients, two moving blocks and noise, BGR uint8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([30 + 150 * xx / w, 200 - 120 * yy / h,
                     60 + 90 * (xx + yy) / (h + w)], -1)
    out = []
    for f in range(n):
        img = base + 3 * f
        img[4:14, 10 + 4 * f:30 + 4 * f] = (220, 40, 70)
        img[12:22, 60 - 2 * f:80 - 2 * f] = (20, 160, 240)
        img += rng.normal(0, 5, img.shape)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def test_native_lab_equals_numpy_on_every_colour():
    assert tnative.available()
    g = np.arange(256, dtype=np.uint8)
    frame = np.empty((256, 256, 3), np.uint8)
    frame[..., 1], frame[..., 2] = np.meshgrid(g, g, indexing="ij")
    for b in range(256):
        frame[..., 0] = b
        lab, sums = _native(frame)
        want = tregion._bgr_to_lab_numpy(frame)
        assert lab.dtype == np.uint8 and lab.shape == frame.shape
        assert np.array_equal(lab, want), f"blue plane {b}"
        np.testing.assert_array_equal(
            sums, want.reshape(-1, 3).sum(axis=0, dtype=np.int64))


@pytest.mark.parametrize("view", ["cropped", "channels_reversed",
                                  "one_pixel"])
def test_native_lab_equals_numpy_on_views(view):
    frame = np.random.default_rng(7).integers(0, 256, (40, 70, 3),
                                              dtype=np.uint8)
    frame = {"cropped": frame[3:31:2, 5:60],
             "channels_reversed": frame[:, ::-1, ::-1],
             "one_pixel": frame[:1, :1]}[view]
    assert view == "one_pixel" or not frame.flags.c_contiguous
    lab, sums = _native(frame)
    want = tregion._bgr_to_lab_numpy(frame)
    assert np.array_equal(lab, want)
    np.testing.assert_array_equal(sums, want.reshape(-1, 3).sum(axis=0))
    assert np.array_equal(tregion.bgr_to_lab_u8(frame), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frame_mean_from_native_sums_is_numpys(seed):
    rng = np.random.default_rng(seed)
    h, w = rng.integers(1, 300, 2)
    frame = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    lab, sums = _native(frame)
    got = (sums / (lab.size // 3)).astype(np.float32)
    want = tregion._bgr_to_lab_numpy(frame).reshape(-1, 3).mean(
        axis=0).astype(np.float32)
    assert got.dtype == want.dtype == np.float32 and got.shape == (3,)
    assert np.array_equal(got, want)


def _region_stage(window=0):
    return tregion.RegionSegmentation(
        RegionSegmentationOptions(appearance_window_size=window), W, H,
        device="cpu")


def _add(rs, frames):
    for i, fr in enumerate(frames):
        rs.add_frame(i, fr)
    return ([rs._features[i].lab_u8 for i in range(len(frames))],
            [rs._frame_means[i] for i in range(len(frames))],
            rs.trace.counters.get("region.lab_native", 0))


def test_add_frame_without_native_takes_numpy_path(monkeypatch):
    frames = _frames(3)
    lab_n, mean_n, count_n = _add(_region_stage(window=2), frames)
    assert count_n == len(frames)
    monkeypatch.setattr(tnative, "_load", lambda: None)
    assert not tnative.available()
    rs = _region_stage(window=2)
    lab_p, mean_p, count_p = _add(rs, frames)
    assert count_p == 0
    for a, b, fr in zip(lab_n, lab_p, frames):
        assert np.array_equal(a, b)
        assert np.array_equal(b, tregion._bgr_to_lab_numpy(fr))
    for a, b in zip(mean_n, mean_p):
        assert a.dtype == b.dtype == np.float32 and a.shape == (3,)
        assert np.array_equal(a, b)
    assert np.array_equal(rs._window_anchor[0], mean_p[0])
    assert np.array_equal(rs._window_anchor[1], mean_p[2])


def test_add_frame_uses_a_replaced_conversion(monkeypatch):
    calls = []

    def shifted(im):
        calls.append(im.shape)
        return tregion._bgr_to_lab_numpy(im) // 2

    monkeypatch.setattr(tregion, "bgr_to_lab_u8", shifted)
    frames = _frames(2)
    labs, means, count = _add(_region_stage(), frames)
    assert calls == [(H, W, 3)] * 2 and count == 0
    for lab, mean, fr in zip(labs, means, frames):
        want = tregion._bgr_to_lab_numpy(fr) // 2
        assert np.array_equal(lab, want)
        assert np.array_equal(
            mean, want.reshape(-1, 3).mean(axis=0).astype(np.float32))


def _signature(frames_out):
    sig = []
    for sf in frames_out:
        hier = None
        if sf.hierarchy is not None:
            hier = tuple((h.ids.tolist(), h.sizes.tolist(),
                          None if h.parent_ids is None
                          else np.asarray(h.parent_ids).tolist())
                         for h in sf.hierarchy)
        sig.append((sf.frame_index, sf.region_ids.tolist(), sf.ys.tolist(),
                    sf.lxs.tolist(), sf.rxs.tolist(), hier))
    return sig


@pytest.mark.parametrize("window", [0, 3], ids=["plain", "windowed"])
def test_clip_segframes_same_on_native_and_numpy_paths(monkeypatch,
                                                       window):
    frames = _frames(10)
    dense = DenseSegmentationOptions(chunk_size=4, presmoothing="none",
                                     frac_min_region_size=0.05)
    region = RegionSegmentationOptions(
        chunk_set_size=2, chunk_set_overlap=1, min_region_num=3,
        max_region_num=60, use_flow=False, appearance_window_size=window,
        luminance_bins=5, color_bins=8)

    def run():
        stream = tapi.segment_frames(iter(frames), W, H, use_flow=False,
                                     dense_options=dense,
                                     region_options=region, device="cpu")
        out = list(stream)
        return out, stream.counters.get("region.lab_native", 0)

    got, n_native = run()
    monkeypatch.setattr(tnative, "bgr_to_lab_u8", lambda *a: None)
    want, n_numpy = run()
    assert (n_native, n_numpy) == (len(frames), 0)
    assert len(got) == len(frames)
    assert sum(sf.hierarchy is not None for sf in got) >= 2
    assert _signature(got) == _signature(want)
