"""The bilateral presmoothing filter's CUDA kernel (K6) and its dispatch.

- On the CPU `filters.bilateral_filter` is the eager body
  (`bilateral_filter_plain`): equal to it bit for bit, no kernel launched,
  no library built.  (The eager body against the JAX package:
  `tests/test_torch_dense.py::test_presmooth_matches_jax` and
  `test_dense_bilateral_matches_jax`.)
- The wrapper (`ops/bilateral.py`) refuses what the kernel does not take
  before it loads the library.
- `DenseSegmentation` counts `ingest.bilateral_kernel` from the kernel's
  launches on the ingesting thread: 0 on the CPU.
- On a card K6 equals the eager body on the same CUDA tensors bit for bit
  at the path's shapes and at the edges (one row, one column, flat,
  checkerboard, random colours), a streamed clip equals the eager one, and
  the mesh's presmoothing equals the filter frame by frame.
"""

import contextlib
import warnings

import numpy as np
import pytest
import torch

from bench_port.generator import synthetic_clip
from video_segment_tpu_torch import _build
from video_segment_tpu_torch.core import dense
from video_segment_tpu_torch.core.options import DenseSegmentationOptions
from video_segment_tpu_torch.ops import bilateral as bilateral_ops
from video_segment_tpu_torch.ops import filters

torch.set_num_threads(2)


def _no_library(monkeypatch):
    def refuse(name):
        raise AssertionError(f"the {name} library was loaded")
    monkeypatch.setattr(_build, "load", refuse)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _u8_image(frame: np.ndarray) -> torch.Tensor:
    """A BGR uint8 frame as `_preprocess_u8` hands it to the filter."""
    return torch.as_tensor(frame).to(torch.float32) * (1.0 / 255.0)


def _frame(h=272, w=480):
    return _u8_image(synthetic_clip(1, h=h, w=w)[0])


def _checker(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    return torch.from_numpy(np.repeat(((yy + xx) % 2).astype(np.float32)
                                      [..., None], 3, axis=2))


def _random(seed, h=61, w=97, lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(lo, hi, (h, w, 3))
                            .astype(np.float32))


# Each case's (H,W,3) float32 image, built inside the test.
CASES = {
    "frame_272x480": _frame,
    "frame_854x480": lambda: _frame(854, 480),
    "band_padded": lambda: dense._pad_rows_edge(_frame(854, 480), 0, 10),
    "row_1x37": lambda: _random(10, 1, 37),
    "column_41x1": lambda: _random(11, 41, 1),
    "tiny_5x7": lambda: _random(12, 5, 7),
    "flat0": lambda: torch.zeros((272, 480, 3)),
    "flat1": lambda: torch.ones((272, 480, 3)),
    "checker": lambda: _checker(272, 480),
    **{f"random_seed{s}": (lambda s=s: _random(s)) for s in range(4)},
    # Colour distances past exp's clamp and flush to zero.
    "wide_colours": lambda: _random(20, lo=-8.0, hi=8.0),
}


def test_bilateral_cpu_takes_eager_body(monkeypatch):
    """A CPU tensor takes `bilateral_filter_plain`: the same bits, no
    launch, no library."""
    _no_library(monkeypatch)
    monkeypatch.setattr(bilateral_ops.bilateral, "launches", 0)
    img = _random(3, 40, 56)
    n0 = bilateral_ops.thread_launches()
    got = filters.bilateral_filter(img)
    assert _bits_equal(got, filters.bilateral_filter_plain(img))
    assert _bits_equal(filters.presmooth(img, "bilateral"), got)
    assert bilateral_ops.bilateral.launches == 0
    assert bilateral_ops.thread_launches() == n0


@pytest.mark.parametrize("radius", range(1, bilateral_ops.MAX_RADIUS + 1))
def test_taps_follow_the_eager_window(radius):
    """The wrapper's tap count is the eager body's window, and the cached
    spatial weights are its constants in its order."""
    offs = filters._circular_offsets(radius)
    assert bilateral_ops.taps(radius) == len(offs)
    sigma = radius / 1.5 + 1e-9
    assert int(sigma * 1.5) == radius
    ws = filters._space_weights(sigma, torch.device("cpu"))
    want = [np.exp(-0.5 / (sigma * sigma) * r2).astype(np.float32)
            for *_, r2 in offs]
    assert ws.dtype == torch.float32 and ws.tolist() == want


def _refused(case):
    """(image, weights, radius) for one refusal; everything else valid."""
    img = torch.zeros((17, 30, 3))
    ws = filters._space_weights(3.0, torch.device("cpu"))
    radius = 4
    if case == "float64":
        img = img.double()
    elif case == "four_channels":
        img = torch.zeros((17, 30, 4))
    elif case == "two_dims":
        img = torch.zeros((17, 30))
    elif case == "not_contiguous":
        img = torch.zeros((30, 17, 3)).transpose(0, 1)
    elif case == "radius_0":
        radius = 0
    elif case == "radius_past_halo":
        radius = bilateral_ops.MAX_RADIUS + 1
    elif case == "short_weights":
        ws = ws[:-1]
    elif case == "float64_weights":
        ws = ws.double()
    return img, ws, radius


@pytest.mark.parametrize("case,err,match", [
    ("float64", TypeError, "float32 image"),
    ("four_channels", ValueError, r"\(H,W,3\)"),
    ("two_dims", ValueError, r"\(H,W,3\)"),
    ("not_contiguous", ValueError, "contiguous"),
    ("radius_0", ValueError, "radius"),
    ("radius_past_halo", ValueError, "radius"),
    ("short_weights", ValueError, "weights"),
    ("float64_weights", ValueError, "weights"),
    ("cpu", ValueError, "CUDA")])
def test_bilateral_wrapper_refuses_before_loading(monkeypatch, case, err,
                                                  match):
    """Each input the kernel does not take raises before the library
    loads; a valid image on the CPU raises for its device."""
    _no_library(monkeypatch)
    img, ws, radius = _refused(case)
    with pytest.raises(err, match=match):
        bilateral_ops.bilateral(img, ws, radius, -8.0)


def _ingest(ds, n, seed=5, h=24, w=40):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        ds.process_frame(False, rng.integers(0, 256, (h, w, 3), np.uint8))


def test_dense_counts_no_bilateral_kernel_on_cpu():
    """On the CPU the counter is there and reads 0 after every frame."""
    ds = dense.DenseSegmentation(DenseSegmentationOptions(), 40, 24,
                                 device="cpu")
    _ingest(ds, 4)
    assert ds.trace.counters["ingest.bilateral_kernel"] == 0


@pytest.mark.parametrize("mode,want", [("bilateral", 4), ("gaussian", 0)])
def test_dense_counts_bilateral_kernel_from_launches(monkeypatch, mode,
                                                     want):
    """The counter adds what the kernel launched on the ingesting thread:
    a stand-in filter that reports one launch a frame, as the wrapper
    does, counts every bilateral frame; the gaussian mode never reaches
    it."""
    def filt(img, sigma_space=3.0, sigma_color=0.25):
        bilateral_ops._thread.launches = bilateral_ops.thread_launches() + 1
        return filters.bilateral_filter_plain(img, sigma_space, sigma_color)

    monkeypatch.setattr(filters, "bilateral_filter", filt)
    ds = dense.DenseSegmentation(DenseSegmentationOptions(presmoothing=mode),
                                 40, 24, device="cpu")
    _ingest(ds, 4)
    assert ds.trace.counters["ingest.bilateral_kernel"] == want


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@contextlib.contextmanager
def _deterministic():
    """Float atomics make a sum's last bit depend on the schedule; the
    stream comparison runs both sides with deterministic kernels."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            yield
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_k6_equals_eager_on_card(case):
    """K6 against the eager body on the same CUDA tensor, bit for bit,
    one launch."""
    _need_card()
    img = CASES[case]().contiguous().cuda()
    before = bilateral_ops.bilateral.launches
    got = filters.bilateral_filter(img)
    launched = bilateral_ops.bilateral.launches - before
    want = filters.bilateral_filter_plain(img)
    torch.cuda.synchronize()
    assert launched == 1
    assert _bits_equal(got, want), float((got - want).abs().max())


@pytest.mark.cuda
def test_k6_stream_equals_eager_stream_on_card(monkeypatch):
    """A 21-frame `segment_frames` clip (flow off) with K6 gives the
    SegFrames of the same clip with the eager filter, and counts every
    frame in `ingest.bilateral_kernel`."""
    _need_card()
    from video_segment_tpu_torch import api
    frames = synthetic_clip(21, seed=3)
    h, w = frames[0].shape[:2]

    def run():
        with _deterministic():
            stream = api.segment_frames(iter(frames), w, h, use_flow=False)
            out = list(stream)
        torch.cuda.synchronize()
        return out, stream.counters["ingest.bilateral_kernel"]

    got, n_kernel = run()
    monkeypatch.setattr(filters, "bilateral_filter",
                        filters.bilateral_filter_plain)
    want, n_eager = run()
    assert (n_kernel, n_eager) == (21, 0)
    assert len(got) == len(want) == 21
    for a, b in zip(got, want):
        for f in ("frame_index", "chunk_id", "chunk_size",
                  "hierarchy_frame_idx"):
            assert getattr(a, f) == getattr(b, f), f
        for f in ("region_ids", "interval_counts", "ys", "lxs", "rxs"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f"frame {a.frame_index}")
        assert (a.hierarchy is None) == (b.hierarchy is None)
        for la, lb in zip(a.hierarchy or [], b.hierarchy or []):
            np.testing.assert_array_equal(la.ids, lb.ids)
            np.testing.assert_array_equal(la.sizes, lb.sizes)


@pytest.mark.cuda
def test_sharded_presmooth_equals_filter_on_card():
    """`sharded_presmooth` on a (2,2) mesh of the one card (shards with
    their 4-row halo through K6) equals `presmooth` frame by frame."""
    _need_card()
    from video_segment_tpu_torch.parallel import mesh as pmesh
    frames = synthetic_clip(4, seed=4)
    vol = torch.stack([_u8_image(f) for f in frames]).reshape(
        2, 2, *frames[0].shape).cuda()
    mesh = pmesh.make_mesh(4, data=2, space=2, repeat=True)
    before = bilateral_ops.bilateral.launches
    got = pmesh.sharded_presmooth(mesh, "bilateral", halo=4)(vol)
    assert bilateral_ops.bilateral.launches - before == 8
    for b in range(2):
        for t in range(2):
            assert _bits_equal(got[b, t],
                               filters.presmooth(vol[b, t], "bilateral"))


@pytest.mark.cuda
def test_k6_raises_on_card():
    """A non-contiguous or a float64 CUDA image raises, through the
    wrapper and through `bilateral_filter`: nothing falls back to the
    eager body."""
    _need_card()
    ok = torch.zeros((30, 17, 3), device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        filters.bilateral_filter(ok.transpose(0, 1))
    with pytest.raises(TypeError):
        filters.bilateral_filter(ok.double())
    with pytest.raises(ValueError, match="radius"):
        filters.bilateral_filter(ok, sigma_space=12.0)
