"""The port's TV-L1 against the plain reference in `reference_torch/`.

Seeded textured frames under a known sub-pixel shift, at 48x64 and
64x128.  The port's `tvl1_flow` and its batched `FlowEngine` agree with
`reference_torch.tvl1` within TOL; a flow at one scale, or the reference's
own arithmetic in float16, misses it by far more.  The reference imports
nothing of either package, and the benchmark's copy of it
(`bench_port/checks/_tvl1_ref.py`) gives its output bit for bit.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from bench_port.checks import _tvl1_ref
from reference_torch import tvl1 as ref
from video_segment_tpu_torch.core import flow as tflow

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIFT = (1.6, -0.8)   # (dx, dy) px a frame
# Mean end-point difference, px, allowed between the port and the
# reference: both run the same float32 arithmetic in another operation
# order (the port batches pairs, takes `hypot` where the reference takes a
# square root, sums a bilinear sample's four corners in another order), so
# a thresholding branch that a last-bit difference flips moves a pixel's
# flow slightly.  The port reads about 2e-6 px here; one scale reads about
# 0.1 px and float16 about 0.01 px.
TOL = 1e-3
SIZES = [(48, 64), (64, 128)]


def frames(h, w, n=3, seed=0):
    """`n` BGR uint8 frames of a smooth random texture, each shifted by
    SHIFT from the one before (linear interpolation, edges replicated)."""
    rng = np.random.default_rng(seed)
    pad = 16
    tex = ndi.gaussian_filter(rng.uniform(0, 255, (h + 2 * pad,
                                                   w + 2 * pad, 3)),
                              (1.5, 1.5, 0))
    tex = (tex - tex.min()) / (tex.max() - tex.min()) * 255
    out = []
    for k in range(n):
        moved = ndi.shift(tex, (k * SHIFT[1], k * SHIFT[0], 0), order=1,
                          mode="nearest")
        out.append(moved[pad:pad + h, pad:pad + w].astype(np.uint8))
    return out


def epe(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float(np.hypot(d[..., 0], d[..., 1]).mean())


def port_flow(prev, cur, params=tflow.TVL1Params()):
    g0 = torch.as_tensor(tflow.bgr_to_gray(cur))
    g1 = torch.as_tensor(tflow.bgr_to_gray(prev))
    return tflow.tvl1_flow(g0, g1, params).numpy()


@pytest.mark.parametrize("h,w", SIZES)
def test_port_flow_matches_reference(h, w):
    prev, cur = frames(h, w, n=2)
    want = ref.flow_bgr(prev, cur)
    # The reference recovers the drawn motion (backward: minus the shift).
    assert abs(want[..., 0].mean() + SHIFT[0]) < 0.3
    assert abs(want[..., 1].mean() + SHIFT[1]) < 0.3
    assert epe(port_flow(prev, cur), want) < TOL


@pytest.mark.parametrize("h,w", SIZES)
def test_flow_engine_matches_reference(h, w):
    """The micro-batched engine (pairs batched across a seam of its
    batch of 2) against the reference pair by pair."""
    clip = frames(h, w, n=4, seed=1)
    eng = tflow.FlowEngine(w, h, batch=2, device="cpu")
    done = []
    for i, f in enumerate(clip):
        done += eng.push(f, i)
    done += eng.flush()
    assert [idx for idx, _, _ in done] == list(range(4))
    assert done[0][2] is None
    for idx, _, field in done[1:]:
        want = ref.flow_bgr(clip[idx - 1], clip[idx])
        assert epe(field.numpy(), want) < TOL, idx


@pytest.mark.parametrize("h,w", SIZES)
def test_one_scale_and_float16_fail_the_tolerance(h, w):
    prev, cur = frames(h, w, n=2, seed=2)
    want = ref.flow_bgr(prev, cur)
    one = port_flow(prev, cur, tflow.TVL1Params(nscales=1))
    assert epe(one, want) > 10 * TOL
    half = ref.flow_bgr(prev, cur, dtype=torch.float16)
    assert np.isfinite(half).all()
    assert epe(half, want) > 3 * TOL


def test_reference_imports_neither_package():
    code = (
        "import sys, numpy as np\n"
        "from reference_torch import tvl1\n"
        "a = np.zeros((32, 40, 3), np.uint8)\n"
        "tvl1.flow_bgr(a, a)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'video_segment_tpu', 'video_segment_tpu_torch'))\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_benchmark_copy_gives_the_same_flow():
    prev, cur = frames(48, 64, n=2, seed=3)
    a = ref.flow_bgr(prev, cur)
    b = _tvl1_ref.flow_bgr(prev, cur)
    assert a.dtype == b.dtype == np.float32
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    assert np.array_equal(ref.gray(cur), _tvl1_ref.gray(cur))
