"""Port K4 (tile_presegment) against the JAX Pallas kernel (interpret mode).

The plain PyTorch version must equal the JAX kernel exactly on the inputs
of tests/test_tile_preseg.py and on a quantized textured volume whose flat
regions are far longer than the 48 flooding iterations (so the Jacobi
flood leaves label chains for the pointer jump).  Quantized colours keep
every distance exact, so XLA's FMA contraction cannot flip an edge.  The
CUDA kernel is held to the plain version on a card.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from video_segment_tpu.ops import tile_preseg as jtp
from video_segment_tpu_torch.ops import tile_preseg as ttp

torch.set_num_threads(2)


def _both(vol, threshold, **kw):
    want = np.asarray(jtp.tile_presegment(jnp.asarray(vol), threshold, **kw))
    got = ttp.tile_presegment(torch.from_numpy(vol), threshold, **kw).numpy()
    return got, want


def _long_regions(seed=5, shape=(2, 20, 300)):
    """Quantized piecewise-flat volume: horizontal bands and long snakes of
    one colour (multiples of 1/32), with isolated noise pixels."""
    rng = np.random.default_rng(seed)
    t, h, w = shape
    lev = rng.integers(0, 33, (t, h // 4 + 1, 3)).astype(np.float32) / 32.0
    vol = np.repeat(lev, 4, axis=1)[:, :h, None, :].repeat(w, axis=2)
    vol = np.ascontiguousarray(vol)
    # A vertical comb inside each tile: rows joined only at alternate ends.
    vol[:, :, 60] = 0.5
    noise = rng.random((t, h, w)) < 0.03
    vol[noise] = rng.integers(0, 33, (int(noise.sum()), 3)) / 32.0
    return vol.astype(np.float32)


@pytest.mark.parametrize("case", ["binary", "noise", "uniform", "long_l2",
                                  "long_l1"])
def test_plain_matches_jax_kernel(case):
    rng = np.random.default_rng(0)
    if case == "binary":
        vol = (rng.random((2, 16, 140, 3)) < 0.5).astype(np.float32) * 0.6
        got, want = _both(vol, 0.01, iters=64)
    elif case == "noise":
        vol = rng.random((1, 8, 128, 3)).astype(np.float32)
        got, want = _both(vol, 1e-9)
        assert len(np.unique(got)) == 8 * 128
    elif case == "uniform":
        vol = np.full((1, 8, 128, 3), 0.5, np.float32)
        got, want = _both(vol, 0.01, iters=160)
        assert len(np.unique(got)) == 1 and got[0, 0, 0] == 0
    else:
        vol = _long_regions()
        metric = case[-2:]
        got, want = _both(vol, 0.01, metric=metric)
        assert len(np.unique(got)) < vol[..., 0].size // 20
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("iters,n_labels", [(48, 2), (256, 1)])
def test_bounded_flood_splits_long_region(iters, n_labels):
    """A C-shaped region whose far end is 207 steps from its minimum: 48
    iterations (plus the pointer jump) leave it in two labels, 256 join
    it; JAX agrees on both."""
    vol = np.zeros((1, 8, 128, 3), np.float32)
    vol[0, 0, :101] = 1.0
    vol[0, :, 100] = 1.0
    vol[0, 7, :101] = 1.0
    got, want = _both(vol, 0.01, iters=iters)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got[0][vol[0, ..., 0] > 0])) == n_labels


def test_wrapper_validates_inputs():
    with pytest.raises(ValueError):
        ttp.tile_presegment(torch.zeros((2, 8, 8)))
    with pytest.raises(TypeError):
        ttp.tile_presegment(torch.zeros((1, 8, 8, 3), dtype=torch.float64))
    with pytest.raises(ValueError):
        ttp.tile_presegment(torch.zeros((1, 8, 8, 3)), metric="cos")


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_kernel_matches_plain_on_card(metric):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel has no CPU mode)")
    vol = torch.from_numpy(_long_regions(shape=(3, 36, 300))).cuda()
    before = ttp.tile_presegment.launches
    got = ttp.tile_presegment(vol, 0.01, metric)
    assert ttp.tile_presegment.launches == before + 1
    want = ttp.tile_presegment_plain(vol, 0.01, metric, 48)
    raw_k = ttp.flood_kernel(vol, 0.01, metric, 48)
    raw_p = ttp.flood_plain(vol, 0.01, metric, 48)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(raw_k, raw_p)
    assert not torch.equal(raw_k, got)      # chains were left to collapse
