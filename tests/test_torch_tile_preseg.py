"""Port K4 (tile_presegment) against the JAX Pallas kernel (interpret mode).

The plain PyTorch version must equal the JAX kernel exactly on the inputs
of tests/test_tile_preseg.py and on a quantized textured volume whose flat
regions are far longer than the 48 flooding iterations (so the Jacobi
flood leaves label chains for the pointer jump).  Quantized colours keep
every distance exact, so XLA's FMA contraction cannot flip an edge.  The
CUDA kernel is held to the plain version on a card, and its early exit (a
tile stops at its first iteration that changes no label) rests on the
invariant that the flood at its fixed point equals the flood run ten times
as long, checked on the CPU.
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
    vol = _c_shape()
    got, want = _both(vol, 0.01, iters=iters)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got[0][vol[0, ..., 0] > 0])) == n_labels


def _fixed_point(vol, metric="l2", limit=400):
    """Fewest iterations after which `flood_plain` no longer changes."""
    prev = ttp.flood_plain(vol, 0.01, metric, 0)
    for n in range(limit):
        cur = ttp.flood_plain(vol, 0.01, metric, n + 1)
        if torch.equal(cur, prev):
            return n, prev
        prev = cur
    raise AssertionError(f"no fixed point within {limit} iterations")


def _c_shape():
    """One tile holding a C-shaped region whose far end is 207 steps from
    its minimum."""
    vol = np.zeros((1, 8, 128, 3), np.float32)
    vol[0, 0, :101] = 1.0
    vol[0, :, 100] = 1.0
    vol[0, 7, :101] = 1.0
    return vol


@pytest.mark.parametrize("case", ["uniform", "c_shape", "long_l1"])
def test_flood_fixed_point_is_final(case):
    """The early exit's invariant: once no label changes, `flood_plain` at
    n iterations equals it at 10 n."""
    metric = "l1" if case == "long_l1" else "l2"
    if case == "uniform":
        vol = np.full((1, 8, 128, 3), 0.5, np.float32)
    elif case == "c_shape":
        vol = _c_shape()
    else:
        vol = _long_regions(shape=(1, 16, 256))
    vol = torch.from_numpy(vol)
    n, labels = _fixed_point(vol, metric)
    assert n > 48
    assert not torch.equal(ttp.flood_plain(vol, 0.01, metric, n - 1), labels)
    assert torch.equal(ttp.flood_plain(vol, 0.01, metric, 10 * n), labels)


@pytest.mark.parametrize("threshold", [0.002, 0.01, 1e-9, 0.0, -1.0, 3.0])
def test_flood_key_splits_like_the_square_root(threshold):
    """The kernel's l2 edge test `q <= flood_key(t)` on the mean squared
    colour difference q accepts exactly the q whose float32 square root is
    <= t, on random values and on every float32 next to the key."""
    key = ttp.flood_key(threshold)
    rng = np.random.default_rng(1)
    q = np.concatenate([rng.random(20000) * 4 * max(threshold, 1e-6) ** 2,
                        rng.random(1000)]).astype(np.float32)
    if 0 <= key < np.inf:
        k = np.array([key], np.float32).view(np.int32)[0]
        near = np.arange(max(k - 500, 0), k + 500, dtype=np.int32)
        q = np.concatenate([q, near.view(np.float32)])
    want = (np.sqrt(q) <= np.float32(threshold))
    np.testing.assert_array_equal(q <= np.float32(key), want)
    if threshold > 0:
        assert want.any() and not want.all()


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


def _card_flood(vol, threshold, metric, iters):
    """Kernel and plain raw floods on the card, and the kernel's iterations
    per tile."""
    t, h, w, _ = vol.shape
    n_tiles = t * -(-h // 8) * -(-w // 128)
    its = torch.full((n_tiles,), -1, dtype=torch.int32, device=vol.device)
    got = ttp.flood_kernel(vol, threshold, metric, iters, tile_iters=its)
    want = ttp.flood_plain(vol, threshold, metric, iters)
    torch.cuda.synchronize()
    return got, want, its.cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "l1"])
@pytest.mark.parametrize("iters", [0, 1, 48, 160])
def test_flood_kernel_iters_on_card(iters, metric):
    """Ragged edge tiles (37 x 301), T = 3, every iteration budget: the raw
    roots equal the plain version's; no tile runs past `iters`, and at 160
    iterations some tiles stop early at their fixed point."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel has no CPU mode)")
    vol = torch.from_numpy(_long_regions(shape=(3, 37, 301))).cuda()
    got, want, its = _card_flood(vol, 0.01, metric, iters)
    assert torch.equal(got, want)
    assert int(its.min()) >= 0 and int(its.max()) <= iters
    if iters == 160:
        assert int(its.min()) < iters


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["noise", "c_shape48", "c_shape256"])
def test_flood_kernel_early_exit_on_card(case):
    """A noise tile at threshold 1e-9 takes no edge and stops after 0
    iterations; the C-shaped region (207 steps) must not stop before 48
    iterations, and stops on its own between 207 and 256."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel has no CPU mode)")
    if case == "noise":
        rng = np.random.default_rng(0)
        vol = torch.from_numpy(rng.random((2, 8, 128, 3)).astype(
            np.float32)).cuda()
        got, want, its = _card_flood(vol, 1e-9, "l2", 48)
        assert its.tolist() == [0, 0]
    else:
        iters = 48 if case == "c_shape48" else 256
        vol = torch.from_numpy(_c_shape()).cuda()
        got, want, its = _card_flood(vol, 0.01, "l2", iters)
        n = int(its[0])
        assert n == 48 if iters == 48 else 207 <= n < 256
    assert torch.equal(got, want)
