"""Port K2 (tile_reduce_min) against the JAX Pallas kernel (interpret mode).

Exact int32 work: the plain PyTorch version must equal the JAX kernel bit
for bit on tile-local labels and random packed keys; the CUDA kernel is
held to the plain version on a card.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from video_segment_tpu.ops import tile_extract as jte
from video_segment_tpu_torch.ops import tile_extract as tte

torch.set_num_threads(2)

I32MAX = 2 ** 31 - 1


def _tile_local_roots(t, h, w, rng):
    """(labr, labc) of a synthetic tile-local preseg: horizontal runs
    rooted at their first pixel, within each (8,128) tile."""
    labr = np.zeros((t, h, w), np.int32)
    labc = np.zeros((t, h, w), np.int32)
    for y in range(h):
        x = 0
        while x < w:
            run = min(int(rng.integers(1, 9)), w - x, 128 - x % 128)
            labr[:, y, x:x + run] = y % 8
            labc[:, y, x:x + run] = x % 128
            x += run
    return labr, labc


def _keys(d, t, h, w, rng):
    keys = rng.integers(0, 2046 << 20, (d, t, h, w), dtype=np.int64)
    keys = keys.astype(np.int32)
    keys[rng.random(keys.shape) < 0.3] = I32MAX
    return keys


@pytest.mark.parametrize("shape", [(1, 16, 128), (2, 16, 256), (3, 24, 144)])
def test_plain_matches_jax_kernel(shape):
    rng = np.random.default_rng(sum(shape))
    t, h, w = shape
    labr, labc = _tile_local_roots(t, h, w, rng)
    keys = _keys(13, t, h, w, rng)
    want = np.asarray(jte.tile_reduce_min(jnp.asarray(labr),
                                          jnp.asarray(labc),
                                          jnp.asarray(keys)))
    got = tte.tile_reduce_min(torch.from_numpy(labr), torch.from_numpy(labc),
                              torch.from_numpy(keys))
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_validates_inputs():
    z = torch.zeros((1, 8, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        tte.tile_reduce_min(z, z, torch.zeros((2, 1, 8, 64),
                                              dtype=torch.int32))
    with pytest.raises(TypeError):
        tte.tile_reduce_min(z.long(), z, torch.zeros((2, 1, 8, 128),
                                                     dtype=torch.int32))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel has no CPU mode)")
    rng = np.random.default_rng(0)
    t, h, w = 3, 24, 300
    labr, labc = _tile_local_roots(t, h, w, rng)
    keys = torch.from_numpy(_keys(13, t, h, w, rng)).cuda()
    labr, labc = torch.from_numpy(labr).cuda(), torch.from_numpy(labc).cuda()
    got = tte.tile_reduce_min(labr, labc, keys)
    want = tte.tile_reduce_min_plain(labr, labc, keys)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
