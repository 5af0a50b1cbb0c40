"""The port's pixel distances and aggregators against the JAX package's.

Every function of `video_segment_tpu_torch/ops/pixel_distance.py` against
`jax.jit` of its JAX counterpart on seeded inputs, bit for bit (the solver
bucketizes these distances into 2048 levels, so the compiled code's fused
multiply-adds are copied).  One exception, in the sums of squares of the
L2 distances: XLA's CPU code adds the squares separately in its vectorized
loop but as fused multiply-adds in the scalar loop that finishes each
parallel partition, so the few elements at the partition ends (about 1 in
10^5 here; which ones depends on the host's thread count) may differ by
an ulp or two; the port keeps the vectorized loop's sums.  Inputs reach
the clamps: gradient differences past 10 * sqrt(...) = 1, aggregated
distances at 0 and 1.  The scalar aggregator equals the JAX one exactly.
"""

import jax
import numpy as np
import pytest
import torch

from video_segment_tpu.ops import pixel_distance as jpd
from video_segment_tpu_torch.ops import pixel_distance as tpd

torch.set_num_threads(2)

N = 200_000
AGGREGATORS = [("linear", 0.5), ("linear", 0.3), ("independent", 0.5),
               ("sqrt", 0.5)]


def assert_bitwise(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def assert_bitwise_but_partition_ends(got, want):
    """Bitwise, except at most 1 in 20,000 elements (plus 3) within 2 ulp:
    the scalar loops that end XLA's parallel partitions."""
    want = np.asarray(want).view(np.int32)
    got = got.numpy().view(np.int32)
    off = np.abs(got.astype(np.int64) - want)
    assert (off > 0).sum() <= got.size // 20000 + 3, (off > 0).sum()
    assert off.max() <= 2


def _pairs(seed, ch, scale=1.0, offset=0.0):
    rng = np.random.default_rng(seed)
    return [((rng.random((N, ch)) - offset) * scale).astype(np.float32)
            for _ in range(2)]


@pytest.mark.parametrize("metric", ["l1", "l2"])
def test_color_distance_matches_jax(metric):
    a, b = _pairs(0, 3)
    want = jax.jit(lambda x, y: jpd.color_distance(x, y, metric))(a, b)
    got = tpd.color_distance(torch.from_numpy(a), torch.from_numpy(b),
                             metric)
    (assert_bitwise if metric == "l1"
     else assert_bitwise_but_partition_ends)(got, want)


@pytest.mark.parametrize("metric", ["l1", "l2"])
@pytest.mark.parametrize("scale", [0.05, 0.6], ids=["small", "clamped"])
def test_gradient_distance_matches_jax(metric, scale):
    a, b = _pairs(1, 2, scale, 0.5)
    want = jax.jit(lambda x, y: jpd.gradient_distance(x, y, metric))(a, b)
    got = tpd.gradient_distance(torch.from_numpy(a), torch.from_numpy(b),
                                metric)
    (assert_bitwise if metric == "l1"
     else assert_bitwise_but_partition_ends)(got, want)
    if metric == "l2":
        assert (got == 1.0).any() == (scale > 0.1)


@pytest.mark.parametrize("scale", [0.05, 0.6], ids=["small", "clamped"])
def test_gradient_trait_distance_matches_jax(scale):
    a, b = _pairs(2, 2, scale, 0.5)
    want = jax.jit(jpd.gradient_trait_distance)(a, b)
    assert_bitwise_but_partition_ends(
        tpd.gradient_trait_distance(torch.from_numpy(a),
                                    torch.from_numpy(b)), want)


@pytest.mark.parametrize("aggregator,w", AGGREGATORS,
                         ids=[f"{a}-{w}" for a, w in AGGREGATORS])
def test_aggregate_matches_jax(aggregator, w):
    rng = np.random.default_rng(3)
    d1 = rng.random(N).astype(np.float32)
    d2 = rng.random(N).astype(np.float32)
    d1[:100] = 0.0      # the clamps' values, as the trait distances give
    d2[50:150] = 1.0
    want = jax.jit(lambda x, y: jpd.aggregate(x, y, aggregator, w))(d1, d2)
    assert_bitwise(tpd.aggregate(torch.from_numpy(d1), torch.from_numpy(d2),
                                 aggregator, w), want)
    for s1, s2 in ((0.05, jpd.GRADIENT_MERGE_THRESHOLD),
                   (0.15, jpd.GRADIENT_SPLIT_THRESHOLD), (0.1, 0.75)):
        assert tpd.aggregate_scalar(s1, s2, aggregator, w) == \
            jpd.aggregate_scalar(s1, s2, aggregator, w)
    with pytest.raises(ValueError):
        tpd.aggregate(torch.from_numpy(d1), torch.from_numpy(d2), "max")


def test_thresholds_equal():
    assert (tpd.GRADIENT_MERGE_THRESHOLD, tpd.GRADIENT_SPLIT_THRESHOLD) == \
        (jpd.GRADIENT_MERGE_THRESHOLD, jpd.GRADIENT_SPLIT_THRESHOLD)


@pytest.mark.parametrize("shape", [(4, 64, 300), (2, 1, 5), (1, 3, 1)])
def test_gradient_features_matches_jax(shape):
    vol = np.random.default_rng(4).random(shape + (3,)).astype(np.float32)
    want = jax.jit(jpd.gradient_features)(vol)
    got = tpd.gradient_features(torch.from_numpy(vol))
    assert got.shape == shape + (2,)
    assert_bitwise(got, want)


def test_sign_normalize_matches_jax():
    g = np.random.default_rng(5).standard_normal((N, 2)).astype(np.float32)
    g[:10, 0] = 0.0
    g[10:20, 0] = -0.0
    want = jax.jit(jpd.sign_normalize)(g)
    got = tpd.sign_normalize(torch.from_numpy(g))
    assert_bitwise(got, want)
    assert (got[:, 0] >= 0).all()
