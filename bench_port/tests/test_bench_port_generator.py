"""The traffic generator: deterministic per seed, equal to the
repository's `chip_smoke.synthetic_clip`, and the protocol's solves."""

import numpy as np
import pytest

from bench_port import generator


@pytest.mark.parametrize("seed", [0, 2 ** 33 + 7])
def test_deterministic_per_seed(seed):
    a = generator.synthetic_clip(4, seed=seed, h=64, w=96)
    b = generator.synthetic_clip(4, seed=seed, h=64, w=96)
    assert all((x == y).all() for x, y in zip(a, b))
    c = generator.synthetic_clip(4, seed=seed + 1, h=64, w=96)
    assert any((x != y).any() for x, y in zip(a, c))
    assert a[0].shape == (64, 96, 3) and a[0].dtype == np.uint8


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5])
def test_equals_chip_smoke(seed):
    import chip_smoke
    a = chip_smoke.synthetic_clip(5, seed=seed, h=64, w=96)
    b = generator.synthetic_clip(5, seed=seed, h=64, w=96)
    assert all((x == y).all() for x, y in zip(a, b))


@pytest.mark.parametrize("n", [21, 40, 41, 60, 140])
def test_chunk_solves_match_protocol(n):
    import chip_smoke
    solves = generator.chunk_solves(n, 20)
    assert len(solves) == chip_smoke.expected_chunk_solves(n, 20)
    assert sum(solves) == n + 2 * (len(solves) - 1)


@pytest.mark.parametrize("seed", [1, 2 ** 32 + 3])
def test_truth_matches_frames(seed):
    a = generator.synthetic_clip(3, seed=seed, h=64, w=96)
    b, objects = generator.synthetic_clip(3, seed=seed, h=64, w=96,
                                          truth=True)
    assert all((x == y).all() for x, y in zip(a, b))
    assert objects.shape == (3, 64, 96) and objects.max() <= 12
    assert (objects == 0).any() and (objects > 0).any()


def test_fixed_sizes_are_the_same_for_every_seed():
    keys = ("ry", "rx", "tex")
    sets = []
    for seed in (5, 6, 2 ** 33 + 1):
        rng = np.random.default_rng(seed)
        sets.append(sorted(tuple(e[k] for k in keys) for e in
                           generator._ellipses(rng, 12, "fixed", 272, 480)))
    assert sets[0] == sets[1] == sets[2]
    clip, objects = generator.synthetic_clip(60, seed=7, sizes="fixed",
                                             h=68, w=120, truth=True)
    # The ellipses bounce off the borders: each stays in every frame.
    assert all(len(np.unique(o)) >= 12 for o in objects)
