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


def test_long140_clip_is_unchanged():
    """`c2_272x480.long140`'s frames and truth, digests taken before the
    rigid texture and the drawn motion were added."""
    import hashlib

    from bench_port import harness
    _, _, config, traffic, _ = harness.load_cell("c2_272x480.long140")
    frames, truth = harness.make_clip(traffic, config, 2 ** 33 + 5)
    assert set(truth) == {"objects"}
    assert hashlib.sha256(np.stack(frames).tobytes()).hexdigest() == (
        "62ca541fe0fd9b135cb891e17a4b83780a89dff8169b77aab6c05ac9aa235166")
    assert hashlib.sha256(truth["objects"].tobytes()).hexdigest() == (
        "761ed23195359f9b0b8808696224247101945137a8c347533c00cd8b09f3a283")


@pytest.mark.parametrize("seed", [4, 2 ** 33 + 2])
def test_rigid_motion_warps_the_previous_frame(seed):
    """Frame f - 1 sampled at each pixel's drawn backward displacement
    gives frame f on the valid pixels, to within the two frames' noise
    (standard deviation 2 x sqrt(2)); with no displacement it does not."""
    import scipy.ndimage as ndi
    n, h, w = 6, 136, 240
    frames, objects, motion = generator.synthetic_clip(
        n, seed=seed, h=h, w=w, sizes="fixed", texture=10.0, noise=2.0,
        truth=True, texture_motion="rigid", motion=True)
    flow, valid = motion["flow"], motion["valid"]
    assert flow.shape == (n, h, w, 2) and not valid[0].any()
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    for f in range(1, n):
        v = valid[f]
        assert 0.5 < v.mean() < 0.8
        assert (flow[f][(objects[f] == 0) & v] == (2, 0)).all()
        prev = frames[f - 1].astype(np.float64)
        cur = frames[f].astype(np.float64)
        for d, lo, hi in ((flow[f], 2.6, 3.0), (0 * flow[f], 4.0, 99)):
            warped = np.stack([ndi.map_coordinates(
                prev[..., c], [yy + d[..., 1], xx + d[..., 0]], order=1)
                for c in range(3)], -1)
            assert lo < (warped - cur)[v].std() < hi


def test_motion_needs_rigid_texture():
    with pytest.raises(ValueError):
        generator.synthetic_clip(3, seed=1, h=64, w=96, motion=True)
    with pytest.raises(ValueError):
        generator.synthetic_clip(3, seed=1, h=64, w=96,
                                 texture_motion="swirl")
