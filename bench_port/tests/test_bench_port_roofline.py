"""The kernels' work counted from shapes matches PERF.md's kernel table
(section 6): K1 4.70 MB and 1.40 us a 272x480 frame, 33.6 MB at config
4's padded (1296, 720) frame; K2 307 MB and 91.7 us a (13, 21, 272, 480)
chunk, 488 MB a (13, 21, 432, 480) band."""

import pytest

from bench_port import roofline


def test_k1_frame():
    assert roofline.k1_least_seconds(1, 272, 480) == pytest.approx(
        1.40e-6, rel=3e-3)
    assert 36 * 272 * 480 == pytest.approx(4.70e6, rel=1e-3)
    assert roofline.k1_least_seconds(1, 1296, 720) * roofline.HBM_BYTES_S \
        == pytest.approx(33.6e6, rel=1e-3)


def test_k1_bytes_bound_it():
    h, w = 272, 480
    ops = roofline.K1_F32_OPS_PER_EDGE * roofline.k1_in_tile_edges(h, w)
    assert ops / roofline.OPS_S["f32"] * 5 < 36 * h * w / \
        roofline.HBM_BYTES_S
    # 8 directions, each losing the pairs that leave the image or a tile.
    assert roofline.k1_in_tile_edges(8, 128) == 2 * (8 * 127 + 7 * 128
                                                     + 2 * 7 * 127)


def test_k2_chunk_and_band():
    assert roofline.k2_least_seconds([21], 272, 480) == pytest.approx(
        91.7e-6, rel=1e-3)
    assert roofline.k2_least_seconds([21], 432, 480) * \
        roofline.HBM_BYTES_S == pytest.approx(488e6, rel=1e-3)
    assert roofline.k2_least_seconds([21, 8], 272, 480) == pytest.approx(
        91.665e-6 * 29 / 21, rel=1e-3)
