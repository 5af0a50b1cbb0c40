"""Region rendering (host): pseudo-random colors per region at any
hierarchy level, with optional boundary highlighting.

Equivalent of segment_util/segmentation_render.{h,cpp}
(HierarchyColorGenerator + RenderRegionsRandomColor).
"""

from __future__ import annotations

import numpy as np

from video_segment_tpu_torch.segment_util import util


def pseudo_random_colors(ids: np.ndarray) -> np.ndarray:
    """Deterministic id -> BGR color (splitmix64 bit mix)."""
    x = ids.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    return np.stack([(x >> np.uint64(s)).astype(np.uint8)
                     for s in (0, 8, 16)], axis=-1)


def render_label_image(label_img: np.ndarray,
                       highlight_boundary: bool = True) -> np.ndarray:
    """Label image (H,W) int -> random-color BGR uint8."""
    colors = pseudo_random_colors(label_img.ravel()).reshape(
        label_img.shape + (3,))
    if highlight_boundary:
        b = np.zeros(label_img.shape, bool)
        b[:, 1:] |= label_img[:, 1:] != label_img[:, :-1]
        b[1:, :] |= label_img[1:, :] != label_img[:-1, :]
        colors[b] = 0
    return colors


def render_desc(desc, hierarchy=None, level: int = 0,
                highlight_boundary: bool = True) -> np.ndarray:
    """Render a parsed SegmentationDesc frame at a hierarchy level."""
    lab = util.desc_to_id_image(desc, hierarchy, level)
    return render_label_image(lab, highlight_boundary)


def render_segframe(sf, hierarchy=None, level: int = 0,
                    highlight_boundary: bool = True) -> np.ndarray:
    """Render a core.dense.SegFrame (numpy record) without proto round-trip."""
    if level > 0 and hierarchy:
        pm = util.parent_map(hierarchy, level)
        draw = np.array([pm.get(int(i), int(i)) for i in sf.region_ids],
                        np.int64)
    else:
        draw = sf.region_ids.astype(np.int64)
    intervals = np.stack([sf.ys, sf.lxs, sf.rxs], axis=1)
    lab = util.rasterize_ids(draw, sf.interval_counts, intervals,
                             sf.frame_height, sf.frame_width)
    return render_label_image(lab, highlight_boundary)
