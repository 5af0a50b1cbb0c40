"""Region boundary extraction and vectorization (host).

Equivalent of the reference's boundary computation
(segmentation/boundary.{h,cpp}: Freeman chain-code tracing + approxPolyDP
simplification with max_error 1.0, boundary.cpp:513-570, invoked from
segmentation.cpp:527-532) and of segment_util/segmentation_boundary.{h,cpp}
(per-region N4 boundary pixels).

Vectorization itself lives in segment_util/joint_boundary.py (jointly
traced shared segments in corner space, like the reference); this module
keeps the per-region boundary-pixel extraction plus the proto attach /
scale helpers.
"""

from __future__ import annotations

import numpy as np

from video_segment_tpu_torch import proto

MAX_POLY_ERROR = 1.0  # boundary.cpp approxPolyDP max_error
MIN_SEGMENT_LEN = 4


def region_boundary(label_img: np.ndarray, region_id: int) -> np.ndarray:
    """Inner N4 boundary pixel coordinates (y,x) of one region
    (GetBoundary, segmentation_boundary.h:69-81)."""
    mask = label_img == region_id
    er = np.zeros_like(mask)
    er[1:-1, 1:-1] = (mask[1:-1, 1:-1] & mask[:-2, 1:-1] & mask[2:, 1:-1]
                      & mask[1:-1, :-2] & mask[1:-1, 2:])
    yx = np.nonzero(mask & ~er)
    return np.stack(yx, axis=1)


def vectorization_to_proto(desc, mesh: np.ndarray, polys: dict,
                           remove_rasterization: bool = False):
    """Attach a frame vectorization to a parsed SegmentationDesc in place."""
    desc.vector_mesh.coord.extend(mesh.tolist())
    for r in desc.region:
        plist = polys.get(r.id, [])
        for idx, hole in plist:
            poly = r.vectorization.polygon.add()
            poly.coord_idx.extend((idx * 1).tolist())
            if hole:
                poly.hole = True
        if remove_rasterization:
            r.ClearField("raster")
    if remove_rasterization:
        desc.rasterization_removed = True


def scale_vectorization(desc, scale_x: float, scale_y: float):
    """Scale a frame's vector mesh (ScaleVectorization,
    segmentation_util.cpp:1248) — used when the video was downscaled for
    segmentation but output is emitted at original resolution."""
    coords = np.asarray(desc.vector_mesh.coord, np.float32)
    coords[0::2] *= scale_x
    coords[1::2] *= scale_y
    del desc.vector_mesh.coord[:]
    desc.vector_mesh.coord.extend(coords.tolist())
