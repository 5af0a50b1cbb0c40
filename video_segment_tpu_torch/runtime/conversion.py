"""Frame conversion units (video_framework/conversion_units.h:42-104).

Named counterparts of the reference's LuminanceUnit, FlipBGRUnit and
ColorTwistUnit as `runtime.pipeline.Unit` factories, so a reference unit
graph ports 1:1 onto a UnitTree.  The conversions themselves are plain
numpy — per-frame host work far below the decode cost, exactly like the
reference's cv:: calls on its unit thread.
"""

from __future__ import annotations

import numpy as np

from video_segment_tpu_torch.core.flow import bgr_to_gray
from video_segment_tpu_torch.runtime.pipeline import Unit


def luminance_unit(name: str = "luminance") -> Unit:
    """BGR (H,W,3) uint8 -> BT.601 luminance float [0,1] (H,W)
    (LuminanceUnit, conversion_units.cpp)."""
    return Unit(name, lambda frame: [bgr_to_gray(frame)])


def flip_bgr_unit(name: str = "flip_bgr") -> Unit:
    """Swap the B and R channels (FlipBGRUnit, conversion_units.h:59-76):
    BGR <-> RGB, dtype-preserving."""
    return Unit(name, lambda frame: [np.ascontiguousarray(frame[..., ::-1])])


def color_twist_unit(scale=(1.0, 1.0, 1.0), offset=(0.0, 0.0, 0.0),
                     name: str = "color_twist") -> Unit:
    """Per-channel affine map `c * scale + offset` with uint8 saturation
    (ColorTwistUnit, conversion_units.h:79-104)."""
    s = np.asarray(scale, np.float32)
    o = np.asarray(offset, np.float32)

    def fn(frame):
        out = frame.astype(np.float32) * s + o
        if np.issubdtype(frame.dtype, np.integer):
            info = np.iinfo(frame.dtype)
            out = np.clip(out, info.min, info.max)
        return [out.astype(frame.dtype)]

    return Unit(name, fn)
