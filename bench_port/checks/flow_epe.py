"""The flow the program computed against the motion the generator drew.

Reads the `.flow` file of each compared clip (the reference's format,
flow_reader.cpp:239-249: int32 width, height and flow_type, then one
float32 (h, w, 2) field a frame from frame 1 on, (dx, dy) from that frame
to the one before) and holds it to the clip's drawn backward displacement
(`truth["flow"]`) over the pixels where that displacement holds
(`truth["valid"]`).  Numbers:

- `flow_fields_wrong`: over the compared clips, fields missing (a file
  absent or cut short), of the wrong size, not finite, or of a file whose
  flow_type is not backward (limit 0).
- `flow_epe`: the largest, over the frames of the compared clips, of a
  frame's mean end-point error (px) over its valid pixels.  A per-frame
  maximum: a fault at the seams of a micro-batch breaks one frame in a
  batch, which a mean over the clip would dilute.  Left out when no field
  could be compared (`flow_fields_wrong` then fails the run).
"""

from __future__ import annotations

import numpy as np

BACKWARD = 1


def read_flow(path: str) -> tuple:
    """(width, height, flow_type, fields (k, h, w, 2) float32, trailing
    bytes that make no whole field) of a `.flow` file."""
    data = np.fromfile(path, np.uint8)
    w, h, ftype = (int(v) for v in data[:12].view("<i4"))
    size = max(h * w * 2 * 4, 1)
    body = data[12:]
    k = len(body) // size
    fields = body[:k * size].view("<f4").reshape(k, h, w, 2)
    return w, h, ftype, fields, len(body) - k * size


def numbers(files: list, truth: dict, config: dict, traffic: dict) -> dict:
    flow, valid = truth["flow"], truth["valid"]
    n, h, w = valid.shape
    wrong, epe = 0, []
    for clip in files:
        try:
            fw, fh, ftype, fields, rest = read_flow(clip["flow"])
        except (KeyError, OSError, ValueError):
            wrong += n - 1
            continue
        if (fw, fh) != (w, h) or ftype != BACKWARD:
            wrong += n - 1
            continue
        wrong += abs(len(fields) - (n - 1)) + int(rest > 0
                                                  and len(fields) >= n - 1)
        for f, field in enumerate(fields[:n - 1], start=1):
            if not np.isfinite(field).all():
                wrong += 1
                continue
            if valid[f].any():
                d = field[valid[f]].astype(np.float64) - flow[f][valid[f]]
                err = np.hypot(d[:, 0], d[:, 1])
                epe.append(float(err.mean()))
    out = {"flow_fields_wrong": wrong}
    if epe:
        out["flow_epe"] = max(epe)
    return out
