"""Each frame's level-0 labels against what the drawn scene did in it.

With flow on, the dense stage's flow-displaced temporal edges may join an
ellipse's voxels of some frames to the background's of others in one
spatio-temporal region; the JAX package does the same on the same clip
and pre-segmentation, so that is the algorithm's, and `leak` (a region
taken whole over the clip) then reads as high as a state that never
advances or a frame whose regions were merged into one.  This check reads
those two faults off the frames themselves, exactly:

- `frames_unmoved`: frames, from frame 1 on, whose level-0 labels equal
  the frame before's pixel for pixel although the drawn scene moved
  between the two (its objects, or, where the traffic draws it, the
  backward displacement): a state that never advances.
- `frames_collapsed`: frames held by fewer level-0 regions than the drawn
  objects in them (the background counted as one): a frame whose regions
  were merged where they are produced.

Both are summed over the compared clips; limit 0.  Reads each compared
clip's `.pb` (`files["pb"]`) with the check's own reader."""

from __future__ import annotations

import numpy as np

from bench_port import compare


def frame_numbers(labels: np.ndarray, truth: dict) -> dict:
    """`frames_unmoved` and `frames_collapsed` of one clip's labels
    (N, H, W)."""
    objects = truth["objects"]
    flow = truth.get("flow")
    unmoved = collapsed = 0
    for t, lab in enumerate(labels):
        if len(np.unique(lab)) < len(np.unique(objects[t])):
            collapsed += 1
        if t == 0 or not np.array_equal(lab, labels[t - 1]):
            continue
        moved = not np.array_equal(objects[t], objects[t - 1])
        if flow is not None:
            moved = moved or bool(np.any(flow[t] != 0))
        unmoved += moved
    return {"frames_unmoved": unmoved, "frames_collapsed": collapsed}


def numbers(files: list, truth: dict, config: dict, traffic: dict) -> dict:
    n = truth["objects"].shape[0]
    out = {"frames_unmoved": 0, "frames_collapsed": 0}
    for clip in files:
        if "pb" not in clip:
            continue
        sets, _ = compare.program_sets(clip["pb"], n, config["width"],
                                       config["height"])
        if sets:
            labels = np.concatenate([lab for lab, _ in sets])
            for k, v in frame_numbers(labels, truth).items():
                out[k] += v
    return out
