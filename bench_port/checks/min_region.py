"""The dense stage's minimum region size, as the `.pb`'s level-0 regions
show it.

The configuration guarantees that the dense stage merges every region of
a chunk solve under frac_min_region_size^2 x width x height x chunk_size
voxels into a neighbour (dense_segmentation.cpp:270-272).  A level-0
region of the `.pb` can still hold fewer voxels: the host tail splits a
region into its spatially connected pieces in each frame, and a region
at the clip's end may be cut short, so about two thirds of the regions
lie under the minimum.  But those pieces are rarely tiny, while a dense
stage that merges nothing leaves a tiny region for every speck of
texture and noise.  The check counts the tiny ones:

- `tiny_regions_per_frame`: the largest, over the compared clips, number
  of level-0 regions holding fewer voxels over the clip than a twentieth
  of the minimum (13 voxels at 272x480), over the clip's frames.

Reads each compared clip's `.pb` (`files["pb"]`) with the check's own
reader."""

from __future__ import annotations

import numpy as np

from bench_port import compare


def min_voxels(config: dict) -> int:
    """The configuration's minimum region size in voxels (an option the
    configuration leaves out takes the upstream default,
    dense_segmentation.h: 0.01 and 20)."""
    d = config.get("dense_options", {})
    f = d.get("frac_min_region_size", 0.01)
    return max(1, int(f * config["width"] * f * config["height"]
                      * d.get("chunk_size", 20)))


def tiny_per_frame(labels: np.ndarray, minimum: int) -> float:
    """Regions of `labels` (N, H, W) holding fewer than minimum // 20
    voxels, over N."""
    _, counts = np.unique(labels, return_counts=True)
    return float((counts < minimum // 20).sum() / len(labels))


def numbers(files: list, truth: dict, config: dict, traffic: dict) -> dict:
    n = truth["objects"].shape[0]
    out = []
    for clip in files:
        if "pb" not in clip:
            continue
        sets, _ = compare.program_sets(clip["pb"], n, config["width"],
                                       config["height"])
        if sets:
            labels = np.concatenate([lab for lab, _ in sets])
            out.append(tiny_per_frame(labels, min_voxels(config)))
    return {"tiny_regions_per_frame": max(out)} if out else {}
