"""Checkpoint / resume for the streaming stages (PyTorch port).

Port of video_segment_tpu/runtime/checkpoint.py.  The chunk-incremental
design makes resume-at-chunk-boundary natural: the carried state is small
and explicit.  This module serializes it:

- DenseSegmentation: id counters, chunk bookkeeping, the previous-overlap
  global-id label planes, and the (smoothed, band-padded) frame and flow
  buffers.
- RegionSegmentation: buffered chunk records (frames + cached descriptor
  tables), per-level previous-set assignments, window anchors and frame
  Lab means (windowed appearance gains), counters.

Everything is saved as host NumPy / dataclasses in one pickle stream;
device tensors of the dense buffer are downloaded on save and put back on
the stage's `device` on restore through `DenseSegmentation.load_state`,
which also recomputes the per-frame felz pre-segmentations.  A `meta`
block records frame geometry and the number of frames already consumed so
the caller can re-seek its video source.

The pickle layout and the magic string are the JAX package's, so the dense
block of a checkpoint written by either package restores in the other.
The region block pickles this package's own record classes and restores
only here.

Unpickling runs code: restore only checkpoints this program wrote.
"""

from __future__ import annotations

import pickle

import numpy as np


_MAGIC = "vst-checkpoint-v1"


def _dense_state(ds) -> dict:
    ds.join()  # settle any deferred tail (async_tail) before snapshotting
    return {
        "buffer": [b.cpu().numpy() for b in ds._buffer],
        "flow_buffer": [None if f is None else np.asarray(f, np.float32)
                        for f in ds._flow_buffer],
        "has_flow": ds._has_flow,
        "chunk_start": ds._chunk_start,
        "chunk_id": ds._chunk_id,
        "max_region_id": ds._max_region_id,
        "num_output_frames": ds._num_output_frames,
        "overlap_gids": [np.asarray(g) for g in ds._overlap_gids],
    }


def _region_state(rs) -> dict:
    return {
        "features": rs._features,
        "frame_means": rs._frame_means,
        "chunks": rs._chunks,
        "open_frames": rs._open_frames,
        "set_id": rs._set_id,
        "has_flow": rs._has_flow,
        "window_anchor": rs._window_anchor,
        "prev_assign": rs._prev_assign,
    }


def _restore_region(rs, st) -> None:
    rs._features = st["features"]
    rs._frame_means = st["frame_means"]
    rs._chunks = st["chunks"]
    rs._open_frames = st["open_frames"]
    rs._set_id = st["set_id"]
    rs._has_flow = st["has_flow"]
    rs._window_anchor = st["window_anchor"]
    rs._prev_assign = st["prev_assign"]


def save(path: str, dense, region=None, frames_consumed: int = 0,
         extra: dict | None = None) -> None:
    """Write a checkpoint.  `frames_consumed` = frames already fed to the
    pipeline (the caller seeks its source there on resume)."""
    state = {
        "magic": _MAGIC,
        "frames_consumed": frames_consumed,
        "frame_width": dense.frame_width,
        "frame_height": dense.frame_height,
        "dense": _dense_state(dense),
        "region": None if region is None else _region_state(region),
        "extra": extra or {},
    }
    with open(path, "wb") as f:
        pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)


def _load(path: str) -> dict:
    with open(path, "rb") as f:
        state = pickle.load(f)
    if not isinstance(state, dict) or state.get("magic") != _MAGIC:
        raise ValueError(f"{path} is not a video_segment_tpu checkpoint")
    return state


def load_extra(path: str) -> dict:
    """Read only the caller-supplied `extra` block of a checkpoint (e.g.
    output-writer position for append-on-resume)."""
    return _load(path).get("extra", {})


def restore(path: str, dense, region=None) -> int:
    """Restore stage state in place; returns frames_consumed."""
    state = _load(path)
    if (state["frame_width"], state["frame_height"]) != (
            dense.frame_width, dense.frame_height):
        raise ValueError(
            f"checkpoint geometry {state['frame_width']}x"
            f"{state['frame_height']} does not match stage "
            f"{dense.frame_width}x{dense.frame_height}")
    if region is not None and state["region"] is None:
        raise ValueError("checkpoint has no region-stage state")
    dense.load_state(state["dense"])
    if region is not None:
        _restore_region(region, state["region"])
    return state["frames_consumed"]
