"""Shared by the stage readers: milliseconds a frame of one key of the API
stream's `stage_seconds` (a span of `video_segment_tpu_torch.runtime.trace`),
summed over the window's untraced clips, over their frames; None where
the program has no such span."""


def ms_per_frame(rec: dict, key: str):
    secs = rec.get("stage_seconds", {}).get(key)
    if secs is None or not rec.get("stage_frames"):
        return None
    return 1e3 * secs / rec["stage_frames"]
