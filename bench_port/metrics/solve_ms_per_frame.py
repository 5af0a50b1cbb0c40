"""Milliseconds a frame in the port's `chunk_solve` stage: the API stream's
`stage_seconds["chunk_solve"]` summed over the window's untraced clips, over
their frames."""


def read(rec):
    secs = rec.get("stage_seconds", {}).get("chunk_solve")
    if secs is None or not rec.get("stage_frames"):
        return None
    return 1e3 * secs / rec["stage_frames"]
