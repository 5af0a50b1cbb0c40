"""Milliseconds a frame in the port's `host_tail` stage: the API stream's
`stage_seconds["host_tail"]` summed over the window's untraced clips, over
their frames."""


def read(rec):
    secs = rec.get("stage_seconds", {}).get("host_tail")
    if secs is None or not rec.get("stage_frames"):
        return None
    return 1e3 * secs / rec["stage_frames"]
