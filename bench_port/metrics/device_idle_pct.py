"""Share of the traced window in which no kernel, copy or set ran on the
card: 100 less the union of the trace's device intervals over the
window, in percent."""


def read(rec):
    if not rec.get("window_s") or not rec.get("events", {}).get("device"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
