"""Shared by the kernels' roofline readers: a kernel's launches in the
trace, found by the name of its `__global__` function (the trace may
carry it mangled by the compiler)."""


def launch_seconds(rec: dict, kernel: str) -> list:
    """Device seconds of each launch of `kernel`, in launch order."""
    out = []
    for name, secs in rec.get("launches", {}).items():
        if kernel in name:
            out += secs
    return out
