"""Seconds from the process's start (the first line of run.py) to the
window's start: imports, making the clip, building the kernels, warming
the cell's shapes."""


def read(rec):
    return rec["setup_s"]
