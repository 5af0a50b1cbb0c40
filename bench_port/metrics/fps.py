"""Frames a second: every frame of every clip run, over all the time from
the window's start to the end of the last clip's `.pb`."""


def read(rec):
    return rec["frames"] / rec["seconds"]
